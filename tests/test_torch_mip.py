"""True Mip-NeRF (-m) and the IPE mode (--use_ipe) of nerf_tpu_torch against
nerf_tpu: the cone math and the integrated positional encoding, one
training step of each (loss terms and grads, against JAX's XLA route and
its Pallas route in interpret mode), an eval chunk with depth, and the
trainer end to end on the CPU.

Tolerances, f32 throughout:
- IPE against JAX: the same f32 operations in the same order, so the cone
  parameters and means agree exactly and the features to one f32 ulp of
  sin/cos (2.4e-7 allowed).  Against a float64 evaluation of the same f32
  depths and rays: level l multiplies the mean by 2^l, so the mean's own
  f32 rounding (about 5e-7 at |mu| ~ 4) becomes a phase error of 2^l times
  that; each level is held within 1e-6 * (2^l + 1) (measured at level 9:
  2.5e-4 against 5.1e-4, the same for both packages).
- a step: ``STEP_LOSS_RTOL`` on the loss terms and ``STEP_VANILLA_GRAD_REL``
  on each weight-tuple grad of tests/torch_port_common.py, as for the
  vanilla step: the same net and the same sources of difference, through
  two passes (the fine edges come from an inverse CDF of the coarse
  weights, summed in another order in the two packages).
- an eval chunk: ``RGB_TOL`` of tests/test_torch_pipeline.py, 1e-4 / 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    STEP_RAYS, assert_step_grads_close, configs, eval_noise, jax_variables,
    port_models, rays_for, step_loss_and_grads, two_camera_batch,
)
from nerf_tpu.core import encoding as jenc
from nerf_tpu.core import rays as jrays
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.pipeline import render_rays_eval as jax_render_rays_eval
from nerf_tpu_torch import ops
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only
from nerf_tpu_torch.cli.trainer import train
from nerf_tpu_torch.core import encoding
from nerf_tpu_torch.train.pipeline import (
    init_variables, make_models, render_rays_eval, render_rays_train,
)
from nerf_tpu_torch.train.step import train_parameters

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FOV = 0.6911112070083618          # lego's camera_angle_x
IPE_JAX_ATOL = 2.4e-7
RGB_TOL = dict(rtol=1e-4, atol=2e-4)
# the pixel-footprint radius 2 / sqrt(12) / focal of a 20x20 image, the
# rays of two_camera_batch
STEP_IPE_RADIUS = 2.0 / np.sqrt(12.0) / float(
    jrays.fov_to_focal(FOV, (20, 20))[0])
LEVELS = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _f64_ipe(z, rays, levels, r):
    """The cone parameters, mean and IPE of jenc's formulas in float64."""
    z = z.astype(np.float64)
    rays = rays.astype(np.float64)
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    diff = (0.5 * (z[:, 1:] - z[:, :-1])) ** 2
    tmp = 3.0 * mid ** 2 + diff
    mu_t = mid + 2.0 * mid * diff / tmp
    s_t = diff / 3.0 - 4.0 * diff ** 2 * (12.0 * mid ** 2 - diff) / 15.0 \
        / tmp ** 2
    s_r = r ** 2 * (0.25 * mid ** 2 + 5.0 / 12.0 * diff
                    - 4.0 * diff ** 2 / (15.0 * tmp))
    o, d = rays[:, :3], rays[:, 3:]
    mu = o[:, None] + mu_t[..., None] * d[:, None]
    dd = d * d
    cov = s_t[..., None] * dd[:, None] + s_r[..., None] * (
        1.0 - dd / dd.sum(-1, keepdims=True))[:, None]
    f = 2.0 ** np.arange(levels)
    mu_r = mu[..., None, :] * f[:, None]
    att = np.exp(-0.5 * cov[..., None, :] * (f ** 2)[:, None])
    feat = np.concatenate([np.sin(mu_r) * att, np.cos(mu_r) * att], -1)
    return (mu_t, s_t, s_r), mu, cov, feat.reshape(*mu.shape[:-1], -1)


@pytest.mark.parametrize("near,far,radius", [
    (2.0, 6.0, 2.0 / np.sqrt(12.0) / 555.5555),   # lego at 800x800
    (0.5, 6.0, 2.0 / np.sqrt(12.0) / 138.9),      # near the camera, 200x200
    (2.0, 6.0, 0.05)])                             # a wide cone
def test_ipe_matches_jax_and_float64(near, far, radius):
    """cone_parameters, cone_mean_diagcov and ipe_feature at camera rays
    (|o| = 4, |d| 1 to 1.1) and sorted jittered depths, 10 levels: against
    nerf_tpu's and against float64 (tolerances in the module docstring)."""
    rays, _, _, _ = two_camera_batch(3, 64, 8, 8)
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(near, far, (64, 33)), -1).astype(np.float32)
    want_cone, want_mu, want_cov, want_feat = _f64_ipe(z, rays, LEVELS,
                                                       radius)

    cone = encoding.cone_parameters(_t(z), radius)
    jcone = jenc.cone_parameters(jnp.asarray(z), radius)
    for got, jgot, want in zip(cone, jcone, want_cone):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)
    mu, cov = encoding.cone_mean_diagcov(_t(rays), *cone)
    jmu, jcov = jenc.cone_mean_diagcov(jnp.asarray(rays), *jcone)
    np.testing.assert_array_equal(mu.numpy(), np.asarray(jmu))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jcov))
    np.testing.assert_allclose(mu.numpy(), want_mu, rtol=0, atol=2e-6)
    np.testing.assert_allclose(cov.numpy(), want_cov, rtol=1e-5, atol=1e-12)
    assert (cov.numpy() >= 0.0).all()

    feat, mu2, mu_t = encoding.ipe_feature(_t(z), _t(rays), LEVELS, radius)
    jfeat, _, jmu_t = jenc.ipe_feature(jnp.asarray(z), jnp.asarray(rays),
                                       LEVELS, radius)
    assert feat.shape == (64, 32, 6 * LEVELS) and feat.dtype == torch.float32
    np.testing.assert_array_equal(mu2.numpy(), mu.numpy())
    np.testing.assert_array_equal(mu_t.numpy(), np.asarray(jmu_t))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=0,
                               atol=IPE_JAX_ATOL)
    err = np.abs(feat.numpy() - want_feat).reshape(64, 32, LEVELS, 6)
    for lvl in range(LEVELS):
        assert err[..., lvl, :].max() <= 1e-6 * (2 ** lvl + 1), \
            (lvl, err[..., lvl, :].max())


def test_mip_models_have_no_proposal_net():
    _, cfg = configs(model="mip")
    nerf, prop = make_models(cfg, "cpu")
    assert prop is None and set(init_variables(cfg)) == {"nerf"}
    assert len(train_parameters((nerf, prop))) == 22


@pytest.mark.parametrize("use_pallas,jax_route", [
    (True, "pallas"), (True, "xla"), (False, "xla")])
def test_mip_step_matches_jax(use_pallas, jax_route):
    """compute_loss of one -m step (loss, img_loss, coarse_loss) and the 24
    weight-tuple grads, summed over the two passes of the one net: the
    port's kernel route (plain versions, no launch) against nerf_tpu's
    Pallas route (interpret mode) and its XLA route, and the nn.Module
    route against the XLA route."""
    got, want = step_loss_and_grads(
        "mip", jax_kw=dict(use_pallas=jax_route == "pallas"),
        use_pallas=use_pallas, ipe_radius=STEP_IPE_RADIUS)
    assert_step_grads_close("mip", got, want)


@pytest.mark.parametrize("use_pallas,jax_route", [
    (True, "pallas"), (True, "xla"), (False, "xla")])
def test_ipe_step_matches_jax(use_pallas, jax_route):
    """One --use_ipe step of the vanilla model (proposal net, IPE fine
    net): loss terms and the 34 weight-tuple grads, the routes as for
    -m."""
    got, want = step_loss_and_grads(
        "vanilla", jax_kw=dict(use_pallas=jax_route == "pallas"),
        use_pallas=use_pallas, use_ipe=True, ipe_radius=STEP_IPE_RADIUS)
    assert_step_grads_close("vanilla", got, want)


def test_mip_step_gradients_reach_both_passes():
    """The step's grads are the sum of the coarse and the fine pass's: with
    mip_coarse_loss_w = 0 they differ from the full step's, and the
    coarse pass's share scales with the weight."""
    grads = {}
    for w in (0.0, 0.1, 0.2):
        got, _ = step_loss_and_grads("mip", use_pallas=True,
                                     ipe_radius=STEP_IPE_RADIUS,
                                     mip_coarse_loss_w=w)
        grads[w] = np.asarray(got["nerf"]["block1"]["Dense_0"]["kernel"])
    assert np.abs(grads[0.1] - grads[0.0]).max() > 1e-6
    np.testing.assert_allclose(grads[0.2] - grads[0.0],
                               2.0 * (grads[0.1] - grads[0.0]),
                               rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module")
def eval_rays():
    pose = jrays.pose_spherical(30.0, -30.0, 4.0)
    hw = (8, 8)
    focal = jrays.fov_to_focal(FOV, hw)
    return rays_for(*hw, pose, focal), 2.0 / np.sqrt(12.0) / float(focal[0])


@pytest.mark.parametrize("model", ["mip", "ipe"])
@pytest.mark.parametrize("use_kernels,jax_route", [
    (True, "pallas"), (True, "xla"), (False, "xla")])
def test_eval_chunk_matches_jax(eval_rays, model, use_kernels, jax_route):
    """A 64-ray eval chunk of -m and of --use_ipe with the depth extra: the
    port's kernel route against nerf_tpu's Pallas route (interpret mode)
    and its XLA route, the nn.Module route against the XLA route."""
    rays, radius = eval_rays
    kw = (dict(model="mip") if model == "mip" else dict(use_ipe=True))
    jcfg, cfg = configs(eval_use_pallas=use_kernels, ipe_radius=radius,
                        **kw)
    jcfg = jcfg.replace(eval_use_pallas=jax_route == "pallas")
    variables = jax_variables(jcfg, seed=0)
    n_strat = cfg.n_coarse + (model == "mip")
    jit, u = eval_noise(np.random.default_rng(1), 64, n_strat, cfg.n_fine)
    jrgb, jex = jax_render_rays_eval(
        jax_make_models(jcfg), variables, jnp.asarray(rays), None, jcfg,
        render_depth=True, noise=(jnp.asarray(jit), jnp.asarray(u)))
    ops.reset_launches()
    rgb, ex = render_rays_eval(
        port_models(cfg, variables), _t(rays), cfg, render_depth=True,
        noise=(_t(jit), _t(u)), device="cpu")
    assert not any(ops.LAUNCHES.values())
    assert float(np.asarray(jex["depth"]).std()) > 0.05  # not a blank scene
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **RGB_TOL)
    np.testing.assert_allclose(ex["depth"].numpy(), np.asarray(jex["depth"]),
                               **RGB_TOL)


def test_mip_train_forward_detaches_the_fine_edges():
    """The fine edges come from the detached coarse weights: no gradient
    reaches the parameters through the resampling, so the kernel route's
    zero input cotangents are exact.  The nn.Module route's grads, where
    autograd would follow any path left open, equal the kernel route's."""
    _, cfg = configs(model="mip", ipe_radius=STEP_IPE_RADIUS,
                     white_bkg=False)
    variables = jax_variables(configs(model="mip")[0], seed=3, gain=1.0,
                              bias_std=0.1)
    rays, gt, jit, u = two_camera_batch(2, STEP_RAYS, cfg.n_coarse + 1,
                                        cfg.n_fine)
    grads = []
    for use_pallas in (True, False):
        models = port_models(cfg.replace(use_pallas=use_pallas), variables)
        out = render_rays_train(models, _t(rays), cfg.replace(
            use_pallas=use_pallas), noise=(_t(jit), _t(u)), device="cpu")
        assert set(out) == {"fine_rgb", "coarse_rgb", "weights", "z_fine"}
        assert out["weights"].shape == (STEP_RAYS, cfg.n_fine)
        assert not out["z_fine"].requires_grad
        loss = ((out["fine_rgb"] - _t(gt)) ** 2).mean() \
            + 0.1 * ((out["coarse_rgb"] - _t(gt)) ** 2).mean()
        loss.backward()
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in models[0].parameters()]))
    rel = float(torch.linalg.vector_norm(grads[0] - grads[1])
                / torch.linalg.vector_norm(grads[1]))
    assert rel < 1e-4, rel


def _train_argv(tmp_path, *extra):
    _, cfg = configs()
    return ["--dataset_root", FIXTURES, "--dataset_name", "lego_mini",
            "--img_scale", "1.0", "-w", "--sample_ray_num", "32",
            "--nerf_net_width", str(cfg.nerf_width),
            "--prop_net_width", str(cfg.prop_width),
            "--coarse_sample_pnum", str(cfg.n_coarse),
            "--fine_sample_pnum", str(cfg.n_fine), "--eval_chunk", "64",
            "--output_dir", str(tmp_path / "out"),
            "--log_dir", str(tmp_path / "logs"), "--no_tensorboard", *extra]


def test_trainer_mip_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """-m trains two epochs on the 7-view fixture with the coarse loss in
    the metrics log, writes model/model_1_mip.pt alone, and -m -r -e
    renders it."""
    from nerf_tpu_torch.utils.metrics import read_scalars

    monkeypatch.chdir(tmp_path)
    args = get_parser().parse_args(_train_argv(
        tmp_path, "-m", "--epochs", "2", "--output_time", "1",
        "--eval_time", "1"))
    trainer = train(args, device="cpu")
    out = capsys.readouterr().out
    assert "model=mip ipe=True" in out and "model_1_mip.pt" in out
    assert trainer.models[1] is None and trainer.cfg.ipe_radius > 0.0
    assert trainer.step == 14 and np.isfinite(trainer.losses).all()
    assert sorted(os.listdir(tmp_path / "model")) == ["model_1_mip.pt"]
    (log,) = list((tmp_path / "logs").glob("*/*/metrics.jsonl"))
    coarse = [v for _, v in read_scalars(str(log), "Coarse Loss")]
    assert len(coarse) == 14 and np.isfinite(coarse).all()
    ckpt = torch.load(tmp_path / "model" / "model_1_mip.pt",
                      weights_only=True)
    assert (ckpt["train_cnt"], ckpt["epoch"]) == (14, 2)
    psnr = render_only(get_parser().parse_args(
        _train_argv(tmp_path, "-m", "-r", "-e")), device="cpu")
    out = capsys.readouterr().out
    assert "model_1_mip.pt (step 14, epoch 2)" in out and np.isfinite(psnr)
    # without -m the same directory has no proposal net to load
    with pytest.raises(FileNotFoundError, match="model_1_prop.pt"):
        render_only(get_parser().parse_args(
            _train_argv(tmp_path, "-r", "-e")), device="cpu")
