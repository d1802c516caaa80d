"""The vanilla training slice of nerf_tpu_torch against nerf_tpu: the modules
it adds, one training step (loss, grads, Adam update) on both MLP routes, a
5-step trajectory through the warmup, and the trainer end to end on the CPU.

Tolerances of the steps, f32 throughout:
- loss terms, rtol 1e-4 per step (2e-4 over the trajectory): the fine
  depths come from an inverse CDF of f32 weights summed in another order,
  and a few ulps of the depths reach the weights;
- grads, the relative Frobenius error of each of the 34 weight-tuple
  tensors, 2e-3: the proposal loss divides by the fine weights plus 1e-8,
  so weights near zero pass those ulps on amplified;
- params: Adam scales each grad element to about +-lr, so an element whose
  grad is within its rounding error of zero may step the other way.  After
  one step every element lies within 2 lr of the JAX package's and at most
  0.1% differ by more than 0.1 lr; after five, each tensor's distance from
  the JAX params is at most 3% of how far the JAX params moved and every
  element lies within half the summed learning rates.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_common import (
    configs, jax_variables, port_models, two_camera_batch,
)
from nerf_tpu.core import rays as jrays
from nerf_tpu.core import render as jrender
from nerf_tpu.core import sampling as jsampling
from nerf_tpu.data import sampler as jsampler
from nerf_tpu.ops import prop_weights_from_params, vanilla_weights_from_params
from nerf_tpu.train import losses as jlosses
from nerf_tpu.train import schedule as jschedule
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.step import compute_loss as jax_compute_loss
from nerf_tpu.train.step import make_optimizer as jax_make_optimizer
from nerf_tpu.utils.timer import Timer as JaxTimer
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.cli.entry import main
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only
from nerf_tpu_torch.cli.trainer import train
from nerf_tpu_torch.core import rays, render, sampling
from nerf_tpu_torch.data.sampler import epoch_image_order
from nerf_tpu_torch.train import losses, schedule
from nerf_tpu_torch.train.pipeline import render_rays_train
from nerf_tpu_torch.train.step import (
    compute_loss, make_optimizer, sample_train_rays, train_parameters,
    train_step,
)
from nerf_tpu_torch.utils.metrics import read_scalars
from nerf_tpu_torch.utils.timer import Timer

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FOV = 0.6911112070083618          # lego's camera_angle_x
HW = (20, 20)
N_RAYS = 16
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3
# milder than the eval tests' weights: densities of a few units, so the
# 16 rays are partly transparent (mean opacity 0.77) and every loss term and
# grad is live
WEIGHTS = dict(seed=7, gain=1.0, bias_std=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    """Relative Frobenius error."""
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_weight_bounds_matches_jax():
    """Values and the gradient into the proposal weights."""
    rng = np.random.default_rng(0)
    w = rng.uniform(0.0, 1.0, (12, 8)).astype(np.float32)
    c_z = np.sort(rng.uniform(2.0, 6.0, (12, 8)), -1).astype(np.float32)
    u = np.sort(rng.uniform(size=(12, 17)), -1).astype(np.float32)
    _, below = jsampling.inverse_sample(None, jnp.asarray(w),
                                        jnp.asarray(c_z), 17, sort=True,
                                        u=jnp.asarray(u))
    g = rng.normal(size=(12, 16)).astype(np.float32)
    jb, vjp = jax.vjp(lambda x: jsampling.weight_bounds(x, below),
                      jnp.asarray(w))
    (jg,) = vjp(jnp.asarray(g))
    wt = _t(w).requires_grad_()
    b = sampling.weight_bounds(wt, _t(np.asarray(below)))
    (tg,) = torch.autograd.grad((b * _t(g)).sum(), wt)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("white_bkg", [False, True])
def test_composite_rl_matches_jax(white_bkg):
    rng = np.random.default_rng(1)
    rgb3 = rng.uniform(size=(3, 10, 16)).astype(np.float32)
    dens = rng.normal(0, 3, (10, 16)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (10, 16)), -1).astype(np.float32)
    dirs = rng.normal(size=(10, 3)).astype(np.float32)
    jout, jw = jrender.composite_rl(*map(jnp.asarray, (rgb3, dens, z, dirs)),
                                    white_bkg=white_bkg)
    out, w = render.composite_rl(*map(_t, (rgb3, dens, z, dirs)),
                                 white_bkg=white_bkg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    bounds = rng.uniform(0, 1, (10, 16)).astype(np.float32)
    w = rng.uniform(0, 1, (10, 16)).astype(np.float32)
    a, b = rng.uniform(size=(2, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.proposal_loss(_t(bounds), _t(w))),
        float(jlosses.proposal_loss(jnp.asarray(bounds), jnp.asarray(w))),
        rtol=1e-6)
    m = losses.mse(_t(a), _t(b))
    np.testing.assert_allclose(float(m), float(jlosses.mse(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.mse_to_psnr(m)),
                               float(jlosses.mse_to_psnr(jnp.asarray(
                                   float(m)))), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_step=0),
                                dict(min_ratio=0.3, decay_step=300,
                                     warmup_step=7)])
def test_decay_schedule_matches_jax(kw):
    lr = schedule.scaled_base_lr(1.5e-4, 1024)
    assert lr == jschedule.scaled_base_lr(1.5e-4, 1024)
    ours, theirs = (schedule.decay_schedule(lr, **kw),
                    jschedule.decay_schedule(lr, **kw))
    for step in (0, 1, 3, 6, 7, 250, 499, 500, 501, 10_000, 240_000):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("hw,crop", [((400, 400), (0.5, 0.5)),
                                     ((21, 34), (0.3, 0.99)),
                                     ((16, 16), (1.0, 0.25))])
def test_crop_bounds_matches_jax(hw, crop):
    assert rays.crop_bounds(*hw, crop) == jrays.crop_bounds(*hw, crop)


def test_epoch_image_order_and_timer_match_jax():
    for n, ep, seed in ((7, 0, 0), (100, 3, 5), (1, 9, 2)):
        np.testing.assert_array_equal(epoch_image_order(n, ep, seed),
                                      jsampler.epoch_image_order(n, ep, seed))
    ticks = iter([0.0, 1.5, 2.0, 63.0, 70.0, 4000.0])
    ours = Timer(2, clock=lambda: next(ticks))
    jticks = iter([0.0, 1.5, 2.0, 63.0, 70.0, 4000.0])
    theirs = JaxTimer(2, clock=lambda: next(jticks))
    for t in (ours, theirs):
        for _ in range(3):
            t.tic()
            t.toc()
    assert ours.eta_str(10) == theirs.eta_str(10)
    assert ours.get_mean_time() == theirs.get_mean_time()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """A 3-image pixel pool, poses and focal, from one numpy seed."""
    rng = np.random.default_rng(7)
    pool = rng.uniform(size=(3, HW[0] * HW[1], 3)).astype(np.float32)
    poses = np.stack([jrays.pose_spherical(a, -30.0, 4.0)[:3]
                      for a in (0.0, 120.0, 240.0)]).astype(np.float32)
    return pool, poses, jrays.fov_to_focal(FOV, HW)


def _draws(rng, cfg, n_images=3):
    """One step's picks and noise: image, (row, col), jitter, sorted u."""
    img = int(rng.integers(n_images))
    row = rng.integers(0, HW[0], N_RAYS)
    col = rng.integers(0, HW[1], N_RAYS)
    jit = rng.uniform(size=(N_RAYS, cfg.n_coarse)).astype(np.float32)
    u = np.sort(rng.uniform(size=(N_RAYS, cfg.n_fine + 1)), -1)
    return img, row, col, jit, u.astype(np.float32)


def _jax_batch(scene, img, row, col):
    """The JAX package's rays and ground truth for explicit picks."""
    pool, poses, focal = scene
    h, w = HW
    coords = jnp.stack((jnp.asarray(col - w // 2), jnp.asarray(h // 2 - row)),
                       axis=-1)
    r = jrays.rays_from_coords(coords, jnp.asarray(poses[img]), focal)
    return r, jnp.asarray(pool.reshape(-1, 3)[img * h * w + row * w + col])


def _jax_step_fn(jcfg, sched, grad_clip):
    models = jax_make_models(jcfg)
    tx = jax_make_optimizer(jcfg, sched, grad_clip=grad_clip)

    @jax.jit
    def step(params, opt_state, rays_, gt, jit, u):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jax_compute_loss(models, p, rays_, gt, None, jcfg,
                                       noise=(jit, u)), has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics, grads

    return step, tx


def _kernel_tuples(tree):
    """The 34 weight-tuple tensors (24 vanilla, 10 proposal) of a flax
    params tree, as numpy."""
    return [np.asarray(a) for a in (
        list(vanilla_weights_from_params(tree["nerf"]))
        + list(prop_weights_from_params(tree["prop"])))]


def _port_tree(models, grads: bool = False):
    nerf, prop = models
    sd = {}
    for net, m in (("nerf", nerf), ("prop", prop)):
        sd[net] = bridge.state_dict_to_flax(
            {k: (p.grad if grads else p) for k, p in m.named_parameters()},
            net)
    return sd


def _port_batch(scene, img, row, col):
    pool, poses, focal = scene
    return sample_train_rays(_t(pool), _t(poses), img, HW, focal, N_RAYS,
                             picks=(_t(row), _t(col)))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_one_step_matches_jax(scene, use_pallas):
    """Loss, metrics, the 34 weight-tuple grads and the Adam-updated params
    of one step: the Pallas route (interpret mode) against the port's
    kernel route (plain versions), and flax against the nn.Modules."""
    jcfg, cfg = configs(use_pallas=use_pallas, white_bkg=False)
    variables = jax_variables(jcfg, **WEIGHTS)
    rng = np.random.default_rng(6)
    img, row, col, jit, u = _draws(rng, cfg)
    jsched = jschedule.decay_schedule(5e-3, warmup_step=3)
    step, tx = _jax_step_fn(jcfg, jsched, -1.0)
    params = jax.tree.map(jnp.asarray, variables)
    jr, jgt = _jax_batch(scene, img, row, col)
    new, _, jm, jg = step(params, tx.init(params), jr, jgt, jnp.asarray(jit),
                          jnp.asarray(u))

    models = port_models(cfg, variables)
    r, gt = _port_batch(scene, img, row, col)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    opt = make_optimizer(models)
    ops.reset_launches()
    m = train_step(models, opt, r, gt, cfg,
                   schedule.decay_schedule(5e-3, warmup_step=3)(0),
                   noise=(_t(jit), _t(u)), device="cpu")
    assert not any(ops.LAUNCHES.values())
    for k in ("loss", "img_loss", "prop_loss", "psnr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert float(m["prop_loss"]) > 0.0
    grads = _kernel_tuples(_port_tree(models, grads=True))
    for i, (g, w) in enumerate(zip(grads, _kernel_tuples(jg))):
        assert g.shape == w.shape and _rel(g, w) < GRAD_REL, (i, _rel(g, w))
    lr = float(jsched(0))
    diff = np.concatenate([
        np.abs(p - w).ravel() for p, w in zip(
            _kernel_tuples(_port_tree(models)), _kernel_tuples(new))])
    assert diff.max() < 2 * lr and (diff > 0.1 * lr).mean() < 1e-3


@pytest.mark.parametrize("grad_clip", [-1.0, 0.05])
def test_five_step_trajectory_matches_jax(scene, grad_clip):
    """Five steps through the warmup, fresh picks and noise per step, on the
    kernel routes: the per-step losses and the final params.  A clip at
    0.05 binds on every step (the raw global norm is above 1)."""
    jcfg, cfg = configs(white_bkg=False, use_pallas=True)
    variables = jax_variables(jcfg, **WEIGHTS)
    sched = schedule.decay_schedule(5e-3, warmup_step=3)
    step, tx = _jax_step_fn(jcfg, jschedule.decay_schedule(5e-3,
                                                            warmup_step=3),
                            grad_clip)
    params = jax.tree.map(jnp.asarray, variables)
    opt_state = tx.init(params)
    models = port_models(cfg, variables)
    opt = make_optimizer(models)
    rng = np.random.default_rng(6)
    jl, tl = [], []
    for i in range(5):
        img, row, col, jit, u = _draws(rng, cfg)
        jr, jgt = _jax_batch(scene, img, row, col)
        params, opt_state, jm, jg = step(params, opt_state, jr, jgt,
                                         jnp.asarray(jit), jnp.asarray(u))
        if i == 0:
            gnorm = float(optax.global_norm(jg))
            assert grad_clip < 0 or gnorm > grad_clip
        jl.append(float(jm["loss"]))
        r, gt = _port_batch(scene, img, row, col)
        m = train_step(models, opt, r, gt, cfg, sched(i),
                       grad_clip=grad_clip, noise=(_t(jit), _t(u)),
                       device="cpu")
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=2 * LOSS_RTOL)
    assert jl[-1] < 0.5 * jl[0]                    # the loss moved
    lr_sum = sum(sched(i) for i in range(5))
    for i, (p, w, w0) in enumerate(zip(_kernel_tuples(_port_tree(models)),
                                       _kernel_tuples(params),
                                       _kernel_tuples(variables))):
        assert np.linalg.norm(p - w) <= 0.03 * np.linalg.norm(w - w0), i
        assert np.abs(p - w).max() < 0.5 * lr_sum, i


def test_sample_train_rays_draws_inside_the_crop(scene):
    pool, poses, focal = scene
    window = rays.crop_bounds(*HW, (0.5, 0.5))
    gen = torch.Generator().manual_seed(0)
    r, gt = sample_train_rays(_t(pool), _t(poses), 1, HW, focal, 500,
                              crop_window=window, generator=gen)
    assert r.shape == (500, 6) and gt.shape == (500, 3)
    # every ground-truth pixel is one of image 1's pixels inside the window
    x_lb, x_ub, y_lb, y_ub = window
    img = pool[1].reshape(*HW, 3)[y_lb:y_ub, x_lb:x_ub].reshape(-1, 3)
    hits = (np.abs(gt.numpy()[:, None] - img[None]) < 1e-7).all(-1).any(-1)
    assert hits.all()


def test_unported_training_variants_raise():
    """Mip-NeRF raises, naming its item; the proposal net's residual pair
    (prop_store_residuals=True, or None with store_residuals=True) runs
    (tests/test_torch_prop_res.py holds it against nerf_tpu)."""
    _, cfg = configs()
    models = port_models(cfg, jax_variables(configs()[0], seed=0))
    r = torch.ones(4, 6)
    with pytest.raises(NotImplementedError, match="section A"):
        render_rays_train(models, r, cfg.replace(model="mip"), device="cpu")
    rays, _, jit, u = two_camera_batch(3, 4, cfg.n_coarse, cfg.n_fine)
    for kw in (dict(prop_store_residuals=True),
               dict(prop_store_residuals=None)):
        ops.reset_launches()
        out = render_rays_train(models, _t(rays), cfg.replace(**kw),
                                noise=(_t(jit), _t(u)), device="cpu")
        assert torch.isfinite(out["fine_rgb"]).all(), kw
        assert not any(ops.LAUNCHES.values())


def test_train_step_never_runs_quietly_on_cpu():
    jcfg, cfg = configs()
    models = port_models(cfg, jax_variables(jcfg, seed=0))
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_loss(models, torch.ones(4, 6), torch.ones(4, 3), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_step(models, make_optimizer(models), torch.ones(4, 6),
                   torch.ones(4, 3), cfg, 1e-3)
    assert len(train_parameters(models)) == 32


# ---------------------------------------------------------------------------
# the trainer and the entry
# ---------------------------------------------------------------------------

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


def test_trainer_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """Two epochs at the small width on the 7-view fixture: console lines,
    the metrics log, the eval grid, and model/<name>_{mip,prop}.pt, which
    render-only mode loads."""
    monkeypatch.chdir(tmp_path)
    args = get_parser().parse_args(_train_argv(
        tmp_path, "--epochs", "2", "--output_time", "1", "--eval_time", "1",
        "--center_crop_iter", "3", "--warmup_step", "4"))
    trainer = train(args, device="cpu")
    out = capsys.readouterr().out
    assert out.count("rays/s") == 2 and "Evaluation in epoch:    1" in out
    assert trainer.step == 14 and len(trainer.losses) == 14
    assert np.isfinite(trainer.losses).all()
    assert os.path.getsize(tmp_path / "out" / "result_ep0001.png")
    (log,) = list((tmp_path / "logs").glob("*/*/metrics.jsonl"))
    assert [s for s, _ in read_scalars(str(log), "Train Loss")] == \
        list(range(14))
    np.testing.assert_allclose([v for _, v in read_scalars(str(log),
                                                           "Train Loss")],
                               trainer.losses, rtol=1e-6)
    for net in ("mip", "prop"):
        ckpt = torch.load(tmp_path / "model" / f"model_1_{net}.pt",
                          weights_only=True)
        assert (ckpt["train_cnt"], ckpt["epoch"]) == (14, 2)
    psnr = render_only(get_parser().parse_args(
        _train_argv(tmp_path, "-r", "-e")), device="cpu")
    out = capsys.readouterr().out
    assert "(step 14, epoch 2)" in out and np.isfinite(psnr)


@pytest.mark.parametrize("flag,item", [
    (["-l"], "A8"), (["--ckpt_dir", "ck"], "A8"), (["-b"], "A10"),
    (["--trace", "tr"], "A4"), (["-m"], "A5"), (["--use_ipe"], "A5")])
def test_trainer_rejects_unported_flags(tmp_path, flag, item):
    args = get_parser().parse_args(_train_argv(tmp_path, *flag))
    with pytest.raises(NotImplementedError, match=item):
        train(args, device="cpu")


def test_entry_trains_ref_nerf_on_cpu(tmp_path, monkeypatch):
    """``-t --epochs 1`` trains Ref-NeRF through the entry on the CPU and
    writes a RefNeRF checkpoint; so does the hybrid kernel strategy
    (``--ref_kernels hybrid``, tests/test_torch_recompute.py holds it
    against nerf_tpu)."""
    monkeypatch.chdir(tmp_path)
    argv = _train_argv(tmp_path, "-t", "--epochs", "1", "--output_time", "5")
    assert main(argv, device="cpu") == 0
    sd = torch.load(tmp_path / "model" / "model_1_mip.pt",
                    weights_only=True)["model"]
    assert "spa_block1.0.weight" in sd and "dir_block2.6.weight" in sd
    assert main(argv + ["--ref_kernels", "hybrid", "--name", "hybrid"],
                device="cpu") == 0
    sd = torch.load(tmp_path / "model" / "hybrid_mip.pt",
                    weights_only=True)["model"]
    assert "spa_block1.0.weight" in sd and "dir_block2.6.weight" in sd


def test_entry_trains_on_cpu_only_when_asked(tmp_path, monkeypatch):
    """main() without -r is the trainer: with no card it raises unless the
    caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    monkeypatch.chdir(tmp_path)
    argv = _train_argv(tmp_path, "--epochs", "1", "--output_time", "5")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert main(argv, device="cpu") == 0
    assert os.path.exists(tmp_path / "model" / "model_1_mip.pt")
    with open(tmp_path / "model" / "model_1_prop.pt", "rb") as f:
        assert f.read(2) == b"PK"          # a torch.save zip archive
