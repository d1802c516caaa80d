"""The vanilla eval path of nerf_tpu_torch against nerf_tpu, and the whole
render-only slice end to end on the CPU."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    configs, eval_noise, jax_variables, port_models, rays_for,
)
from nerf_tpu.core import rays as jrays
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.pipeline import render_rays_eval as jax_render_rays_eval
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only
from nerf_tpu_torch.train.pipeline import (
    make_models, render_rays_eval, render_rays_train,
)
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.utils.checkpoint import load_models
from nerf_tpu_torch.utils.png import write_png

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from export_torch_checkpoint import (  # noqa: E402
    prop_to_torch_sd, vanilla_to_torch_sd,
)

# f32 end to end.  The fine depths come from an inverse CDF of f32 weights
# whose sums run in another order in the two packages, and the composite
# sums 16 samples with exp/log in between: a few ulps of the weights reach
# the output as up to ~1e-4 (5.6e-5 measured at this size).
RGB_TOL = dict(rtol=1e-4, atol=2e-4)
FOV = 0.6911112070083618          # lego's camera_angle_x


@pytest.fixture(scope="module")
def variables():
    return jax_variables(configs()[0], seed=0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_render_rays_eval_matches_jax(variables, use_kernels):
    """eval_use_pallas=True: the Pallas kernels (interpret mode) against the
    port's kernel wrappers (plain versions on the CPU); False: flax modules
    against the port's nn.Modules."""
    jcfg, cfg = configs(eval_use_pallas=use_kernels)
    pose = jrays.pose_spherical(30.0, -30.0, 4.0)
    rays = rays_for(8, 8, pose, jrays.fov_to_focal(FOV, (8, 8)))
    jit, u = eval_noise(np.random.default_rng(1), 64, cfg.n_coarse, cfg.n_fine)
    jrgb, jex = jax_render_rays_eval(
        jax_make_models(jcfg), variables, jnp.asarray(rays), None, jcfg,
        render_depth=True, noise=(jnp.asarray(jit), jnp.asarray(u)))
    rgb, ex = render_rays_eval(
        port_models(cfg, variables), torch.from_numpy(rays.copy()), cfg,
        render_depth=True, noise=(torch.from_numpy(jit), torch.from_numpy(u)),
        device="cpu")
    assert float(np.asarray(jex["depth"]).std()) > 0.05  # not a blank scene
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **RGB_TOL)
    np.testing.assert_allclose(ex["depth"].numpy(), np.asarray(jex["depth"]),
                               **RGB_TOL)


def test_render_rays_eval_rejects_unported_paths(variables):
    """Only an unknown model is refused now: Mip-NeRF (-m) and the IPE
    mode (--use_ipe), once refused here, render, held against nerf_tpu's
    XLA route (tests/test_torch_mip.py holds every route)."""
    _, cfg = configs()
    models = port_models(cfg, variables)
    with pytest.raises(ValueError, match="unknown model"):
        render_rays_eval(models, torch.ones(4, 6),
                         cfg.replace(model="nerfacto"), device="cpu")
    pose = jrays.pose_spherical(30.0, -30.0, 4.0)
    focal = jrays.fov_to_focal(FOV, (8, 8))
    rays = rays_for(8, 8, pose, focal)
    radius = 2.0 / np.sqrt(12.0) / float(focal[0])
    for kw in (dict(model="mip"), dict(use_ipe=True)):
        jcfg, pcfg = configs(ipe_radius=radius, **kw)
        v = ({"nerf": variables["nerf"]} if pcfg.model == "mip"
             else variables)
        n_strat = pcfg.n_coarse + (pcfg.model == "mip")
        jit, u = eval_noise(np.random.default_rng(2), 64, n_strat,
                            pcfg.n_fine)
        jrgb, _ = jax_render_rays_eval(
            jax_make_models(jcfg), v, jnp.asarray(rays), None, jcfg,
            noise=(jnp.asarray(jit), jnp.asarray(u)))
        rgb, _ = render_rays_eval(
            port_models(pcfg, v), torch.from_numpy(rays.copy()), pcfg,
            noise=(torch.from_numpy(jit), torch.from_numpy(u)),
            device="cpu")
        assert torch.isfinite(rgb).all(), kw
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **RGB_TOL,
                                   err_msg=str(kw))
    # Ref-NeRF trains through the recompute forms of its backwards too
    # (tests/test_torch_recompute.py holds them against nerf_tpu)
    ref = cfg.replace(model="ref", store_residuals=False)
    out = render_rays_train(make_models(ref, "cpu"), torch.ones(4, 6), ref,
                            device="cpu")
    assert torch.isfinite(out["fine_rgb"]).all()


def _write_scene(root, variables, hw=(10, 12), n_views=2):
    """A tiny Blender-layout test split and exported _mip/_prop.pt files."""
    rng = np.random.default_rng(5)
    scene = os.path.join(root, "data", "tiny")
    os.makedirs(os.path.join(scene, "test"))
    frames = []
    for i in range(n_views):
        pose = jrays.pose_spherical(40.0 * i, -30.0, 4.0)
        frames.append({"file_path": f"./test/r_{i}",
                       "transform_matrix": pose.tolist()})
        img = rng.integers(0, 256, (*hw, 4), dtype=np.uint8)
        write_png(os.path.join(scene, "test", f"r_{i}.png"), img)
    with open(os.path.join(scene, "transforms_test.json"), "w") as f:
        json.dump({"camera_angle_x": FOV, "frames": frames}, f)
    os.makedirs(os.path.join(root, "model"))
    torch.save({"model": vanilla_to_torch_sd(variables["nerf"]),
                "train_cnt": 7, "epoch": 1},
               os.path.join(root, "model", "model_1_mip.pt"))
    torch.save({"model": prop_to_torch_sd(variables["prop"]),
                "train_cnt": 7, "epoch": 1},
               os.path.join(root, "model", "model_1_prop.pt"))
    return scene


def _args(root, *extra):
    _, cfg = configs()
    return get_parser().parse_args([
        "-r", "-e", "-w", "--dataset_root", os.path.join(root, "data"),
        "--dataset_name", "tiny", "--img_scale", "1.0",
        "--nerf_net_width", str(cfg.nerf_width),
        "--prop_net_width", str(cfg.prop_width),
        "--coarse_sample_pnum", str(cfg.n_coarse),
        "--fine_sample_pnum", str(cfg.n_fine), "--eval_chunk", "64",
        "--output_dir", os.path.join(root, "out"), *extra])


def test_render_only_end_to_end_on_cpu(variables, tmp_path, monkeypatch,
                                       capsys):
    _write_scene(str(tmp_path), variables)
    monkeypatch.chdir(tmp_path)
    psnr = render_only(_args(str(tmp_path), "--render_depth"), device="cpu")
    out = capsys.readouterr().out
    assert out.count("Image loss:") == 2 and "PSNR:" in out
    assert "Mean PSNR over 2 test poses" in out and np.isfinite(psnr)
    assert "test images with native" in out
    for i in range(2):
        assert os.path.getsize(tmp_path / "out" / "given" / f"result_{i:03d}.png")


def test_render_image_matches_jax_frame(variables, tmp_path):
    """Weights through the export tool's .pt files and the port's loader;
    the frame, chunked with padding, against the JAX eval on its rays."""
    jcfg, cfg = configs(eval_use_pallas=True)
    _write_scene(str(tmp_path), variables)
    (nerf, prop), step, epoch = load_models(str(tmp_path / "model"),
                                            "model_1", cfg, "cpu")
    assert (step, epoch) == (7, 1)
    h, w = 10, 12
    pose = jrays.pose_spherical(40.0, -30.0, 4.0)
    focal = jrays.fov_to_focal(FOV, (h, w))
    jit, u = eval_noise(np.random.default_rng(2), h * w, cfg.n_coarse,
                        cfg.n_fine)
    out = render_image((nerf, prop), pose, (h, w), focal, cfg,
                       render_depth=True,
                       noise=(torch.from_numpy(jit), torch.from_numpy(u)),
                       chunk=64, device="cpu")
    jrgb, jex = jax_render_rays_eval(
        jax_make_models(jcfg), variables,
        jnp.asarray(rays_for(h, w, pose, focal)), None, jcfg,
        render_depth=True, noise=(jnp.asarray(jit), jnp.asarray(u)))
    assert out["rgb"].shape == (h, w, 3) and out["depth"].shape == (h, w)
    np.testing.assert_allclose(out["rgb"], np.asarray(jrgb).reshape(h, w, 3),
                               **RGB_TOL)
    np.testing.assert_allclose(out["depth"],
                               np.asarray(jex["depth"]).reshape(h, w),
                               **RGB_TOL)
