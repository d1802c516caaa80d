"""The port's procedural scenes (``nerf_tpu_torch.data.synthetic``) against
nerf_tpu's, and ``python -m nerf_tpu_torch.tools.batch_scaling`` on the CPU
at a small size.

Tolerance of the scenes: 1e-5 per pixel value (f32 quadrature of the same
field, sums taken in another order)."""

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu.data import synthetic as jsynthetic
from nerf_tpu_torch import ops
from nerf_tpu_torch.data import synthetic
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.tools import batch_scaling, bench_ref_kernels

SCENE_ATOL = 1e-5


@pytest.mark.parametrize("family, specular", [("blobs", 0.0),
                                              ("blobs", 0.5),
                                              ("objects", 0.0)])
def test_synthetic_scene_matches_jax(family, specular):
    """make_synthetic_scene at hw (16, 16) with 16 samples a ray: the same
    poses and, within SCENE_ATOL, the same images as the JAX package's for
    the same seed, in both splits."""
    kw = dict(n_train=2, n_test=1, hw=(16, 16), seed=3, n_samples=16,
              specular=specular, family=family)
    jtrain, jtest, (jtr, jte) = jsynthetic.make_synthetic_scene(**kw)
    train, test, (tr, te) = synthetic.make_synthetic_scene(**kw,
                                                           device="cpu")
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(te, jte)
    for ours, theirs in ((train, jtrain), (test, jtest)):
        assert ours.images.shape == theirs.images.shape
        assert float(theirs.images.std()) > 0.1
        np.testing.assert_allclose(ours.images, theirs.images, rtol=0,
                                   atol=SCENE_ATOL)
        np.testing.assert_array_equal(ours.poses, theirs.poses)


def test_synthetic_scene_writes_the_blender_layout(tmp_path):
    """write_blender_dataset writes what BlenderDataset.load reads back:
    the images to 8 bits, the poses and the field of view."""
    train, _, (poses, _) = synthetic.make_synthetic_scene(
        n_train=2, n_test=1, hw=(12, 10), seed=1, n_samples=8, device="cpu")
    synthetic.write_blender_dataset(str(tmp_path), train, poses, "train")
    back = BlenderDataset.load(str(tmp_path), "train")
    np.testing.assert_allclose(back.images, train.images, atol=0.5 / 255)
    np.testing.assert_allclose(back.poses, train.poses, atol=1e-6)
    assert back.fov == pytest.approx(synthetic.DEFAULT_FOV)
    with pytest.raises(ValueError, match="diffuse-only"):
        synthetic.make_synthetic_scene(family="objects", specular=0.5,
                                       device="cpu")


@pytest.fixture(scope="module")
def small_scene():
    return synthetic.make_synthetic_scene(n_train=2, n_test=1, hw=(16, 16),
                                          seed=0, n_samples=16,
                                          device="cpu")[0]


@pytest.mark.parametrize("axis", list(batch_scaling.AXES))
def test_batch_scaling_measures_each_axis_on_cpu(small_scene, axis):
    """measure(..., n_scan=2) of both variants of each offered axis at
    narrow widths, on the CPU: rays/s, no device peak, no launch."""
    for variant, kw in batch_scaling.AXES[axis].items():
        cfg = batch_scaling.config("vanilla", 8, **kw).replace(
            n_coarse=8, n_fine=16, nerf_width=32, prop_width=32)
        ops.reset_launches()
        out = batch_scaling.measure(cfg, n_scan=2, device="cpu",
                                    train_set=small_scene)
        assert out["rays_per_s"] > 0 and out["peak_bytes"] is None, variant
        assert not any(ops.LAUNCHES.values())
    assert batch_scaling.config("ref", 4096).ray_batch == 4096


def test_batch_scaling_ref_prop_res_on_cpu(small_scene):
    """The Ref-NeRF row of the prop_res axis runs on the CPU too."""
    kw = batch_scaling.AXES["prop_res"]["resid"]
    cfg = batch_scaling.config("ref", 4, **kw).replace(
        n_coarse=8, n_fine=16, nerf_width=32, prop_width=32)
    out = batch_scaling.measure(cfg, n_scan=2, device="cpu",
                                train_set=small_scene)
    assert out["rays_per_s"] > 0


@pytest.mark.parametrize("argv, match", [
    (["--axis", "select"], "no counterpart"),
    (["--axis", "tile"], "no counterpart"),
    (["--axis", "pe"], "no counterpart"),
    (["--axis", "bufs"], "no counterpart"),
    (["--model", "mip"], "A5")])
def test_batch_scaling_refuses_what_is_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        batch_scaling.main(argv, device="cpu")


def test_tools_run_on_the_card_only_when_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_scaling.main(["--batches", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_ref_kernels.main(["--dissect"])


@pytest.mark.parametrize("flag", ["--tiles", "--spa_bwd_tile",
                                  "--ab_bwd_cd", "--ab_store"])
def test_bench_ref_kernels_refuses_the_tpu_only_ab_flags(flag):
    with pytest.raises(NotImplementedError, match="no counterpart"):
        bench_ref_kernels.main(["--dissect", flag], device="cpu")


def test_bench_ref_kernels_case_on_cpu():
    """The tool's seeded operands at a small N: the shapes its timed calls
    take, and each stage and mode running (plain versions) on them."""
    case = bench_ref_kernels.make_case(64, torch.float32, device="cpu")
    assert case["heads"].shape == (64, 139) and case["dirs"].shape == (64, 3)
    assert case["rows"].shape == (2 * 19 + 1, 64)
    norms = torch.linalg.vector_norm(case["dirs"], dim=-1)
    assert float(norms.min()) >= 1.0 and float(norms.max()) <= 1.12 + 1e-6
    rgb, _, _ = bench_ref_kernels.dissect_fwd_call(case, "trunk")()
    assert rgb.shape == (64, 3)
    dheads, grads = bench_ref_kernels.dissect_bwd_call(case, "wgrads")()
    assert float(dheads.abs().max()) == 0.0 and len(grads) == 19
