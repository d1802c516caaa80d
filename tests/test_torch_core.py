"""nerf_tpu_torch.core against nerf_tpu.core: same numpy inputs, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu.core import encoding as jenc
from nerf_tpu.core import fastmath as jfast
from nerf_tpu.core import rays as jrays
from nerf_tpu.core import render as jrender
from nerf_tpu.core import sampling as jsamp
from nerf_tpu_torch.core import encoding, rays, render, sampling

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fov,hw,legacy", [
    (0.69, (8, 8), False), (0.69, (8, 8), True), (0.69, (10, 12), True),
    ((0.7, 0.5), (10, 12), False)])
def test_fov_to_focal(fov, hw, legacy):
    assert rays.fov_to_focal(fov, hw, legacy) == pytest.approx(
        jrays.fov_to_focal(fov, hw, legacy), rel=1e-12)


@pytest.mark.parametrize("hw", [(8, 8), (10, 12), (7, 5)])
def test_full_image_rays(hw):
    h, w = hw
    pose = jrays.pose_spherical(30.0, -30.0, 4.0)
    focal = jrays.fov_to_focal(0.69, hw)
    close(rays.pixel_coord_grid(h, w), jrays.pixel_coord_grid(h, w), 0, 0)
    ref = jrays.full_image_rays(h, w, jnp.asarray(pose[:3]), focal)
    port = rays.full_image_rays(h, w, torch.from_numpy(pose[:3].copy()), focal)
    close(port, ref)


def test_orbit_poses():
    close(rays.orbit_poses(12, -30.0, 4.0), jrays.orbit_poses(12, -30.0, 4.0),
          0, 0)
    close(rays.pose_spherical(75.0, -10.0, 2.5),
          jrays.pose_spherical(75.0, -10.0, 2.5), 0, 0)


@pytest.mark.parametrize("levels", [4, 10])
def test_positional_encoding(levels):
    x = np.random.default_rng(0).uniform(-6, 6, (33, 3)).astype(np.float32)
    close(encoding.positional_encoding(torch.from_numpy(x), levels),
          jenc.positional_encoding(jnp.asarray(x), levels), atol=2e-6)


def test_sampling_chain():
    """stratified -> sample_pdf / inverse_sample(sort) -> max_blur."""
    rng = np.random.default_rng(1)
    r, p, n = 12, 16, 33
    jit = rng.uniform(size=(r, p)).astype(np.float32)
    w = rng.uniform(size=(r, p)).astype(np.float32) ** 4
    u = np.sort(rng.uniform(size=(r, n)), -1).astype(np.float32)
    c_z = sampling.stratified_samples(r, p, 2.0, 6.0,
                                      jitter=torch.from_numpy(jit))
    j_cz = jsamp.stratified_samples(None, r, p, 2.0, 6.0,
                                    jitter=jnp.asarray(jit))
    close(c_z, j_cz)
    close(sampling.max_blur_filter(torch.from_numpy(w), 0.01),
          jsamp.max_blur_filter(jnp.asarray(w), 0.01))
    z, below = sampling.inverse_sample(torch.from_numpy(w), c_z, n,
                                       u=torch.from_numpy(u))
    jz, jbelow = jsamp.inverse_sample(None, jnp.asarray(w), j_cz, n,
                                      sort=True, u=jnp.asarray(u))
    close(z, jz)
    np.testing.assert_array_equal(below.numpy(), np.asarray(jbelow))
    s, lo, hi = sampling.sample_pdf(c_z, torch.from_numpy(w[:, 1:]), n,
                                    u=torch.from_numpy(u))
    js, jlo, jhi = jsamp.sample_pdf(None, j_cz, jnp.asarray(w[:, 1:]), n,
                                    u=jnp.asarray(u))
    close(s, js)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_sorted_uniforms_law():
    g = torch.Generator().manual_seed(0)
    u = sampling.sorted_uniforms((4000, 9), g)
    assert torch.all(u[:, 1:] >= u[:, :-1]) and 0 < u.min() and u.max() < 1
    # the k-th of n sorted uniforms has mean k / (n + 1)
    close(u.mean(0), np.arange(1, 10) / 10.0, rtol=0, atol=0.01)
    ref = np.asarray(jfast.sorted_uniforms(__import__("jax").random.PRNGKey(0),
                                           (4000, 9)))
    close(u.mean(0), ref.mean(0), rtol=0, atol=0.015)


@pytest.mark.parametrize("white_bkg,depth", [(False, False), (True, True)])
def test_composite(white_bkg, depth):
    rng = np.random.default_rng(2)
    r, p = 10, 24
    rgb = rng.uniform(size=(r, p, 3)).astype(np.float32)
    sigma = rng.normal(0, 3, (r, p)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (r, p)), -1).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    bounds = (2.0, 6.0) if depth else None
    out, w, ex = render.composite(
        torch.from_numpy(rgb), torch.from_numpy(sigma), torch.from_numpy(z),
        torch.from_numpy(d), white_bkg=white_bkg, depth_bounds=bounds)
    jout, jw, jex = jrender.composite(
        jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(d),
        white_bkg=white_bkg, depth_bounds=bounds)
    close(out, jout)
    close(w, jw)
    assert set(ex) == set(jex)
    for k in ex:
        close(ex[k], jex[k])
    pts = render.lengths_to_points(torch.from_numpy(np.concatenate(
        [d, d], -1)), torch.from_numpy(z))
    close(pts, jrender.lengths_to_points(jnp.asarray(np.concatenate(
        [d, d], -1)), jnp.asarray(z)))


def test_transmittance_ray_dir_scaling():
    rng = np.random.default_rng(3)
    sigma = rng.normal(0, 2, (6, 16)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (6, 16)), -1).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    close(render.transmittance_weights(torch.from_numpy(sigma),
                                       torch.from_numpy(z),
                                       ray_dirs=torch.from_numpy(d)),
          jrender.transmittance_weights(jnp.asarray(sigma), jnp.asarray(z),
                                        ray_dirs=jnp.asarray(d)))
