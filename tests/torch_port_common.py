"""Shared set-up of the nerf_tpu_torch parity tests: one numpy seed builds
the weights and the noise that both packages get.

Imported by the tests/test_torch_*.py files (not collected itself).
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)   # Tier 1 runs several pytest workers at once

from nerf_tpu.train.config import PipelineConfig as JaxConfig  # noqa: E402
from nerf_tpu_torch.train.config import PipelineConfig  # noqa: E402

SMALL = dict(n_coarse=8, n_fine=16, nerf_width=32, prop_width=32,
             white_bkg=True)


def configs(**kw):
    """(JAX config, port config) at the small test size, ``kw`` overriding
    it; the JAX kernels use a 32-point tile unless ``kw`` sets
    ``pallas_tile``, so interpret mode stays quick."""
    kw = {**SMALL, **kw}
    return JaxConfig(**{"pallas_tile": 32, **kw}), PipelineConfig(**kw)


def random_params(template, rng: np.random.Generator, gain: float = 1.5,
                  bias_std: float = 0.5):
    """Numpy weights with the tree of flax ``template``: kernels
    N(0, gain^2 / fan_in), biases N(0, bias_std^2), so that activations and
    densities are far from zero."""
    out = {}
    for k, v in template.items():
        if isinstance(v, dict) or hasattr(v, "keys"):
            out[k] = random_params(v, rng, gain, bias_std)
        elif k == "kernel":
            fan_in = v.shape[0]
            out[k] = rng.normal(0.0, gain / np.sqrt(fan_in),
                                v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, bias_std, v.shape).astype(np.float32)
    return out


def jax_variables(jax_cfg, seed: int = 0, **kw):
    """{"nerf": params, "prop": params} as numpy trees for ``jax_cfg``;
    ``kw`` goes to ``random_params``."""
    import jax

    from nerf_tpu.train.pipeline import init_variables

    template = init_variables(jax_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {k: random_params(v, rng, **kw) for k, v in template.items()}


def port_models(cfg, variables, device="cpu"):
    """The port's (nerf, prop) for ``cfg`` with ``variables`` bridged in."""
    from nerf_tpu_torch.bridge import load_flax_variables
    from nerf_tpu_torch.train.pipeline import make_models

    models = make_models(cfg, device)
    load_flax_variables(models, variables)
    return models


def eval_noise(rng: np.random.Generator, n_rays: int, n_coarse: int,
               n_fine: int):
    """(jitter (R, n_coarse), sorted uniforms (R, n_fine + 1)) f32."""
    jitter = rng.uniform(size=(n_rays, n_coarse)).astype(np.float32)
    u = np.sort(rng.uniform(size=(n_rays, n_fine + 1)), axis=-1)
    return jitter, u.astype(np.float32)


def two_camera_batch(seed: int, n_rays: int, n_coarse: int, n_fine: int):
    """Rays from two cameras at radius 4 on opposite sides of the origin
    (lego's field of view, a 20x20 image), ground truth and a step's noise
    (jitter, sorted uniforms), as numpy, from one numpy seed."""
    import jax.numpy as jnp

    from nerf_tpu.core import rays as jrays

    rng = np.random.default_rng(seed)
    focal = jrays.fov_to_focal(0.6911112070083618, (20, 20))
    rays = []
    for az in rng.uniform(0, 360) + np.array([0.0, 180.0]):
        pose = jrays.pose_spherical(float(az), -30.0, 4.0)
        row, col = rng.integers(0, 20, (2, n_rays // 2))
        coords = jnp.stack((jnp.asarray(col - 10), jnp.asarray(10 - row)),
                           -1)
        rays.append(np.asarray(jrays.rays_from_coords(
            coords, jnp.asarray(pose[:3]), focal)))
    rays = np.concatenate(rays)
    gt = rng.uniform(size=(n_rays, 3)).astype(np.float32)
    jit = rng.uniform(size=(n_rays, n_coarse)).astype(np.float32)
    u = np.sort(rng.uniform(size=(n_rays, n_fine + 1)), -1)
    return rays, gt, jit, u.astype(np.float32)


def rays_for(h: int, w: int, pose, focal):
    """Full-image rays of the JAX package, as numpy."""
    import jax.numpy as jnp

    from nerf_tpu.core import rays as jrays

    return np.asarray(jrays.full_image_rays(
        h, w, jnp.asarray(np.asarray(pose, np.float32)[:3]), focal))
