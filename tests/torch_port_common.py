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


# compute_loss of both packages on one seeded batch (``step_loss_and_grads``):
# the kernels' 64-row tiles, 8 rays, weights N(0, 1/fan_in) and biases
# N(0, 0.1^2).  Tolerances, f32: loss terms rtol 1e-4; grads, vanilla by the
# relative Frobenius error of each weight-tuple tensor (2e-3: the proposal
# loss divides by the fine weights plus 1e-8, tests/test_torch_train.py),
# Ref-NeRF rtol 5e-3 / atol 3e-4 on the flat vector
# (tests/test_torch_ref_train.py).
STEP_TILE, STEP_RAYS = 64, 8
STEP_LOSS_RTOL = 1e-4
STEP_VANILLA_GRAD_REL = 2e-3
STEP_REF_GRAD_TOL = dict(rtol=5e-3, atol=3e-4)


def step_configs(model: str, **kw):
    """(JAX config, port config) of the step tests: the kernel route at the
    small size, Ref-NeRF without bottleneck noise."""
    base = dict(model=model, pallas_tile=STEP_TILE, white_bkg=False,
                use_pallas=True)
    if model == "ref":
        base["bottleneck_noise"] = 0.0
    return configs(**{**base, **kw})


_STEP_VARIABLES = {}


def step_variables(model: str):
    if model not in _STEP_VARIABLES:
        _STEP_VARIABLES[model] = jax_variables(
            step_configs(model)[0], seed=0, gain=1.0, bias_std=0.1)
    return _STEP_VARIABLES[model]


def step_loss_and_grads(model: str, **kw):
    """compute_loss of nerf_tpu (Pallas in interpret mode) and of the port
    (plain versions, no launch) on one seeded batch with the config
    overrides ``kw``: the loss and its terms are held within
    STEP_LOSS_RTOL (each term live, above 0), and (port grads, JAX grads)
    are returned as flax trees."""
    import jax
    import jax.numpy as jnp

    from nerf_tpu.train.pipeline import make_models as jax_make_models
    from nerf_tpu.train.step import compute_loss as jax_compute_loss
    from nerf_tpu_torch import bridge, ops
    from nerf_tpu_torch.train.step import compute_loss

    jcfg, cfg = step_configs(model, **kw)
    v = step_variables(model)
    rays, gt, jit, u = two_camera_batch(1, STEP_RAYS, cfg.n_coarse,
                                        cfg.n_fine)
    (jloss, jm), jg = jax.value_and_grad(
        lambda prm: jax_compute_loss(jax_make_models(jcfg), prm,
                                     jnp.asarray(rays), jnp.asarray(gt),
                                     None, jcfg, noise=(jnp.asarray(jit),
                                                        jnp.asarray(u))),
        has_aux=True)(jax.tree.map(jnp.asarray, v))
    models = port_models(cfg, v)
    ops.reset_launches()
    t = torch.from_numpy
    loss, m = compute_loss(models, t(rays), t(gt), cfg, noise=(t(jit), t(u)),
                           device="cpu")
    loss.backward()
    assert not any(ops.LAUNCHES.values())
    keys = ("loss", "img_loss", "prop_loss") + (
        ("normal_loss", "bf_loss") if model == "ref" else ())
    for k in keys:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=STEP_LOSS_RTOL, atol=1e-7, err_msg=k)
        assert float(m[k].detach()) > 0.0, k
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=STEP_LOSS_RTOL)
    nerf, prop = models
    got = {"nerf": bridge.state_dict_to_flax(
               {k: p.grad for k, p in nerf.named_parameters()},
               "ref" if model == "ref" else "nerf"),
           "prop": bridge.state_dict_to_flax(
               {k: p.grad for k, p in prop.named_parameters()}, "prop")}
    return got, jax.tree.map(np.asarray, jg)


def assert_step_grads_close(model: str, got, want):
    """Hold the port's step grads against the JAX package's (tolerances
    above)."""
    import jax

    from nerf_tpu.ops import (
        prop_weights_from_params, vanilla_weights_from_params,
    )

    if model == "vanilla":
        for net, fn in (("nerf", vanilla_weights_from_params),
                        ("prop", prop_weights_from_params)):
            for i, (a, b) in enumerate(zip(fn(got[net]), fn(want[net]))):
                a, b = np.asarray(a), np.asarray(b)
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                assert a.shape == b.shape and rel < STEP_VANILLA_GRAD_REL, \
                    (net, i, rel)
        return
    flat_got, _ = jax.flatten_util.ravel_pytree(got)
    flat_want, _ = jax.flatten_util.ravel_pytree(want)
    np.testing.assert_allclose(np.asarray(flat_got), np.asarray(flat_want),
                               **STEP_REF_GRAD_TOL)
