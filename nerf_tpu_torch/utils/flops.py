"""Analytic FLOP count of the training step, for the trainer's MFU (port of
nerf_tpu/utils/flops.py).

Counts matmul FLOPs only, 2 x in x out over every 2-D weight of the nets:
the MLPs are more than 95% of the model's FLOPs; the encodings, the IDE and
the composite are left out, so the MFU is slightly conservative.  A torch
``(out, in)`` weight gives the same product as a flax ``(in, out)`` kernel,
so the count equals the JAX package's on the same shapes.  It reads the
shapes of the weights only, never their values or the device.

Passes per training step, per point of the relevant sample axis:
  * the proposal net and the vanilla fine net: forward + backward = 3x
    forward (the backward's delta and weight-grad products are each about
    one forward);
  * Ref-NeRF's spatial group: forward, the density gradient's backward (one
    more) and the loss's backward (two) = 4x, over ``n_merged`` points;
  * Ref-NeRF's directional group: 3x, over ``n_merged`` points;
  * true Mip-NeRF (``-m``): one net, 3x over ``n_coarse + n_fine`` points.

Peak: the H100 SXM's dense bf16 tensor-core rate from its data sheet,
989 TFLOP/s, not a measurement.  ``peak_flops`` overrides it.
"""

from __future__ import annotations

H100_BF16_PEAK = 989e12

SPATIAL = ("spa_block1", "spa_block2", "rho_tau_head", "norm_col_tint_head",
           "bottle_neck")
DIRECTIONAL = ("dir_block1", "dir_block2", "spec_rgb_head")


def _mac_per_point(module) -> int:
    """Sum of in x out over every 2-D weight of ``module`` (one
    multiply-add each per point); biases are 1-D."""
    return sum(int(p.shape[0]) * int(p.shape[1])
               for p in module.parameters() if p.dim() == 2)


def train_step_flops(cfg, models) -> float:
    """Model matmul FLOPs of ONE training step at ``cfg``'s sample counts;
    ``models`` is (fine net, proposal net or None)."""
    r = cfg.ray_batch
    nerf, prop = models
    if cfg.model == "ref":
        spa = sum(_mac_per_point(getattr(nerf, k)) for k in SPATIAL)
        dr = sum(_mac_per_point(getattr(nerf, k)) for k in DIRECTIONAL)
        fine = 2.0 * r * cfg.n_merged * (4 * spa + 3 * dr)
    elif cfg.model == "mip":
        fine = 2.0 * r * (cfg.n_coarse + cfg.n_fine) * 3 * _mac_per_point(nerf)
    else:
        fine = 2.0 * r * cfg.n_fine * 3 * _mac_per_point(nerf)
    if prop is None:
        return fine
    return fine + 2.0 * r * cfg.n_coarse * 3 * _mac_per_point(prop)


def mfu(cfg, models, rays_per_sec: float,
        peak_flops: float = H100_BF16_PEAK) -> float:
    """Model FLOPs utilization of a measured training throughput (rays/s of
    one device)."""
    steps_per_sec = rays_per_sec / cfg.ray_batch
    return steps_per_sec * train_step_flops(cfg, models) / peak_flops
