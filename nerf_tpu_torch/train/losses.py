"""Losses of the training step (port of nerf_tpu/train/losses.py:22-123).

The image loss is plain MSE (the reference's SoftL1Loss computes MSE);
the proposal loss is the truncated distillation loss of Mip-NeRF 360;
Ref-NeRF adds the weighted normal loss and the back-face (orientation)
loss; ``--distortion_weight`` and ``--entropy_weight`` add the reference's
distortion regularizer and InfoNeRF's ray-entropy loss.  Normals are (R, P, 3) here; the JAX package's ``_rl`` forms take
(3, R, P), a TPU lane layout, and give the same values.
"""

from __future__ import annotations

import math

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mse_to_psnr(m: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(m) / math.log(10.0)


def proposal_loss(prop_bounds: torch.Tensor,
                  nerf_weights: torch.Tensor) -> torch.Tensor:
    """sum(relu(w - bound)^2 / (w + 1e-8)); the caller detaches
    ``nerf_weights``."""
    diff = torch.relu(nerf_weights - prop_bounds) ** 2
    return torch.sum(diff / (nerf_weights + 1e-8))


def weighted_normal_loss(weights: torch.Tensor, d_norm: torch.Tensor,
                         p_norm: torch.Tensor) -> torch.Tensor:
    """mean(weights * (1 - d_norm . p_norm)): weights (R, P), normals
    (R, P, 3)."""
    return torch.mean(weights * (1.0 - torch.sum(d_norm * p_norm, dim=-1)))


def backface_loss(weights: torch.Tensor, normal: torch.Tensor,
                  ray_d: torch.Tensor) -> torch.Tensor:
    """mean(weights * relu(normal . d)): weights (R, P), normal (R, P, 3),
    per-ray view directions (R, 3)."""
    dot = torch.sum(normal * ray_d[:, None, :], dim=-1)
    return torch.mean(weights * torch.relu(dot))


def reference_distortion_loss(weights: torch.Tensor,
                              fine_ts: torch.Tensor) -> torch.Tensor:
    """The reference's distortion regularizer as written (addtional.py:26-36,
    nerf_tpu/train/losses.py:82-95), including its quirk: the pairwise
    distance matrix is normalized per row, which the published mip-NeRF 360
    loss does not do.  weights and fine_ts are (R, P), the sample weights
    and depths, as the training step passes them: both sums run over the
    P - 1 gaps between samples.  Interval edges (R, P + 1) raise, as they
    do in the JAX package."""
    center = 0.5 * (fine_ts[..., :-1] + fine_ts[..., 1:])
    dists = torch.abs(center[:, None, :] - center[..., None])
    dists = dists / torch.linalg.vector_norm(dists, dim=-1, keepdim=True)
    avg_w = 0.5 * (weights[..., :-1] + weights[..., 1:])
    mult = avg_w[:, None, :] * avg_w[..., None]
    delta = fine_ts[..., 1:] - fine_ts[..., :-1]
    return torch.mean(mult * dists) + torch.mean(delta * avg_w ** 2) / 3.0


def ray_entropy_loss(weights: torch.Tensor,
                     acc_threshold: float = 0.1) -> torch.Tensor:
    """InfoNeRF's ray-density entropy (nerf_tpu/train/losses.py:112-123):
    the entropy of each ray's normalized weights, averaged over the rays
    whose accumulated opacity exceeds ``acc_threshold``."""
    acc = torch.sum(weights, dim=-1)
    p = weights / (acc[..., None] + 1e-10)
    ent = -torch.sum(p * torch.log(p + 1e-10), dim=-1)
    mask = (acc > acc_threshold).to(ent.dtype)
    return torch.sum(ent * mask) / (torch.sum(mask) + 1e-10)
