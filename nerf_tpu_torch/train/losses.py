"""Losses of the training step (port of nerf_tpu/train/losses.py:22-79).

The image loss is plain MSE (the reference's SoftL1Loss computes MSE);
the proposal loss is the truncated distillation loss of Mip-NeRF 360;
Ref-NeRF adds the weighted normal loss and the back-face (orientation)
loss.  Normals are (R, P, 3) here; the JAX package's ``_rl`` forms take
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
