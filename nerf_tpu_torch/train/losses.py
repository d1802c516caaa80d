"""Losses of the vanilla training step (port of nerf_tpu/train/losses.py:22-40).

The image loss is plain MSE (the reference's SoftL1Loss computes MSE);
the proposal loss is the truncated distillation loss of Mip-NeRF 360.
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
