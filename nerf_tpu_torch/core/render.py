"""Volume rendering: transmittance weights and alpha compositing (port of
nerf_tpu/core/render.py:26-145).

Always f32: exp(-sigma * delta) with the 1e10 final delta and the
transmittance chain do not survive bf16.  The transmittance is
exp(exclusive cumsum(log(1 - alpha + 1e-10))), the values of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

FAR_DELTA = 1e10  # open-ended final interval


def lengths_to_points(rays: torch.Tensor, zvals: torch.Tensor) -> torch.Tensor:
    """rays (R, 6), zvals (R, P) -> points (R, P, 3)."""
    return rays[..., None, :3] + rays[..., None, 3:] * zvals[..., :, None]


def transmittance_weights(density: torch.Tensor, zvals: torch.Tensor,
                          ray_dirs: Optional[torch.Tensor] = None,
                          density_act=torch.relu) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i}(1 - alpha_j), (R, P) f32.

    ``density`` is raw and activated here by ``density_act``; with
    ``ray_dirs`` the depths are scaled by ||d||.  The last interval is 1e10.
    """
    density = density.to(torch.float32)
    zvals = zvals.to(torch.float32)
    if ray_dirs is not None:
        zvals = zvals * torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    last = torch.full((*zvals.shape[:-1], 1), FAR_DELTA, dtype=torch.float32,
                      device=zvals.device)
    delta = torch.cat([zvals[..., 1:] - zvals[..., :-1], last], dim=-1)
    mult = torch.exp(-density_act(density) * delta)
    log_t = torch.log(mult + 1e-10)
    excl = torch.cat([torch.zeros_like(log_t[..., :1]),
                      torch.cumsum(log_t[..., :-1], dim=-1)], dim=-1)
    return (1.0 - mult) * torch.exp(excl)


def composite(rgb: torch.Tensor, density: torch.Tensor, zvals: torch.Tensor,
              ray_dirs: torch.Tensor, white_bkg: bool = False,
              density_act=torch.relu,
              depth_bounds: Optional[Tuple[float, float]] = None,
              normal_info: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Alpha-composite (R, P, 3) radiance into (R, 3), depths scaled by |d|.

    Returns (rgb_out, weights (R, P), extras) with the white-background
    completion, the normalized depth extra (``depth_bounds=(near, far)``)
    and the normal map extra (``normal_info=(normals (R, P, 3), camera axis
    (3,))``: the weighted projection on the axis, mapped to [0, 1]).
    """
    zv = zvals.to(torch.float32) * torch.linalg.norm(
        ray_dirs.to(torch.float32), dim=-1, keepdim=True)
    weights = transmittance_weights(density, zv, density_act=density_act)
    rgb_out = torch.sum(weights[..., None] * rgb.to(torch.float32), dim=-2)
    if white_bkg:
        rgb_out = rgb_out + (1.0 - torch.sum(weights, dim=-1))[..., None]
    extras = {}
    if depth_bounds is not None:
        near, far = depth_bounds
        extras["depth"] = (torch.sum(weights * zv, dim=-1) - near) / (far - near)
    if normal_info is not None:
        normal, cam_dir = normal_info
        proj = torch.sum(normal * cam_dir, dim=-1)
        extras["normal"] = (torch.sum(weights * proj, dim=-1) + 1.0) * 0.5
    return rgb_out, weights, extras


def composite_rl(rgb3: torch.Tensor, density: torch.Tensor,
                 zvals: torch.Tensor, ray_dirs: torch.Tensor,
                 white_bkg: bool = False, density_act=torch.relu):
    """``composite`` with row-land radiance, for training: rgb3 (3, R, P) ->
    (rgb_out (R, 3), weights (R, P)), depths scaled by |d|, no extras."""
    zv = zvals.to(torch.float32) * torch.linalg.norm(
        ray_dirs.to(torch.float32), dim=-1, keepdim=True)
    weights = transmittance_weights(density, zv, density_act=density_act)
    rgb_out = torch.sum(weights[None] * rgb3.to(torch.float32), dim=-1).T
    if white_bkg:
        rgb_out = rgb_out + (1.0 - torch.sum(weights, dim=-1))[..., None]
    return rgb_out, weights
