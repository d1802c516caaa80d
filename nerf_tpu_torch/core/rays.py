"""Camera model, ray generation and the training crop window (port of
nerf_tpu/core/rays.py).

Pinhole camera looking down -z in camera space; pixel coordinates are
centered (col - W//2, H//2 - row) and shifted by +0.5 at ray generation,
divided by the focal length; directions are R @ [x, y, -1], unnormalized.

``fov_to_focal(legacy_square=True)`` reproduces the reference's square-image
quirk (focal = W / tan(fov/2), missing the 0.5 factor).
"""

from __future__ import annotations

import numpy as np
import torch


def fov_to_focal(fov, image_hw, legacy_square: bool = False):
    """fov (radians) -> (focal_row, focal_col) in pixels.

    ``fov`` is a scalar (camera_angle_x) or a (fov_x, fov_y) pair;
    ``image_hw`` is (rows, cols).
    """
    h, w = int(image_hw[0]), int(image_hw[1])
    if isinstance(fov, (tuple, list)):
        fov_x, fov_y = float(fov[0]), float(fov[1])
        return (0.5 * h / np.tan(0.5 * fov_y), 0.5 * w / np.tan(0.5 * fov_x))
    fov = float(fov)
    if legacy_square and h == w:
        focal = h / np.tan(0.5 * fov)  # reference quirk: missing 0.5
        return (focal, focal)
    focal = 0.5 * w / np.tan(0.5 * fov)
    return (focal, focal)


def crop_bounds(h: int, w: int, crop_xy) -> tuple:
    """Center-crop window [x_lb, x_ub) x [y_lb, y_ub) of an (h, w) image for
    the (x, y) crop ratios; a ratio of 0.99 or more keeps the whole axis."""
    half_w, half_h = w // 2, h // 2
    cx, cy = crop_xy
    if cx < 0.99:
        x_lb, x_ub = int(half_w * (1.0 - cx)), int(half_w + half_w * cx)
    else:
        x_lb, x_ub = 0, w
    if cy < 0.99:
        y_lb, y_ub = int(half_h * (1.0 - cy)), int(half_h + half_h * cy)
    else:
        y_lb, y_ub = 0, h
    return x_lb, x_ub, y_lb, y_ub


def pixel_coord_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Centered integer (x, y) per pixel, row-major, (H*W, 2) int32."""
    rows = torch.arange(h, dtype=torch.int32, device=device)
    cols = torch.arange(w, dtype=torch.int32, device=device)
    row_ids, col_ids = torch.meshgrid(rows, cols, indexing="ij")
    coords = torch.stack((col_ids - w // 2, h // 2 - row_ids), dim=-1)
    return coords.reshape(-1, 2)


def rays_from_coords(coords: torch.Tensor, c2w: torch.Tensor,
                     focal) -> torch.Tensor:
    """Centered pixel coords (N, 2) + camera-to-world (3, 4) -> rays (N, 6)
    as (origin | unnormalized direction)."""
    f_row, f_col = focal
    # the divisor is filled on the device: a tensor built from a list would
    # be a host-to-device copy, which waits for the device at every step
    div = torch.stack([torch.full((), f, dtype=torch.float32,
                                  device=coords.device) for f in (f_col, f_row)])
    xy = (coords.to(torch.float32) + 0.5) / div
    d_cam = torch.cat([xy, -torch.ones_like(xy[..., :1])], dim=-1)
    d_world = d_cam @ c2w[:, :3].T
    origin = c2w[:, 3].expand_as(d_world)
    return torch.cat([origin, d_world], dim=-1)


def full_image_rays(h: int, w: int, c2w: torch.Tensor, focal) -> torch.Tensor:
    """Rays for every pixel of an (h, w) image, shape (h*w, 6)."""
    return rays_from_coords(pixel_coord_grid(h, w, c2w.device), c2w, focal)


def _rot_x(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    np.float32)


def _rot_y(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Orbit camera pose, 4x4 camera-to-world."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    c2w = _rot_x(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_y(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def orbit_poses(n: int = 120, phi_deg: float = -30.0,
                radius: float = 4.0) -> np.ndarray:
    """The reference's 120-pose render orbit, (n, 4, 4)."""
    angles = np.linspace(-180.0, 180.0, n + 1)[:-1]
    return np.stack([pose_spherical(a, phi_deg, radius) for a in angles])
