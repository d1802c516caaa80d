"""Frequency positional encoding (port of nerf_tpu/core/encoding.py:31-53).

Level-major layout: for each level l, sin(2^l x) over the D input dims, then
cos(2^l x) over the D dims.  The JAX package evaluates cos(v) as
sin(v + pi/2) in f32 (its matmul-and-one-sin form); the port keeps those
values: ``x * 2**l`` elementwise in f32 (exact, one power of two), the f32
phase added, one sin.  Never a TF32 or bf16 product: at 2^9 the rounding of x
would become an O(1) phase error.
"""

from __future__ import annotations

import math

import torch


def positional_encoding(x: torch.Tensor, levels: int) -> torch.Tensor:
    """x (..., D) f32 -> (..., 2 * levels * D)."""
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(levels, dtype=torch.float32, device=x.device)
    scaled = x.to(torch.float32)[..., None, :] * freqs[:, None]   # (..., L, D)
    arg = torch.cat([scaled, scaled + torch.tensor(
        0.5 * math.pi, dtype=torch.float32)], dim=-1)            # (..., L, 2D)
    return torch.sin(arg).reshape(*x.shape[:-1], 2 * levels * d)


def cat_pos_pe(x: torch.Tensor, levels: int, dtype=torch.float32) -> torch.Tensor:
    """[x, PE(x)] cast to ``dtype``: the fused kernels' encoding operand."""
    return torch.cat([x, positional_encoding(x, levels)], dim=-1).to(dtype)
