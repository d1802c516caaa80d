"""Encodings: the frequency positional encoding, Mip-NeRF's integrated
positional encoding (IPE) of conical frustums, Ref-NeRF's integrated
directional encoding (IDE) and the sRGB curve (port of
nerf_tpu/core/encoding.py:31-53, :60-113, :121-242).

Level-major PE layout: for each level l, sin(2^l x) over the D input dims,
then cos(2^l x) over the D dims.  The JAX package evaluates cos(v) as
sin(v + pi/2) in f32 (its matmul-and-one-sin form); the port keeps those
values: ``x * 2**l`` elementwise in f32 (exact, one power of two), the f32
phase added, one sin.  Never a TF32 or bf16 product: at 2^9 the rounding of x
would become an O(1) phase error.

The IPE keeps the JAX package's diagonal covariance with the Mip-NeRF
paper's projector diag(I - d d^T / |d|^2) and its per-level (sin, cos)
interleave: for each level l, sin(2^l mu) * exp(-0.5 4^l var) over the 3
dims, then the cos part over the 3 dims.  All f32.

The IDE tables are the port's own numpy copy of ``ide_tables``; the encoding
evaluates (x + iy)^m by the complex-power recurrence and z^i as ``z**i`` does
in JAX (binary exponentiation, ``lax.integer_pow``), or, with
``recurrence=True``, by repeated multiplication as the Ref-NeRF kernels do
(ref_fused.py:380); in the dtype of its input.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


# --------------------------------------------------------------------------
# Integrated positional encoding (Mip-NeRF cone math)
# --------------------------------------------------------------------------

def cone_parameters(zvals: torch.Tensor, r: float):
    """Gaussian approximation (mu_t, sigma_t^2, sigma_r^2) of the conical
    frustums between consecutive depths zvals (..., n + 1), each (..., n),
    for a cone of base radius ``r`` at unit distance."""
    mid = 0.5 * (zvals[..., 1:] + zvals[..., :-1])
    diff = (0.5 * (zvals[..., 1:] - zvals[..., :-1])) ** 2
    tmp = 3.0 * mid ** 2 + diff
    mu_t = mid + 2.0 * mid * diff / tmp
    sigma_t2 = (diff / 3.0
                - 4.0 * diff ** 2 * (12.0 * mid ** 2 - diff) / 15.0 / tmp ** 2)
    sigma_r2 = r ** 2 * (0.25 * mid ** 2 + 5.0 / 12.0 * diff
                         - 4.0 * diff ** 2 / (15.0 * tmp))
    return mu_t, sigma_t2, sigma_r2


def cone_mean_diagcov(rays: torch.Tensor, mu_t: torch.Tensor,
                      sigma_t2: torch.Tensor, sigma_r2: torch.Tensor):
    """Mean (R, n, 3) and diagonal covariance (R, n, 3) of each frustum's
    Gaussian along rays (R, 6) = (origin | direction): sigma_t^2 d^2 +
    sigma_r^2 diag(I - d d^T / |d|^2), the paper's projector (in [0, 1] for
    any |d|)."""
    o, d = rays[..., :3], rays[..., 3:]
    mu = o[..., None, :] + mu_t[..., :, None] * d[..., None, :]
    dd = d * d
    d_norm2 = torch.sum(dd, dim=-1, keepdim=True)
    i_m_ddt = 1.0 - dd / torch.clamp_min(d_norm2, 1e-10)
    diag_sigma = (sigma_t2[..., :, None] * dd[..., None, :]
                  + sigma_r2[..., :, None] * i_m_ddt[..., None, :])
    return mu, diag_sigma


def ipe_feature(zvals: torch.Tensor, rays: torch.Tensor, levels: int,
                r: float):
    """The IPE of the frustums between depths zvals (R, n + 1) along rays
    (R, 6): (features (R, n, 6 * levels), mu (R, n, 3), mu_t (R, n)), f32.

    Level l's six entries are sin(2^l mu) * a, then cos(2^l mu) * a, with
    a = exp(-0.5 * 4^l * var) per dim."""
    mu_t, sigma_t2, sigma_r2 = cone_parameters(zvals.to(torch.float32), r)
    mu, diag_sigma = cone_mean_diagcov(rays.to(torch.float32), mu_t,
                                       sigma_t2, sigma_r2)
    freqs = 2.0 ** torch.arange(levels, dtype=torch.float32,
                                device=mu.device)
    mu_r = mu[..., None, :] * freqs[:, None]                     # (.., L, 3)
    var_r = diag_sigma[..., None, :] * (freqs ** 2)[:, None]     # (.., L, 3)
    atten = torch.exp(-0.5 * var_r)
    feat = torch.cat([torch.sin(mu_r) * atten, torch.cos(mu_r) * atten],
                     dim=-1)                                     # (.., L, 6)
    return feat.reshape(*mu.shape[:-1], 6 * levels), mu, mu_t


# --------------------------------------------------------------------------
# Integrated directional encoding (Ref-NeRF eq. 6-8)
# --------------------------------------------------------------------------

def _generalized_binomial(a: float, k: int) -> float:
    return float(np.prod(a - np.arange(k)) / math.factorial(k))


def _assoc_legendre_coeff(l: int, m: int, k: int) -> float:
    return (
        (-1) ** m
        * 2**l
        * math.factorial(l)
        / math.factorial(k)
        / math.factorial(l - k - m)
        * _generalized_binomial(0.5 * (l + k + m - 1.0), l)
    )


def _sph_harm_coeff(l: int, m: int, k: int) -> float:
    return (
        math.sqrt(
            (2.0 * l + 1.0) * math.factorial(l - m)
            / (4.0 * np.pi * math.factorial(l + m))
        )
        * _assoc_legendre_coeff(l, m, k)
    )


def _ml_array(deg_view: int) -> np.ndarray:
    ml = []
    for i in range(deg_view):
        l = 2**i
        for m in range(l + 1):
            ml.append((m, l))
    return np.array(ml).T  # (2, C): rows m, l


@functools.lru_cache(maxsize=None)
def ide_tables(deg_view: int):
    """Coefficient tables of the IDE, as numpy arrays.

    Returns a dict: ``mat`` (l_max+1, C) z-Vandermonde coefficients,
    ``m_arr`` (C,) order m of each channel, ``sigma`` (C,) vMF attenuation
    l(l+1)/2, ``l_max`` = 2^(deg_view-1) and ``n_ch`` = C.  The channels run
    over the levels l = 1, 2, 4, ..., l_max, and within a level over
    m = 0..l.
    """
    if deg_view > 5:
        raise ValueError("Only deg_view of at most 5 is numerically stable.")
    ml = _ml_array(deg_view)
    l_max = 2 ** (deg_view - 1)
    n_ch = ml.shape[1]

    mat = np.zeros((l_max + 1, n_ch), np.float32)
    for i, (m, l) in enumerate(ml.T):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)

    sigma = (0.5 * ml[1] * (ml[1] + 1)).astype(np.float32)
    return {
        "mat": mat,
        "m_arr": ml[0].astype(np.int32),
        "sigma": sigma,
        "l_max": l_max,
        "n_ch": n_ch,
    }


def ide_dim(deg_view: int) -> int:
    """Output width of the IDE: 2 * sum_{i<deg} (2^i + 1)."""
    return ((1 << deg_view) - 1 + deg_view) << 1


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y for an int y >= 1 by binary exponentiation, the products of
    ``lax.integer_pow``."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def integrated_dir_enc(xyz: torch.Tensor, kappa_inv: torch.Tensor,
                       deg_view: int, recurrence: bool = False) -> torch.Tensor:
    """Integrated directional encoding of directions xyz (..., 3) (need not
    be unit) with vMF concentration reciprocal kappa_inv (..., 1), computed
    in xyz's dtype: (..., 2C) = [Re (C) | Im (C)].

    Channel c is Re/Im (x + iy)^m_c * (z-powers @ mat)_c * exp(-sigma_c
    kappa_inv); ``recurrence`` picks the kernels' form of the z-powers.
    """
    tables = ide_tables(deg_view)
    l_max = tables["l_max"]
    like = dict(dtype=xyz.dtype, device=xyz.device)
    mat = torch.as_tensor(tables["mat"], **like)
    sigma = torch.as_tensor(tables["sigma"], **like)
    m_arr = torch.as_tensor(tables["m_arr"], dtype=torch.int64,
                            device=xyz.device)
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]

    vz = [torch.ones_like(z)]
    for i in range(1, l_max + 1):
        vz.append(vz[-1] * z if recurrence else _integer_pow(z, i))
    vz_mat = torch.cat(vz, dim=-1) @ mat                          # (..., C)

    re_p, im_p = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(l_max):
        re, im = re_p[-1], im_p[-1]
        re_p.append(re * x - im * y)
        im_p.append(im * x + re * y)
    re_xy = torch.cat(re_p, dim=-1)[..., m_arr]
    im_xy = torch.cat(im_p, dim=-1)[..., m_arr]

    atten = torch.exp(-sigma * kappa_inv)
    return torch.cat([re_xy * vz_mat * atten, im_xy * vz_mat * atten], dim=-1)


def linear_to_srgb(linear: torch.Tensor, eps: float | None = None) -> torch.Tensor:
    """The sRGB curve (from multinerf), in ``linear``'s dtype."""
    if eps is None:
        eps = float(np.finfo(np.float32).eps)
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp_min(linear, eps) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)
