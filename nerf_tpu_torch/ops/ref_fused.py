"""Fused Ref-NeRF forward kernels, their plain versions and their wrappers.

Two kernels, CUDA C++ for ``sm_90a`` (``csrc/ref_fused.cu``), each replacing
a Pallas kernel of nerf_tpu/ops/ref_fused.py in the forward-only form that
eval runs (``make_ref_fused(need_grad=False)``, no stored activations):

``ref_spa_fwd``
    ``_make_spa_fwd_kernel`` (:643) over ``_spa_pure`` (:192).  enc (N, 63)
    -> heads (N, 11 + NB) f32, unrounded: [rho_tau 2 | normal 3, diffuse 3,
    tint 3 | bottleneck NB].
``ref_dir_fwd``
    ``_make_dir_fwd_kernel`` (:841) over ``_dir_glue_pure_rowland`` (:575)
    with the recurrence IDE (``hand_vjp=True``).  heads (N, 11 + NB) f32,
    the per-ray directions (R, 3) f32 with P samples per ray (N = R P), an
    optional noise (N, NB) in the compute dtype -> rgb (N, 3), normal
    (N, 3) and the raw density passthrough (N,), f32.  The TPU kernel's
    row-land (3, N) layouts were a lane choice; the values are the same.

Numerics are the Pallas kernels' (ref_fused.py:79-83, :543-637), not the
flax module's: weight matrices (in, out) in the compute dtype, biases (1, W)
f32, f32 accumulation, the bias added in f32, ReLU and a cast after every
hidden layer; the heads and the whole glue (normal, d.n on the raw ray
direction, reflection, softplus roughness, the IDE) in f32, and the trunk
input [bottleneck + noise | IDE | d.n] cast to the compute dtype.  The flax
module, and the port's ``RefNeRF`` after it, round the heads and run the
glue in the compute dtype: under bf16 the two routes part by more than the
kernels and their plain versions do, and each is held against its own
counterpart.

Bounds on an H100 SXM at its 700 W limit (989 TFLOP/s bf16): at H = O = 256
the spatial net costs 526,592 MACs per point and the directional 545,024
(+ 171 for the IDE's z-powers @ mat), both bound by operations.  These first
versions multiply on the CUDA cores (PERF.md has their times).

Dispatch as in ``fused_mlp``: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` (``ops/launch.py``)
counts each wrapper call that launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nerf_tpu_torch.core.encoding import ide_tables, integrated_dir_enc
from nerf_tpu_torch.core.encoding import linear_to_srgb
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.ops.fused_mlp import _dense, _hidden
from nerf_tpu_torch.ops.launch import (
    I64, INTP, PTR, U64P, check_operands, check_shapes, check_tensor,
    check_weights, launch, pointers, register,
)

F32 = torch.float32
N_REF_SPA_WS = 23   # ref_fused.py:51-63
N_REF_DIR_WS = 19   # ref_fused.py:65-74
REF_SPA_BIASES = (1, 3, 5, 7, 10, 12, 14, 16, 18, 20, 22)
REF_DIR_BIASES = (1, 3, 5, 7, 10, 12, 14, 16, 18)
HEAD_FIXED = 11     # rho_tau 2 + normal 3 + diffuse 3 + tint 3
IDE_LEVELS = range(1, 6)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

def ref_spa_plain(ws, enc: torch.Tensor) -> torch.Tensor:
    """``_spa_pure`` in plain PyTorch: heads (N, 11 + NB) f32."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     w7, b7, wrt, brt, wnct, bnct, wbn, bbn) = ws
    cd = enc.dtype
    h1 = _hidden(enc, w0, b0, cd)
    h2 = _hidden(h1, w1, b1, cd)
    h3 = _hidden(h2, w2, b2, cd)
    h4 = _hidden(h3, w3, b3, cd)
    z5 = torch.relu(_dense(enc, w4a) + _dense(h4, w4b, b4)).to(cd)
    z6 = _hidden(z5, w5, b5, cd)
    z7 = _hidden(z6, w6, b6, cd)
    inter = _hidden(z7, w7, b7, cd)
    return torch.cat([_dense(inter, wrt, brt), _dense(inter, wnct, bnct),
                      _dense(inter, wbn, bbn)], dim=1)


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0)."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def ref_dir_plain(ws, heads: torch.Tensor, dirs: torch.Tensor, per_ray: int,
                  noise=None, ide_level: int = 4, use_srgb: bool = False):
    """``_dir_glue_pure_rowland`` (recurrence IDE) in plain PyTorch:
    (rgb (N, 3), normal (N, 3), density (N,)) f32."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     w7, b7, wh, bh) = ws
    cd = w0.dtype
    heads = heads.to(F32)
    n_raw = heads[:, 2:5]
    norm = torch.sqrt(torch.sum(n_raw * n_raw, dim=-1, keepdim=True) + 1e-20)
    normal = -n_raw / (norm + 1e-7)
    d = torch.repeat_interleave(dirs.to(F32), per_ray, dim=0)
    d_dot_n = torch.sum(d * normal, dim=-1, keepdim=True)
    reflect = d - 2.0 * d_dot_n * normal
    ide = integrated_dir_enc(reflect, softplus(heads[:, 0:1] - 1.0),
                             ide_level, recurrence=True)
    b_vec = heads[:, HEAD_FIXED:]
    if noise is not None:
        b_vec = b_vec + noise.to(F32)
    x = torch.cat([b_vec.to(cd), ide.to(cd), d_dot_n.to(cd)], dim=1)
    h1 = _hidden(x, w0, b0, cd)
    h2 = _hidden(h1, w1, b1, cd)
    h3 = _hidden(h2, w2, b2, cd)
    h4 = _hidden(h3, w3, b3, cd)
    z5 = torch.relu(_dense(x, w4a) + _dense(h4, w4b, b4)).to(cd)
    z6 = _hidden(z5, w5, b5, cd)
    z7 = _hidden(z6, w6, b6, cd)
    z8 = _hidden(z7, w7, b7, cd)
    spec = torch.sigmoid(_dense(z8, wh, bh))
    diff_logit = heads[:, 5:8] - math.log(3.0) if use_srgb else heads[:, 5:8]
    rgb = spec * torch.sigmoid(heads[:, 8:11]) + torch.sigmoid(diff_logit)
    if use_srgb:
        rgb = linear_to_srgb(rgb)
    return rgb, normal, heads[:, 1].contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _spa_dims(ws, enc):
    n, dx = enc.shape
    h, o, nb = ws[0].shape[1], ws[15].shape[1], ws[21].shape[1]
    check_shapes(ws, [(0, (dx, h)), (2, (h, h)), (4, (h, h)), (6, (h, h)),
                      (8, (dx, h)), (9, (h, h)), (11, (h, h)), (13, (h, h)),
                      (15, (h, o)), (17, (o, 2)), (19, (o, 9)),
                      (21, (o, nb))], REF_SPA_BIASES)
    return n, dx, h, o, nb


def _dir_dims(ws, heads, ide_level: int):
    if ide_level not in IDE_LEVELS:
        raise ValueError(f"ide_level must be in 1..5, got {ide_level}")
    tables = ide_tables(ide_level)
    n, hw = heads.shape
    nb, n_ch = hw - HEAD_FIXED, tables["n_ch"]
    dd = nb + 2 * n_ch + 1
    h, o = ws[0].shape[1], ws[13].shape[1]
    check_shapes(ws, [(0, (dd, h)), (2, (h, h)), (4, (h, h)), (6, (h, h)),
                      (8, (dd, h)), (9, (h, h)), (11, (h, h)), (13, (h, o)),
                      (15, (o, o)), (17, (o, 3))], REF_DIR_BIASES)
    return n, nb, h, o, tables["l_max"], n_ch


@functools.lru_cache(maxsize=None)
def _ide_operands(ide_level: int, device: torch.device):
    """The IDE tables ``mat`` (l_max+1, C) and ``sigma`` (C,), f32 on
    ``device``."""
    tables = ide_tables(ide_level)
    return (torch.as_tensor(tables["mat"], device=device).contiguous(),
            torch.as_tensor(tables["sigma"], device=device).contiguous())


register({
    "ref_spa_fwd": ("ref_fused", [PTR, U64P, I64, INTP, PTR]),
    "ref_dir_fwd": ("ref_fused", [PTR, PTR, PTR, I64, PTR, PTR, U64P, I64,
                                  INTP, PTR, PTR, PTR]),
})


def ref_spa_fwd(ws, enc: torch.Tensor, device=None) -> torch.Tensor:
    """Fused Ref-NeRF spatial forward: enc (N, Dx) -> heads (N, 11 + NB) f32.

    ``ws`` is the 23-entry spatial tuple (matrices in enc's dtype, biases
    f32).  ``device`` defaults to ``cuda``; the operands must lie there.  On
    the CPU (``device="cpu"``) this is ``ref_spa_plain``.
    """
    dev = resolve_device(device)
    check_operands(ws, (enc,), N_REF_SPA_WS, REF_SPA_BIASES, dev)
    n, dx, h, o, nb = _spa_dims(ws, enc)
    if dev.type == "cpu":
        return ref_spa_plain(ws, enc)
    heads = torch.empty((n, HEAD_FIXED + nb), dtype=F32, device=enc.device)
    if n > 0:
        dims = (ctypes.c_int * 4)(dx, h, o, nb)
        launch("ref_spa_fwd", enc.dtype, enc.device, enc.data_ptr(),
               pointers(ws), n, dims, heads.data_ptr())
    return heads


def ref_dir_fwd(ws, heads: torch.Tensor, dirs: torch.Tensor, per_ray: int,
                noise=None, ide_level: int = 4, use_srgb: bool = False,
                device=None):
    """Fused Ref-NeRF directional forward with its glue: heads (N, 11 + NB)
    f32, dirs (R, 3) f32 (the raw ray directions, one per ray, for
    ``per_ray`` consecutive points each) -> (rgb (N, 3), normal (N, 3), raw
    density (N,)) f32.

    ``ws`` is the 19-entry directional tuple; its matrices' dtype is the
    compute dtype.  ``noise`` (N, NB) in that dtype is added to the
    bottleneck; None adds nothing (eval).  ``device`` defaults to ``cuda``;
    on the CPU this is ``ref_dir_plain``.
    """
    dev = resolve_device(device)
    if len(ws) != N_REF_DIR_WS:
        raise ValueError(f"expected {N_REF_DIR_WS} weights, got {len(ws)}")
    cd = ws[0].dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be f32 or bf16, got {cd}")
    check_weights(ws, REF_DIR_BIASES, cd, dev)
    if heads.dim() != 2:
        raise ValueError(f"heads must be 2-D, got {tuple(heads.shape)}")
    check_tensor(heads, heads.shape, F32, dev, "heads")
    n, nb, h, o, l_max, n_ch = _dir_dims(ws, heads, ide_level)
    if per_ray < 1 or n % per_ray:
        raise ValueError(f"{n} points are not {per_ray} per ray")
    check_tensor(dirs, (n // per_ray, 3), F32, dev, "dirs")
    if noise is not None:
        check_tensor(noise, (n, nb), cd, dev, "noise")
    if dev.type == "cpu":
        return ref_dir_plain(ws, heads, dirs, per_ray, noise, ide_level,
                             use_srgb)
    like = dict(dtype=F32, device=heads.device)
    rgb, normal = torch.empty((n, 3), **like), torch.empty((n, 3), **like)
    density = torch.empty(n, **like)
    if n > 0:
        mat, sigma = _ide_operands(ide_level, heads.device)
        dims = (ctypes.c_int * 6)(nb, h, o, l_max, n_ch, int(use_srgb))
        launch("ref_dir_fwd", cd, heads.device, heads.data_ptr(),
               None if noise is None else noise.data_ptr(), dirs.data_ptr(),
               per_ray, mat.data_ptr(), sigma.data_ptr(), pointers(ws), n,
               dims, rgb.data_ptr(), normal.data_ptr(), density.data_ptr())
    return rgb, normal, density


def ref_fine_fwd(spa_ws, dir_ws, enc: torch.Tensor, dirs: torch.Tensor,
                 per_ray: int, ide_level: int = 4, use_srgb: bool = False,
                 device=None):
    """The whole Ref-NeRF fine forward through the two kernels, as
    ``make_ref_fused``'s ``fused`` chains them (ref_fused.py:1293-1304) in
    its eval form, without noise: (rgb (N, 3), raw density (N,), normal
    (N, 3)) f32."""
    heads = ref_spa_fwd(spa_ws, enc, device=device)
    rgb, normal, density = ref_dir_fwd(dir_ws, heads, dirs, per_ray,
                                       ide_level=ide_level,
                                       use_srgb=use_srgb, device=device)
    return rgb, density, normal
