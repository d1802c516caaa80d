"""Fused Ref-NeRF kernels, their plain versions, wrappers and autograd.

Nine kernels, CUDA C++ for ``sm_90a``, each replacing a Pallas kernel of
nerf_tpu/ops/ref_fused.py.  The forwards are in ``csrc/ref_fused.cu``; in
bf16 the three spatial ones run the persistent frame of
``csrc/spa_frame.cuh`` (tiles of 128 points, one block an SM, a producer
that streams every layer's weights through one ring), and the two
directional ones the same frame with their glue and tail
(``csrc/dir_frame.cuh``); each runs its 64-row tile (``csrc/ref_fused.cu``,
``csrc/ref_dir_fwd.cuh``) at widths whose frame does not fit a block
(chosen by shape before the launch; each launch counts the body it ran in
``BODIES``, named by ``spa_body_name`` and ``dir_body_name``):

``ref_spa_fwd``
    ``_make_spa_fwd_kernel`` (:643) over ``_spa_pure`` (:192) in the eval
    form (``need_grad=False``, no stored activations).  enc (N, 63) -> heads
    (N, 11 + NB) f32, unrounded: [rho_tau 2 | normal 3, diffuse 3, tint 3 |
    bottleneck NB].
``ref_spa_fwd_res``
    The same kernel in the training form (``need_grad=True,
    store_acts=True``, :653-697): the heads, the 8 activations h1 h2 h3 h4
    z5 z6 z7 inter in the compute dtype, and the detached normal target
    -g / max(1e-5, |g|) (N, 3) f32, where g = d(density)/d(pos) is the
    hand-written backward of the density column alone through the trunk
    and the positional encoding.
``ref_spa_fwd_grad``
    The training form of ``store_residuals=False`` (``need_grad=True,
    store_acts=False``): the heads and the normal target, and no
    activations; the density pullback reads its ReLU masks from bits the
    block keeps in shared memory (as ``ref_spa_fwd_res`` does in bf16).
``ref_dir_fwd`` / ``ref_dir_fwd_res``
    ``_make_dir_fwd_kernel`` (:841) over ``_dir_glue_pure_rowland`` (:575)
    with the recurrence IDE (``hand_vjp=True``), without and with the 8
    stored activations h1 h2 h3 h4 z5 z6 (H wide) z7 z8 (O wide).  heads
    (N, 11 + NB) f32, the per-ray directions (R, 3) f32 with P samples per
    ray (N = R P), an optional noise (N, NB) in the compute dtype -> rgb
    (N, 3), normal (N, 3) and the raw density passthrough (N,), f32.  The
    TPU kernel's row-land (3, N) layouts were a lane choice; the values are
    the same.

The backwards are in ``csrc/ref_fused_bwd.cu``:

``ref_spa_bwd``
    ``_make_spa_bwd_res_kernel`` (:729): the cotangent of the heads and the
    stored activations -> the 23 f32 grads of the spatial tuple.  In bf16
    its delta pass runs the persistent frame of ``csrc/spa_bwd_frame.cuh``
    (the 64-row tile where no frame fits; ``spa_bwd_body_name``).
``ref_dir_bwd``
    ``_make_dir_bwd_res_kernel`` (:901): the cotangents of rgb, normal and
    density and the stored activations -> d(heads) (N, 11 + NB) f32 and the
    19 f32 grads of the directional tuple.  The rgb tail and the glue before
    the trunk (normal, reflection, IDE, roughness), which the TPU kernel
    differentiates with ``jax.vjp``, are written out by hand.

The recompute backwards of ``store_residuals=False`` are in
``csrc/ref_fused_recompute.cu``:

``ref_spa_bwd_recompute``
    ``_make_spa_bwd_kernel`` (:701): enc and the heads' cotangent -> the 23
    grads, the trunk rebuilt from enc (in bf16 on the same frame, once a
    chunk).
``ref_dir_bwd_recompute``
    ``_make_dir_bwd_kernel`` (:867): ``ref_dir_bwd``'s outputs from the
    forward's operands and the cotangents, the glue and the trunk rebuilt.

Both walk the points in chunks of whole ``tile``-row K-splits, each
chunk's activations and deltas in scratch of the chunk's size, so that no
activation of all N points is held.  Their numerics are ``jax.vjp``'s
through ``_cd_matmul_rules``, which differ from the residual kernels' hand
rules in the spatial net only: d(inter) sums the heads' pullbacks as
(bn + nct) + rt, the reverse of the residual kernel's order, and the heads'
bias grads sum the f32 cotangent instead of its rounded copy.

Numerics are the Pallas kernels' (ref_fused.py:79-163, :543-637), not the
flax module's: weight matrices (in, out) in the compute dtype, biases (1, W)
f32, f32 accumulation, the bias added in f32, ReLU and a cast after every
hidden layer; the heads and the whole glue (normal, d.n on the raw ray
direction, reflection, softplus roughness, the IDE) in f32, and the trunk
input [bottleneck + noise | IDE | d.n] cast to the compute dtype.  The
backwards follow ``_cd_matmul_rules`` with ``bwd_cd=True``: every cotangent
is cast to the compute dtype before its pullback product, the ReLU masks
come from the stored activations, the pullbacks of split inputs are summed
as compute-dtype arrays (rounding after each add), bias grads are f32 sums,
and each ``tile`` rows' weight grad is rounded to the compute dtype before
the f32 sum over tiles, as the TPU kernels do per grid step.  The flax
module, and the port's ``RefNeRF`` after it, round the heads and run the
glue in the compute dtype: under bf16 the two routes part by more than the
kernels and their plain versions do, and each is held against its own
counterpart.

Bounds on an H100 SXM at its 700 W limit (989 TFLOP/s bf16): at H = O = 256
the spatial net costs 526,592 MACs per point and the directional 545,024
(+ 171 for the IDE's z-powers @ mat), both bound by operations; the
training forward of the spatial net adds about 491,500 MACs for the density
gradient, and each backward costs about twice its forward.  The trunks'
layers (``dense_tile``, ``ops.dense``) and the backwards' weight-grad pass
(csrc/wgrad.cuh) multiply bf16 operands on the tensor cores, and so do the
bottleneck head and the delta passes' trunk layers; the narrow heads and
the glue run on the CUDA cores (PERF.md has their times).
The bf16 kernels take H and O that are multiples of 8 (the launch raises
otherwise).

Dispatch as in ``fused_mlp``: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` (``ops/launch.py``)
counts each wrapper call that launches.  ``RefSpatialMLP`` and
``RefDirectionalMLP`` are the ``torch.autograd.Function``s of the training
path, the ``custom_vjp`` pairs of ``_make_spa_fused`` (:1013) and
``_make_dir_fused`` (:1116) with ``store_residuals=True``;
``RefSpatialMLPRecompute`` and ``RefDirectionalMLPRecompute`` are the same
pairs with ``store_residuals=False``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nerf_tpu_torch.core.encoding import ide_tables, integrated_dir_enc
from nerf_tpu_torch.core.encoding import linear_to_srgb
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.ops.fused_mlp import (
    _dense, _dwt, _hidden, _mask, chunk_rows, grads_of_jobs,
)
from nerf_tpu_torch.ops.launch import (
    I64, INT, INTP, PTR, U64P, check_operands, check_shapes, check_tensor,
    check_weights, count_body, launch, pointers, prep_weights, register,
)

F32 = torch.float32
N_REF_SPA_WS = 23   # ref_fused.py:51-63
N_REF_DIR_WS = 19   # ref_fused.py:65-74
N_REF_ACTS = 8      # N_SPA_ACTS, N_DIR_ACTS (ref_fused.py:726, :838)
REF_SPA_BIASES = (1, 3, 5, 7, 10, 12, 14, 16, 18, 20, 22)
REF_DIR_BIASES = (1, 3, 5, 7, 10, 12, 14, 16, 18)
HEAD_FIXED = 11     # rho_tau 2 + normal 3 + diffuse 3 + tint 3
IDE_LEVELS = range(1, 6)
TILE = 2048         # rows per weight-grad rounding tile (cfg.pallas_tile)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pe_tables(levels: int, dim: int):
    """The positional encoding as a projection: w (dim, 2 levels dim) and b
    (2 levels dim,) f32 with sin(x @ w + b) = PE(x), level-major [sin,
    cos] (nerf_tpu/core/fastmath.py:28-41, the port's own copy)."""
    out_dim = 2 * levels * dim
    w = np.zeros((dim, out_dim), np.float32)
    b = np.zeros((out_dim,), np.float32)
    for lv in range(levels):
        for d in range(dim):
            w[d, 2 * lv * dim + d] = 2.0 ** lv
            w[d, 2 * lv * dim + dim + d] = 2.0 ** lv
            b[2 * lv * dim + dim + d] = 0.5 * np.pi
    return w, b


def _spa_forward(ws, enc):
    """All of ``_spa_pure``'s values: the 8 activations and the heads."""
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
    heads = torch.cat([_dense(inter, wrt, brt), _dense(inter, wnct, bnct),
                       _dense(inter, wbn, bbn)], dim=1)
    return (h1, h2, h3, h4, z5, z6, z7, inter), heads


def ref_spa_plain(ws, enc: torch.Tensor) -> torch.Tensor:
    """``_spa_pure`` in plain PyTorch: heads (N, 11 + NB) f32."""
    return _spa_forward(ws, enc)[1]


def density_grad_plain(ws, enc, pos, acts) -> torch.Tensor:
    """g = d(raw density)/d(pos) (N, 3) f32, as ``_make_spa_fwd_kernel``
    takes it with ``bwd_cd=True`` (:665-684): the density column's pullback
    through the trunk, cast to the compute dtype after every product, the
    two pullbacks into the encoding rounded each and summed in f32, then the
    encoding's transpose g = denc[:, :3] + (denc[:, 3:] cos(pos @ w + b))
    @ w^T."""
    (w0, _, w1, _, w2, _, w3, _, w4a, w4b, _, w5, _, w6, _, w7, _,
     wrt, _, _, _, _, _) = ws
    h1, h2, h3, h4, z5, z6, z7, inter = acts
    cd = enc.dtype
    e8 = _mask(inter, wrt[:, 1].to(F32).expand(enc.shape[0], -1), cd)
    e7 = _mask(z7, _dwt(e8, w7), cd)
    e6 = _mask(z6, _dwt(e7, w6), cd)
    e5 = _mask(z5, _dwt(e6, w5), cd)
    e4 = _mask(h4, _dwt(e5, w4b), cd)
    e3 = _mask(h3, _dwt(e4, w3), cd)
    e2 = _mask(h2, _dwt(e3, w2), cd)
    e1 = _mask(h1, _dwt(e2, w1), cd)
    denc = _dwt(e1, w0).to(cd).to(F32) + _dwt(e5, w4a).to(cd).to(F32)
    pe_w, pe_b = (torch.as_tensor(t, device=enc.device)
                  for t in pe_tables((enc.shape[1] - 3) // 6, 3))
    proj = pos.to(F32) @ pe_w + pe_b
    return denc[:, :3] + (denc[:, 3:] * torch.cos(proj)) @ pe_w.T


def normal_target(g: torch.Tensor) -> torch.Tensor:
    """-g / max(1e-5, |g|) per row."""
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return -(g / torch.clamp_min(norm, 1e-5))


def ref_spa_fwd_res_plain(ws, enc: torch.Tensor, pos: torch.Tensor):
    """The training form in plain PyTorch: (heads (N, 11 + NB) f32, normal
    target (N, 3) f32, the 8 activations (N, width) in the compute
    dtype)."""
    acts, heads = _spa_forward(ws, enc)
    return heads, normal_target(density_grad_plain(ws, enc, pos, acts)), acts


def ref_spa_fwd_grad_plain(ws, enc: torch.Tensor, pos: torch.Tensor):
    """``ref_spa_fwd_res_plain`` without the activations: (heads, normal
    target)."""
    return ref_spa_fwd_res_plain(ws, enc, pos)[:2]


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0)."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


# the stages of the directional forward, each adding a part of the glue to
# the one before (ref_common.cuh's DIR_TRUNK .. DIR_FULL)
DIR_STAGES = ("trunk", "reflect", "vander", "polar", "full")


def _dir_glue(heads, dirs, per_ray, noise, ide_level, use_srgb, cd,
              stage: str = "full", rows=None):
    """``_dir_glue_prelude_rowland`` (:543-572) in f32, differentiable in
    ``heads``: the trunk input x (N, Dd) in ``cd``, the normal (N, 3),
    sigmoid(tint) and sigmoid(diffuse [- ln 3]) (N, 3).

    ``stage`` stops the glue early, as the dissection's stages do
    (``ops/ref_dissect.py``): "trunk" takes the IDE and d.n columns of x
    from ``rows`` (2C + 1, N) and the normal from the directions;
    "reflect" adds the reflection and the roughness to the first 4 of the
    2C IDE rows; "vander" puts (z-powers @ mat) exp(-sigma roughness) in
    both the Re and the Im half; "polar" is the full glue.  Below "full"
    tint and diffuse are None."""
    d = torch.repeat_interleave(dirs.to(F32), per_ray, dim=0)
    b_vec = heads[:, HEAD_FIXED:]
    if noise is not None:
        b_vec = b_vec + noise.to(F32)
    if stage == "trunk":
        return (torch.cat([b_vec.to(cd), rows.T.to(cd)], dim=1), d, None,
                None)
    n_raw = heads[:, 2:5]
    norm = torch.sqrt(torch.sum(n_raw * n_raw, dim=-1, keepdim=True) + 1e-20)
    normal = -n_raw / (norm + 1e-7)
    d_dot_n = torch.sum(d * normal, dim=-1, keepdim=True)
    reflect = d - 2.0 * d_dot_n * normal
    rough = softplus(heads[:, 0:1] - 1.0)
    if stage == "reflect":
        ide = rows[:-1].T + F.pad(torch.cat([reflect, rough], dim=1),
                                  (0, rows.shape[0] - 5))
    elif stage == "vander":
        # the IDE of (1, 0, z): its real half is (z-powers @ mat) att
        half = integrated_dir_enc(
            torch.cat([torch.ones_like(rough), torch.zeros_like(rough),
                       reflect[:, 2:3]], dim=1), rough, ide_level,
            recurrence=True)[:, :ide_tables(ide_level)["n_ch"]]
        ide = torch.cat([half, half], dim=1)
    else:
        ide = integrated_dir_enc(reflect, rough, ide_level, recurrence=True)
    x = torch.cat([b_vec.to(cd), ide.to(cd), d_dot_n.to(cd)], dim=1)
    if stage != "full":
        return x, normal, None, None
    diff_logit = heads[:, 5:8] - math.log(3.0) if use_srgb else heads[:, 5:8]
    return x, normal, torch.sigmoid(heads[:, 8:11]), torch.sigmoid(diff_logit)


def _dir_trunk(ws, x):
    """The directional trunk: its 8 activations h1 h2 h3 h4 z5 z6 z7 z8."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     w7, b7, _, _) = ws
    cd = x.dtype
    h1 = _hidden(x, w0, b0, cd)
    h2 = _hidden(h1, w1, b1, cd)
    h3 = _hidden(h2, w2, b2, cd)
    h4 = _hidden(h3, w3, b3, cd)
    z5 = torch.relu(_dense(x, w4a) + _dense(h4, w4b, b4)).to(cd)
    z6 = _hidden(z5, w5, b5, cd)
    z7 = _hidden(z6, w6, b6, cd)
    z8 = _hidden(z7, w7, b7, cd)
    return h1, h2, h3, h4, z5, z6, z7, z8


def _dir_tail(logit, tint, diff, use_srgb):
    rgb = torch.sigmoid(logit) * tint + diff
    return linear_to_srgb(rgb) if use_srgb else rgb


def ref_dir_fwd_res_plain(ws, heads: torch.Tensor, dirs: torch.Tensor,
                          per_ray: int, noise=None, ide_level: int = 4,
                          use_srgb: bool = False):
    """``_dir_glue_pure_rowland`` (recurrence IDE) in plain PyTorch:
    (rgb (N, 3), normal (N, 3), density (N,)) f32 and the 8 trunk
    activations (N, width) in the compute dtype."""
    heads = heads.to(F32)
    x, normal, tint, diff = _dir_glue(heads, dirs, per_ray, noise, ide_level,
                                      use_srgb, ws[0].dtype)
    acts = _dir_trunk(ws, x)
    rgb = _dir_tail(_dense(acts[7], ws[17], ws[18]), tint, diff, use_srgb)
    return rgb, normal, heads[:, 1].contiguous(), acts


def ref_dir_plain(ws, heads: torch.Tensor, dirs: torch.Tensor, per_ray: int,
                  noise=None, ide_level: int = 4, use_srgb: bool = False):
    """``_dir_glue_pure_rowland`` (recurrence IDE) in plain PyTorch:
    (rgb (N, 3), normal (N, 3), density (N,)) f32."""
    return ref_dir_fwd_res_plain(ws, heads, dirs, per_ray, noise, ide_level,
                                 use_srgb)[:3]


def _tiled_dxw(a, delta, tile: int, cd):
    """a^T delta (M, K) summed in f32 over blocks of ``tile`` rows, each
    block's product rounded to ``cd`` first (the per-grid-step ``.astype(cd)``
    of ref_fused.py:779-792, :992-1005)."""
    pad = (-a.shape[0]) % tile
    a = F.pad(a.to(F32), (0, 0, 0, pad)).reshape(-1, tile, a.shape[1])
    d = F.pad(delta.to(F32), (0, 0, 0, pad)).reshape(-1, tile,
                                                     delta.shape[1])
    return torch.bmm(a.transpose(1, 2), d).to(cd).to(F32).sum(0)


def ref_spa_bwd_plain(ws, enc, g_heads, acts, tile: int = TILE):
    """``_make_spa_bwd_res_kernel`` (:729-796) in plain PyTorch, cast for
    cast: the 23 f32 grads of the spatial tuple from the heads' cotangent
    g_heads (N, 11 + NB) f32 and the stored activations."""
    return _spa_bwd(ws, enc, g_heads, acts, tile, recompute=False)


def ref_spa_bwd_recompute_plain(ws, enc, g_heads, tile: int = TILE,
                                acts=None):
    """``_make_spa_bwd_kernel`` (:701-721) in plain PyTorch: the forward
    recomputed, then the 23 f32 grads as ``jax.vjp`` takes them through
    ``_cd_matmul_rules``: d(inter) summed as (bn + nct) + rt, the heads'
    bias grads from the f32 cotangent.  ``acts`` gives the 8 activations
    instead of the recomputed ones (the card's checks pass the kernel's
    own, as for ``vanilla_mlp_bwd_recompute_plain``)."""
    if acts is None:
        acts, _ = _spa_forward(ws, enc)
    return _spa_bwd(ws, enc, g_heads, acts, tile, recompute=True)


def _spa_bwd(ws, enc, g_heads, acts, tile: int, recompute: bool):
    return grads_of_jobs(
        ref_spa_wgrad_jobs(ws, enc, g_heads, acts, recompute),
        lambda a, d: _tiled_dxw(a, d, tile, enc.dtype))


def ref_spa_wgrad_jobs(ws, enc, g_heads, acts, recompute: bool = False):
    """The deltas of ``ref_spa_bwd_plain`` (``recompute``:
    ``ref_spa_bwd_recompute_plain``) as its 12 weight-grad jobs
    (csrc/ref_fused_bwd.cu:286-297, ref_fused_recompute.cu:185-195).  The
    heads' jobs take the compute-dtype cotangent, or in the recompute form
    the f32 cotangent's columns, strided views of g_heads: rounded for the
    product, summed unrounded for the bias (jax.vjp's rule)."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     w7, b7, wrt, brt, wnct, bnct, wbn, bbn) = ws
    h1, h2, h3, h4, z5, z6, z7, inter = acts
    cd = enc.dtype
    g = g_heads.to(F32)
    g_rt, g_nct, g_bn = g[:, :2].to(cd), g[:, 2:11].to(cd), g[:, 11:].to(cd)
    p_rt, p_nct, p_bn = (_dwt(g_rt, wrt).to(cd), _dwt(g_nct, wnct).to(cd),
                         _dwt(g_bn, wbn).to(cd))
    d_inter = (p_bn + p_nct) + p_rt if recompute else (p_rt + p_nct) + p_bn
    d8 = _mask(inter, d_inter, cd)
    d7 = _mask(z7, _dwt(d8, w7), cd)
    d6 = _mask(z6, _dwt(d7, w6), cd)
    d5 = _mask(z5, _dwt(d6, w5), cd)
    d4 = _mask(h4, _dwt(d5, w4b), cd)
    d3 = _mask(h3, _dwt(d4, w3), cd)
    d2 = _mask(h2, _dwt(d3, w2), cd)
    d1 = _mask(h1, _dwt(d2, w1), cd)
    heads = ((g[:, :2], g[:, 2:11], g[:, 11:]) if recompute
             else (g_rt, g_nct, g_bn))
    return [(enc, d1, True), (h1, d2, True), (h2, d3, True), (h3, d4, True),
            (enc, d5, False), (h4, d5, True), (z5, d6, True), (z6, d7, True),
            (z7, d8, True)] + [(inter, gh, True) for gh in heads]


def ref_dir_bwd_recompute_plain(ws, heads, dirs, per_ray, noise, g_rgb,
                                g_normal, g_density, ide_level: int = 4,
                                use_srgb: bool = False, tile: int = TILE,
                                acts=None):
    """``_make_dir_bwd_kernel`` (:867-898) in plain PyTorch: the glue and
    the trunk recomputed, then ``ref_dir_bwd_plain`` on their activations
    (``jax.vjp`` through the recompute form sums as the residual kernel
    does).  ``acts`` gives the 8 trunk activations instead (the card's
    checks pass the kernel's own)."""
    if acts is None:
        x = _dir_glue(heads.to(F32), dirs, per_ray, noise, ide_level,
                      use_srgb, ws[0].dtype)[0]
        acts = _dir_trunk(ws, x)
    return ref_dir_bwd_plain(ws, heads, dirs, per_ray, noise, g_rgb,
                             g_normal, g_density, acts, ide_level, use_srgb,
                             tile)


def ref_dir_bwd_plain(ws, heads, dirs, per_ray, noise, g_rgb, g_normal,
                      g_density, acts, ide_level: int = 4,
                      use_srgb: bool = False, tile: int = TILE):
    """``_make_dir_bwd_res_kernel`` (:901-1009) in plain PyTorch: (d(heads)
    (N, 11 + NB) f32, the 19 f32 grads of the directional tuple) from the
    cotangents g_rgb, g_normal (N, 3) and g_density (N,) f32 and the stored
    activations.  The trunk's chain rule is written cast for cast; the f32
    rgb tail and glue are differentiated by autograd."""
    dheads, jobs = ref_dir_wgrad_jobs(ws, heads, dirs, per_ray, noise, g_rgb,
                                      g_normal, g_density, acts, ide_level,
                                      use_srgb)
    return dheads, grads_of_jobs(
        jobs, lambda a, d: _tiled_dxw(a, d, tile, ws[0].dtype))


def ref_dir_wgrad_jobs(ws, heads, dirs, per_ray, noise, g_rgb, g_normal,
                       g_density, acts, ide_level: int = 4,
                       use_srgb: bool = False):
    """(d(heads), the 10 weight-grad jobs) of ``ref_dir_bwd_plain``
    (csrc/ref_fused_bwd.cu:344-353); the logit's delta stays f32."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     w7, b7, wh, bh) = ws
    h1, h2, h3, h4, z5, z6, z7, z8 = acts
    cd = w0.dtype
    with torch.enable_grad():
        hv = heads.to(F32).detach().requires_grad_()
        x, normal, tint, diff = _dir_glue(hv, dirs, per_ray, noise,
                                          ide_level, use_srgb, cd)
        logit = _dense(z8, wh, bh).requires_grad_()
        tail_in = (logit, tint.detach().requires_grad_(),
                   diff.detach().requires_grad_())
        dlogit, dtint, ddiff = torch.autograd.grad(
            _dir_tail(*tail_in, use_srgb), tail_in, g_rgb.to(F32))
        dlc = dlogit.to(cd)
        d8 = _mask(z8, _dwt(dlc, wh), cd)
        d7 = _mask(z7, _dwt(d8, w7), cd)
        d6 = _mask(z6, _dwt(d7, w6), cd)
        d5 = _mask(z5, _dwt(d6, w5), cd)
        d4 = _mask(h4, _dwt(d5, w4b), cd)
        d3 = _mask(h3, _dwt(d4, w3), cd)
        d2 = _mask(h2, _dwt(d3, w2), cd)
        d1 = _mask(h1, _dwt(d2, w1), cd)
        dx = _dwt(d5, w4a).to(cd) + _dwt(d1, w0).to(cd)
        (dheads,) = torch.autograd.grad(
            (x, normal, tint, diff), hv, (dx, g_normal.to(F32), dtint, ddiff))
    dheads = dheads.clone()
    dheads[:, 1] += g_density.to(F32)
    x = x.detach()
    return dheads, [
        (x, d1, True), (h1, d2, True), (h2, d3, True), (h3, d4, True),
        (x, d5, False), (h4, d5, True), (z5, d6, True), (z6, d7, True),
        (z7, d8, True), (z8, dlogit, True)]


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


def _check_dir(ws, heads, dirs, per_ray, noise, ide_level, dev):
    """The directional kernels' operand checks: (n, nb, h, o, l_max, n_ch,
    cd)."""
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
    return n, nb, h, o, l_max, n_ch, cd


def _check_acts(acts, n, widths, cd, dev):
    if len(acts) != N_REF_ACTS:
        raise ValueError(f"expected {N_REF_ACTS} activations, "
                         f"got {len(acts)}")
    for i, (a, w) in enumerate(zip(acts, widths)):
        check_tensor(a, (n, w), cd, dev, f"activation {i}")


def _splits(n: int, tile: int) -> int:
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    return max(1, math.ceil(n / tile))


@functools.lru_cache(maxsize=None)
def _ide_operands(ide_level: int, device: torch.device):
    """The IDE tables ``mat`` (l_max+1, C) and ``sigma`` (C,), f32 on
    ``device``."""
    tables = ide_tables(ide_level)
    return (torch.as_tensor(tables["mat"], device=device).contiguous(),
            torch.as_tensor(tables["sigma"], device=device).contiguous())


@functools.lru_cache(maxsize=None)
def _pe_operands(levels: int, device: torch.device):
    """``pe_tables(levels, 3)`` as f32 tensors on ``device``."""
    return tuple(torch.as_tensor(t, device=device).contiguous()
                 for t in pe_tables(levels, 3))


register({
    "ref_spa_fwd": ("ref_fused", [PTR, U64P, I64, INTP, PTR, INTP]),
    "ref_dir_fwd": ("ref_fused", [PTR, PTR, PTR, I64, PTR, PTR, U64P, I64,
                                  INTP, PTR, PTR, PTR, INTP]),
    "ref_spa_fwd_res": ("ref_fused", [PTR, PTR, PTR, PTR, U64P, I64, INTP,
                                      PTR, PTR, U64P, INTP]),
    "ref_dir_fwd_res": ("ref_fused", [PTR, PTR, PTR, I64, PTR, PTR, U64P,
                                      I64, INTP, PTR, PTR, PTR, U64P, INTP]),
    "ref_spa_bwd": ("ref_fused_bwd", [PTR, PTR, U64P, U64P, I64, INTP, U64P,
                                      PTR, INT, I64, U64P, INTP]),
    "ref_dir_bwd": ("ref_fused_bwd", [PTR, PTR, PTR, I64, PTR, PTR, PTR, PTR,
                                      PTR, U64P, U64P, I64, INTP, PTR, U64P,
                                      PTR, PTR, PTR, INT, I64, U64P]),
    "ref_spa_fwd_grad": ("ref_fused", [PTR, PTR, PTR, PTR, U64P, I64, INTP,
                                       PTR, PTR, INTP]),
    "ref_spa_bwd_recompute": ("ref_fused_recompute", [
        PTR, PTR, U64P, I64, INTP, U64P, U64P, PTR, I64, I64, U64P, INTP]),
    "ref_dir_bwd_recompute": ("ref_fused_recompute", [
        PTR, PTR, PTR, I64, PTR, PTR, PTR, PTR, PTR, U64P, I64, INTP, PTR,
        U64P, U64P, PTR, PTR, PTR, I64, I64, U64P]),
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
        body = ctypes.c_int(-1)
        launch("ref_spa_fwd", enc.dtype, enc.device, enc.data_ptr(),
               pointers(ws), n, dims, heads.data_ptr(), ctypes.byref(body))
        count_body("ref_spa_fwd", spa_body_name(body.value, "eval"))
    return heads


def ref_spa_fwd_res(ws, enc: torch.Tensor, pos: torch.Tensor, device=None):
    """The spatial training forward: (heads (N, 11 + NB) f32, the detached
    normal target (N, 3) f32, the 8 activations h1 h2 h3 h4 z5 z6 z7 inter
    (N, H or O) in enc's dtype).  ``pos`` (N, 3) f32 are the points whose
    encoding ``enc`` is ([pos, PE(pos)]).  On the CPU this is
    ``ref_spa_fwd_res_plain``."""
    return _spa_train_fwd(ws, enc, pos, device, store=True)


def ref_spa_fwd_grad(ws, enc: torch.Tensor, pos: torch.Tensor, device=None):
    """The spatial training forward of the recompute form: (heads, the
    detached normal target), as ``ref_spa_fwd_res`` gives them, and no
    activations.  On the CPU this is ``ref_spa_fwd_grad_plain``."""
    return _spa_train_fwd(ws, enc, pos, device, store=False)


def _spa_train_fwd(ws, enc, pos, device, store: bool):
    dev = resolve_device(device)
    check_operands(ws, (enc,), N_REF_SPA_WS, REF_SPA_BIASES, dev)
    n, dx, h, o, nb = _spa_dims(ws, enc)
    if (dx - 3) % 6:
        raise ValueError(f"enc width {dx} is not [pos 3 | PE 6 L]")
    check_tensor(pos, (n, 3), F32, dev, "pos")
    if dev.type == "cpu":
        out = ref_spa_fwd_res_plain(ws, enc, pos)
        return out if store else out[:2]
    like = dict(device=enc.device)
    heads = torch.empty((n, HEAD_FIXED + nb), dtype=F32, **like)
    dgrad = torch.empty((n, 3), dtype=F32, **like)
    acts = tuple(torch.empty((n, w), dtype=enc.dtype, **like)
                 for w in (h,) * 7 + (o,)) if store else ()
    if n > 0:
        pe_w, pe_b = _pe_operands((dx - 3) // 6, enc.device)
        dims = (ctypes.c_int * 4)(dx, h, o, nb)
        extra = (pointers(acts),) if store else ()
        body = ctypes.c_int(-1)
        name = "ref_spa_fwd_res" if store else "ref_spa_fwd_grad"
        launch(name, enc.dtype, enc.device, enc.data_ptr(), pos.data_ptr(),
               pe_w.data_ptr(), pe_b.data_ptr(), pointers(ws), n, dims,
               heads.data_ptr(), dgrad.data_ptr(), *extra,
               ctypes.byref(body))
        count_body(name, spa_body_name(body.value,
                                       "res" if store else "grad"))
    return (heads, dgrad, acts) if store else (heads, dgrad)


def spa_body_name(cons: int, form: str) -> str:
    """The name of the body that a spatial forward of ``form`` ("eval":
    ``ref_spa_fwd``, "res": ``ref_spa_fwd_res``, "grad":
    ``ref_spa_fwd_grad``) ran, from what its C entry reports:
    "spa_frame_kernel<form> x2" (the frame, two consumer warpgroups,
    128-point tiles), "x1" (one, 64-point tiles) or, for 0, the 64-row tile
    (f32, and bf16 where no frame fits): "ref_spa_fwd_kernel",
    "ref_spa_fwd_res_kernel<true>" (res) or "<false>" (grad)."""
    if cons == 0:
        return {"eval": "ref_spa_fwd_kernel",
                "res": "ref_spa_fwd_res_kernel<true>",
                "grad": "ref_spa_fwd_res_kernel<false>"}[form]
    return f"spa_frame_kernel<{form}> x{cons}"


def _dir_fwd(ws, heads, dirs, per_ray, noise, ide_level, use_srgb, device,
             res: bool):
    dev = resolve_device(device)
    n, nb, h, o, l_max, n_ch, cd = _check_dir(ws, heads, dirs, per_ray,
                                              noise, ide_level, dev)
    if dev.type == "cpu":
        out = ref_dir_fwd_res_plain(ws, heads, dirs, per_ray, noise,
                                    ide_level, use_srgb)
        return out if res else out[:3]
    like = dict(dtype=F32, device=heads.device)
    rgb, normal = torch.empty((n, 3), **like), torch.empty((n, 3), **like)
    density = torch.empty(n, **like)
    acts = tuple(torch.empty((n, w), dtype=cd, device=heads.device)
                 for w in (h,) * 6 + (o, o)) if res else ()
    if n > 0:
        mat, sigma = _ide_operands(ide_level, heads.device)
        dims = (ctypes.c_int * 6)(nb, h, o, l_max, n_ch, int(use_srgb))
        extra = (pointers(acts),) if res else ()
        body = ctypes.c_int(-1)
        name = "ref_dir_fwd_res" if res else "ref_dir_fwd"
        launch(name, cd, heads.device, heads.data_ptr(),
               None if noise is None else noise.data_ptr(), dirs.data_ptr(),
               per_ray, mat.data_ptr(), sigma.data_ptr(), pointers(ws), n,
               dims, rgb.data_ptr(), normal.data_ptr(), density.data_ptr(),
               *extra, ctypes.byref(body))
        count_body(name, dir_body_name(body.value, res))
    return (rgb, normal, density, acts) if res else (rgb, normal, density)


def dir_body_name(cons: int, res: bool) -> str:
    """The name of the body that a ``ref_dir_fwd`` (``ref_dir_fwd_res``
    with ``res``) launch ran, from what its C entry reports:
    "dir_frame_kernel<eval|res> x2" (the frame, two consumer warpgroups,
    128-point tiles), "x1" (one, 64-point tiles) or, for 0,
    "ref_dir_fwd_kernel" (the 64-row tile: f32, and bf16 where no frame
    fits)."""
    if cons == 0:
        return "ref_dir_fwd_kernel"
    return f"dir_frame_kernel<{'res' if res else 'eval'}> x{cons}"


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
    return _dir_fwd(ws, heads, dirs, per_ray, noise, ide_level, use_srgb,
                    device, res=False)


def ref_dir_fwd_res(ws, heads: torch.Tensor, dirs: torch.Tensor,
                    per_ray: int, noise=None, ide_level: int = 4,
                    use_srgb: bool = False, device=None):
    """The directional training forward: ``ref_dir_fwd``'s outputs and the 8
    activations h1 h2 h3 h4 z5 z6 (N, H) z7 z8 (N, O) in the compute dtype.
    On the CPU this is ``ref_dir_fwd_res_plain``."""
    return _dir_fwd(ws, heads, dirs, per_ray, noise, ide_level, use_srgb,
                    device, res=True)


def ref_spa_bwd(ws, enc: torch.Tensor, g_heads: torch.Tensor, acts,
                tile: int = TILE, device=None):
    """Fused Ref-NeRF spatial backward over stored activations: the 23 f32
    grads of the spatial tuple from the heads' cotangent g_heads (N, 11 +
    NB) f32; each ``tile`` rows' weight grad is rounded to the compute
    dtype before the sum over tiles.  On the CPU this is
    ``ref_spa_bwd_plain``."""
    dev = resolve_device(device)
    check_operands(ws, (enc,), N_REF_SPA_WS, REF_SPA_BIASES, dev)
    n, dx, h, o, nb = _spa_dims(ws, enc)
    cd = enc.dtype
    _check_acts(acts, n, (h,) * 7 + (o,), cd, dev)
    check_tensor(g_heads, (n, HEAD_FIXED + nb), F32, dev, "g_heads")
    _splits(n, tile)                       # raises on a tile below 1
    if dev.type == "cpu":
        return ref_spa_bwd_plain(ws, enc, g_heads, acts, tile)
    return _spa_bwd_launch(ws, enc, g_heads, acts, tile)[0]


def _spa_bwd_launch(ws, enc, g_heads, acts, tile: int):
    """Launch ``ref_spa_bwd`` on checked CUDA operands with the scratch its
    delta pass writes: (the 23 grads, that scratch: d1 .. d7 (N, H), d8
    (N, O), then g_rt, g_nct and g_bn rounded to the compute dtype)."""
    n, dx, h, o, nb = _spa_dims(ws, enc)
    cd = enc.dtype
    like = dict(device=enc.device)
    deltas = tuple(torch.empty((n, w), dtype=cd, **like)
                   for w in (h,) * 7 + (o, 2, 9, nb))
    splits = _splits(n, tile)
    partial = torch.empty(splits * sum(w.numel() for w in ws), dtype=F32,
                          **like)
    grads = tuple(torch.empty(w.shape, dtype=F32, **like) for w in ws)
    dims = (ctypes.c_int * 4)(dx, h, o, nb)
    body = ctypes.c_int(-1)
    launch("ref_spa_bwd", cd, enc.device, enc.data_ptr(), g_heads.data_ptr(),
           pointers(acts), pointers(ws), n, dims, pointers(deltas),
           partial.data_ptr(), splits, tile, pointers(grads),
           ctypes.byref(body))
    count_body("ref_spa_bwd", spa_bwd_body_name(body.value, "res"))
    return grads, deltas


def spa_bwd_body_name(cons: int, form: str) -> str:
    """The name of the body that ran the delta pass of a spatial backward of
    ``form`` ("res": ``ref_spa_bwd``, "recompute":
    ``ref_spa_bwd_recompute``), from what its C entry reports:
    "spa_bwd_frame_kernel<form> x2" (the frame, two consumer warpgroups,
    128-point tiles), "x1" (one, 64-point tiles) or, for 0, the 64-row
    tile (f32, and bf16 where no frame fits): "ref_spa_delta_kernel" (res)
    or "ref_spa_recompute_kernel" (recompute)."""
    if cons == 0:
        return {"res": "ref_spa_delta_kernel",
                "recompute": "ref_spa_recompute_kernel"}[form]
    return f"spa_bwd_frame_kernel<{form}> x{cons}"


def ref_dir_bwd(ws, heads: torch.Tensor, dirs: torch.Tensor, per_ray: int,
                noise, g_rgb: torch.Tensor, g_normal: torch.Tensor,
                g_density: torch.Tensor, acts, ide_level: int = 4,
                use_srgb: bool = False, tile: int = TILE, device=None):
    """Fused Ref-NeRF directional backward over stored activations: (d(heads)
    (N, 11 + NB) f32, the 19 f32 grads of the directional tuple) from the
    f32 cotangents g_rgb, g_normal (N, 3) and g_density (N,).  The other
    operands are ``ref_dir_fwd_res``'s.  On the CPU this is
    ``ref_dir_bwd_plain``."""
    dev = resolve_device(device)
    n, nb, h, o, l_max, n_ch, cd = _check_dir(ws, heads, dirs, per_ray,
                                              noise, ide_level, dev)
    _check_acts(acts, n, (h,) * 6 + (o, o), cd, dev)
    check_tensor(g_rgb, (n, 3), F32, dev, "g_rgb")
    check_tensor(g_normal, (n, 3), F32, dev, "g_normal")
    check_tensor(g_density, (n,), F32, dev, "g_density")
    splits = _splits(n, tile)
    if dev.type == "cpu":
        return ref_dir_bwd_plain(ws, heads, dirs, per_ray, noise, g_rgb,
                                 g_normal, g_density, acts, ide_level,
                                 use_srgb, tile)
    like = dict(device=heads.device)
    dd = nb + 2 * n_ch + 1
    x = torch.empty((n, dd), dtype=cd, **like)          # the trunk input
    # d1 .. d6 (H), d7 d8 (O) in the compute dtype
    deltas = tuple(torch.empty((n, w), dtype=cd, **like)
                   for w in (h,) * 6 + (o, o))
    dlogit = torch.empty((n, 3), dtype=F32, **like)
    dheads = torch.empty_like(heads)
    partial = torch.empty(splits * sum(w.numel() for w in ws), dtype=F32,
                          **like)
    grads = tuple(torch.empty(w.shape, dtype=F32, **like) for w in ws)
    mat, sigma = _ide_operands(ide_level, heads.device)
    dims = (ctypes.c_int * 6)(nb, h, o, l_max, n_ch, int(use_srgb))
    launch("ref_dir_bwd", cd, heads.device, heads.data_ptr(),
           None if noise is None else noise.data_ptr(), dirs.data_ptr(),
           per_ray, mat.data_ptr(), sigma.data_ptr(), g_rgb.data_ptr(),
           g_normal.data_ptr(), g_density.data_ptr(), pointers(acts),
           pointers(ws), n, dims, x.data_ptr(), pointers(deltas),
           dlogit.data_ptr(), dheads.data_ptr(), partial.data_ptr(), splits,
           tile, pointers(grads))
    return dheads, grads


def ref_spa_bwd_recompute(ws, enc: torch.Tensor, g_heads: torch.Tensor,
                          tile: int = TILE, device=None):
    """Fused Ref-NeRF spatial backward in the recompute form: the 23 f32
    grads of the spatial tuple from enc and the heads' cotangent g_heads
    (N, 11 + NB) f32 alone, each ``tile`` rows' weight grad rounded to the
    compute dtype.  The points are walked in chunks of whole tiles
    (``fused_mlp.chunk_rows``), each chunk's activations and deltas in
    scratch of the chunk's size; the grads do not depend on the chunk size.
    On the CPU this is ``ref_spa_bwd_recompute_plain``."""
    dev = resolve_device(device)
    check_operands(ws, (enc,), N_REF_SPA_WS, REF_SPA_BIASES, dev)
    n, dx, h, o, nb = _spa_dims(ws, enc)
    check_tensor(g_heads, (n, HEAD_FIXED + nb), F32, dev, "g_heads")
    _splits(n, tile)                       # raises on a tile below 1
    if dev.type == "cpu":
        return ref_spa_bwd_recompute_plain(ws, enc, g_heads, tile)
    return _spa_bwd_recompute_launch(ws, enc, g_heads, tile)[0]


def _spa_bwd_recompute_launch(ws, enc, g_heads, tile: int):
    """Launch ``ref_spa_bwd_recompute`` on checked CUDA operands with the
    chunk-sized scratch it walks the points in: (the 23 grads, the
    scratch's 8 activations h1 .. inter and 8 deltas d1 .. d8, each
    min(N, chunk_rows(tile)) rows, which then hold the last chunk's first
    rows)."""
    n, dx, h, o, nb = _spa_dims(ws, enc)
    splits = _splits(n, tile)
    chunk = chunk_rows(tile)
    like = dict(dtype=enc.dtype, device=enc.device)
    m = min(n, chunk)
    widths = (h,) * 7 + (o,)
    acts = tuple(torch.empty((m, w), **like) for w in widths)
    deltas = tuple(torch.empty((m, w), **like) for w in widths)
    partial = torch.empty(min(splits, chunk // tile)
                          * sum(w.numel() for w in ws), dtype=F32,
                          device=enc.device)
    grads = tuple(torch.empty(w.shape, dtype=F32, device=enc.device)
                  for w in ws)
    dims = (ctypes.c_int * 4)(dx, h, o, nb)
    body = ctypes.c_int(-1)
    launch("ref_spa_bwd_recompute", enc.dtype, enc.device, enc.data_ptr(),
           g_heads.data_ptr(), pointers(ws), n, dims, pointers(acts),
           pointers(deltas), partial.data_ptr(), tile, chunk,
           pointers(grads), ctypes.byref(body))
    count_body("ref_spa_bwd_recompute",
               spa_bwd_body_name(body.value, "recompute"))
    return grads, acts, deltas


def ref_dir_bwd_recompute(ws, heads: torch.Tensor, dirs: torch.Tensor,
                          per_ray: int, noise, g_rgb: torch.Tensor,
                          g_normal: torch.Tensor, g_density: torch.Tensor,
                          ide_level: int = 4, use_srgb: bool = False,
                          tile: int = TILE, device=None):
    """Fused Ref-NeRF directional backward in the recompute form:
    ``ref_dir_bwd``'s (d(heads), 19 f32 grads) from the forward's operands
    and the f32 cotangents alone, walked in chunks as
    ``ref_spa_bwd_recompute`` is.  On the CPU this is
    ``ref_dir_bwd_recompute_plain``."""
    dev = resolve_device(device)
    n = check_dir_bwd_operands(ws, heads, dirs, per_ray, noise, g_rgb,
                               g_normal, g_density, ide_level, dev)[0]
    _splits(n, tile)                       # raises on a tile below 1
    if dev.type == "cpu":
        return ref_dir_bwd_recompute_plain(ws, heads, dirs, per_ray, noise,
                                           g_rgb, g_normal, g_density,
                                           ide_level, use_srgb, tile)
    return launch_dir_bwd_recompute(
        "ref_dir_bwd_recompute", (), ws, heads, dirs, per_ray, noise, g_rgb,
        g_normal, g_density, ide_level, use_srgb, tile)


def check_dir_bwd_operands(ws, heads, dirs, per_ray, noise, g_rgb, g_normal,
                           g_density, ide_level, dev):
    """The operand checks of the recompute-form directional backward:
    (n, nb, h, o, l_max, n_ch, cd)."""
    dims = _check_dir(ws, heads, dirs, per_ray, noise, ide_level, dev)
    n = dims[0]
    check_tensor(g_rgb, (n, 3), F32, dev, "g_rgb")
    check_tensor(g_normal, (n, 3), F32, dev, "g_normal")
    check_tensor(g_density, (n,), F32, dev, "g_density")
    return dims


def launch_dir_bwd_recompute(name, lead, ws, heads, dirs, per_ray, noise,
                             g_rgb, g_normal, g_density, ide_level, use_srgb,
                             tile):
    """Launch kernel ``name`` (``ref_dir_bwd_recompute``, or a mode of its
    dissection with the C arguments ``lead`` before the common ones) on
    checked CUDA operands, with the chunk-sized scratch it walks the points
    in: (d(heads), the 19 f32 grads)."""
    n, nb, h, o, l_max, n_ch, cd = _check_dir(ws, heads, dirs, per_ray, noise,
                                              ide_level, heads.device)
    splits = _splits(n, tile)
    chunk = chunk_rows(tile)
    like = dict(dtype=cd, device=heads.device)
    m = min(n, chunk)
    x = torch.empty((m, nb + 2 * n_ch + 1), **like)    # the trunk input
    widths = (h,) * 6 + (o, o)
    acts = tuple(torch.empty((m, w), **like) for w in widths)
    deltas = tuple(torch.empty((m, w), **like) for w in widths)
    dlogit = torch.empty((m, 3), dtype=F32, device=heads.device)
    dheads = torch.empty_like(heads)
    partial = torch.empty(min(splits, chunk // tile)
                          * sum(w.numel() for w in ws), dtype=F32,
                          device=heads.device)
    grads = tuple(torch.empty(w.shape, dtype=F32, device=heads.device)
                  for w in ws)
    mat, sigma = _ide_operands(ide_level, heads.device)
    dims = (ctypes.c_int * 6)(nb, h, o, l_max, n_ch, int(use_srgb))
    launch(name, cd, heads.device, *lead, heads.data_ptr(),
           None if noise is None else noise.data_ptr(), dirs.data_ptr(),
           per_ray, mat.data_ptr(), sigma.data_ptr(), g_rgb.data_ptr(),
           g_normal.data_ptr(), g_density.data_ptr(), pointers(ws), n, dims,
           x.data_ptr(), pointers(acts), pointers(deltas), dlogit.data_ptr(),
           dheads.data_ptr(), partial.data_ptr(), tile, chunk,
           pointers(grads))
    return dheads, grads


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


# ---------------------------------------------------------------------------
# autograd (the custom_vjp of _make_spa_fused / _make_dir_fused)
# ---------------------------------------------------------------------------

class RefSpatialMLP(torch.autograd.Function):
    """(device, tile, enc, pos, *ws) -> (heads (N, 11 + NB), normal target
    (N, 3)) through ``ref_spa_fwd_res``; the backward is ``ref_spa_bwd``
    with weight grads rounded per ``tile`` rows.

    ``ws`` are the 23 f32 parameters, cast inside to enc's dtype, so the
    f32 grads reach them unrounded.  The normal target is a detached
    constant (no gradient flows through it); enc and pos get none either.
    """

    @staticmethod
    def forward(ctx, device, tile, enc, pos, *ws):
        wsc = prep_weights(ws, REF_SPA_BIASES, enc.dtype)
        heads, dgrad, acts = ref_spa_fwd_res(wsc, enc, pos, device=device)
        ctx.device, ctx.tile = device, tile
        ctx.save_for_backward(enc, *acts, *wsc)
        ctx.mark_non_differentiable(dgrad)
        return heads, dgrad

    @staticmethod
    def backward(ctx, g_heads, _):
        enc, *rest = ctx.saved_tensors
        acts, wsc = rest[:N_REF_ACTS], rest[N_REF_ACTS:]
        grads = ref_spa_bwd(wsc, enc, g_heads.to(F32).contiguous(), acts,
                            tile=ctx.tile, device=ctx.device)
        return (None, None, None, None, *grads)


class RefDirectionalMLP(torch.autograd.Function):
    """(device, tile, heads, dirs, noise, per_ray, ide_level, use_srgb, cd,
    *ws) -> (rgb (N, 3), normal (N, 3), raw density (N,)) through
    ``ref_dir_fwd_res``; the backward is ``ref_dir_bwd``, whose d(heads)
    flows on into ``RefSpatialMLP``'s backward.

    ``ws`` are the 19 f32 parameters, cast inside to the compute dtype
    ``cd``; ``noise`` is the already scaled bottleneck perturbation in
    ``cd``, or None.  dirs and noise get no gradient.
    """

    @staticmethod
    def forward(ctx, device, tile, heads, dirs, noise, per_ray, ide_level,
                use_srgb, cd, *ws):
        wsc = prep_weights(ws, REF_DIR_BIASES, cd)
        rgb, normal, density, acts = ref_dir_fwd_res(
            wsc, heads, dirs, per_ray, noise, ide_level, use_srgb,
            device=device)
        ctx.device, ctx.tile = device, tile
        ctx.per_ray, ctx.ide_level, ctx.use_srgb = per_ray, ide_level, \
            use_srgb
        ctx.save_for_backward(heads, dirs, noise, *acts, *wsc)
        return rgb, normal, density

    @staticmethod
    def backward(ctx, g_rgb, g_normal, g_density):
        heads, dirs, noise, *rest = ctx.saved_tensors
        acts, wsc = rest[:N_REF_ACTS], rest[N_REF_ACTS:]
        dheads, grads = ref_dir_bwd(
            wsc, heads, dirs, ctx.per_ray, noise,
            *(g.to(F32).contiguous() for g in (g_rgb, g_normal, g_density)),
            acts, ctx.ide_level, ctx.use_srgb, tile=ctx.tile,
            device=ctx.device)
        return (None, None, dheads, None, None, None, None, None, None,
                *grads)


class RefSpatialMLPRecompute(torch.autograd.Function):
    """``RefSpatialMLP`` in the recompute form (``store_residuals=False``,
    and the spatial half of ``ref_kernels="hybrid"``): the forward is
    ``ref_spa_fwd_grad`` and saves what ``_make_spa_fused``'s ``fused_fwd``
    keeps then (ref_fused.py:1081-1085), the weights and enc; the backward
    is ``ref_spa_bwd_recompute``."""

    @staticmethod
    def forward(ctx, device, tile, enc, pos, *ws):
        wsc = prep_weights(ws, REF_SPA_BIASES, enc.dtype)
        heads, dgrad = ref_spa_fwd_grad(wsc, enc, pos, device=device)
        ctx.device, ctx.tile = device, tile
        ctx.save_for_backward(enc, *wsc)
        ctx.mark_non_differentiable(dgrad)
        return heads, dgrad

    @staticmethod
    def backward(ctx, g_heads, _):
        enc, *wsc = ctx.saved_tensors
        grads = ref_spa_bwd_recompute(wsc, enc, g_heads.to(F32).contiguous(),
                                      tile=ctx.tile, device=ctx.device)
        return (None, None, None, None, *grads)


class RefDirectionalMLPRecompute(torch.autograd.Function):
    """``RefDirectionalMLP`` in the recompute form: the forward is
    ``ref_dir_fwd`` (with the noise) and saves what ``_make_dir_fused``'s
    ``fused_fwd`` keeps (ref_fused.py:1192-1194), the weights and the
    inputs; the backward is ``ref_dir_bwd_recompute``."""

    @staticmethod
    def forward(ctx, device, tile, heads, dirs, noise, per_ray, ide_level,
                use_srgb, cd, *ws):
        wsc = prep_weights(ws, REF_DIR_BIASES, cd)
        rgb, normal, density = ref_dir_fwd(wsc, heads, dirs, per_ray, noise,
                                           ide_level, use_srgb, device=device)
        ctx.device, ctx.tile = device, tile
        ctx.per_ray, ctx.ide_level, ctx.use_srgb = per_ray, ide_level, \
            use_srgb
        ctx.save_for_backward(heads, dirs, noise, *wsc)
        return rgb, normal, density

    @staticmethod
    def backward(ctx, g_rgb, g_normal, g_density):
        heads, dirs, noise, *wsc = ctx.saved_tensors
        dheads, grads = ref_dir_bwd_recompute(
            wsc, heads, dirs, ctx.per_ray, noise,
            *(g.to(F32).contiguous() for g in (g_rgb, g_normal, g_density)),
            ctx.ide_level, ctx.use_srgb, tile=ctx.tile, device=ctx.device)
        return (None, None, dheads, None, None, None, None, None, None,
                *grads)
