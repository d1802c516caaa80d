"""The forward layer tile of the fused kernels on its own.

Every fused kernel runs its hidden layers, and the recompute backwards their
rebuild, through one device function (``dense_tile``, ``csrc/mlp_tile.cuh``):
out = act(a0 @ w0 [+ a1 @ w1] + b), rounded to the compute dtype, over a tile
of 64 rows in shared memory; the *_fwd_res kernels also store the rows, and
``ref_spa_fwd_grad`` keeps the ReLU mask as bits.  ``dense_layer``
(``csrc/dense.cu``) runs that tile alone over n rows, so that it can be held
against its plain version and timed at the fused kernels' layer shapes;
nothing on the training or render path calls this entry.

Replaces: the layer math of the Pallas kernels, ``_relu(_dense(h, w,
b)).astype(cd)`` (nerf_tpu/ops/fused_mlp.py:58, :101-116).

Numerics: a0, a1 and the matrices in the compute dtype (f32 or bf16), the
bias f32; the products accumulate in f32 (bf16 operands on the tensor cores,
f32 on the CUDA cores in full f32), the bias is added in f32, then the ReLU
(``relu``) and the cast.  A skip layer sums both products in one f32
accumulator before the bias; the Pallas kernels add two f32 dots, which
differs only in the order of the f32 sums.

Bound by operations on an H100 SXM at widths of 128 and more: 2 n n_out (k0
+ k1) FLOPs against 2 (k0 + k1 + n_out) bytes a row in bf16.

Dispatch as in ``fused_mlp``: a CPU tensor takes ``dense_layer_plain``; a
CUDA tensor launches the kernel or raises.  The bf16 tile takes output
widths that are multiples of 8 only, and the wrapper rejects others on
either device.  ``LAUNCHES["dense_layer"]`` counts this entry's launches
only, not the tiles inside the fused kernels.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_tpu_torch.device import check_device, resolve_device
from nerf_tpu_torch.ops import build
from nerf_tpu_torch.ops.launch import I64, INT, PTR, launch, register

F32 = torch.float32

register({"dense_layer": ("dense", [PTR, INT, PTR, PTR, INT, PTR, PTR, I64,
                                    INT, INT, PTR, PTR, PTR])})


def mask_words(width: int) -> int:
    """32-bit words of a ReLU bit-mask row (csrc/mlp_tile.cuh)."""
    return (width + 31) // 32


def pack_mask(out: torch.Tensor) -> torch.Tensor:
    """(n, mask_words(width)) int32 words of ``out > 0``: bit c % 32 of word
    c // 32 is column c, as the tile's MASK path writes them."""
    n, width = out.shape
    words = mask_words(width)
    on = torch.zeros((n, words * 32), dtype=torch.int64, device=out.device)
    on[:, :width] = (out > 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=out.device)
    packed = (on.view(n, words, 32) << shifts).sum(-1)
    return (packed - (packed >= 2 ** 31).to(torch.int64) * 2 ** 32).to(
        torch.int32)


def dense_layer_plain(a0, w0, b, a1=None, w1=None, relu=True, store=False,
                      mask=False):
    """The layer in plain PyTorch: f32 products of the upcast operands (the
    skip layer's two summed), plus the f32 bias, the ReLU, the cast to a0's
    dtype.  Returns (out, stored, bits): stored a copy of out with
    ``store``, bits ``pack_mask(out)`` with ``mask``, else None."""
    acc = torch.matmul(a0.to(F32), w0.to(F32))
    if a1 is not None:
        acc = acc + torch.matmul(a1.to(F32), w1.to(F32))
    acc = acc + b.reshape(1, -1)
    out = (torch.relu(acc) if relu else acc).to(a0.dtype)
    return (out, out.clone() if store else None,
            pack_mask(out) if mask else None)


def dense_layer_f64(a0, w0, b, a1=None, w1=None, relu=True):
    """The layer summed in f64 (exact for bf16 operands up to a few
    thousand terms) and then rounded: to f32, then to a0's dtype."""
    acc = a0.double() @ w0.double()
    if a1 is not None:
        acc = acc + a1.double() @ w1.double()
    acc = acc + b.double().reshape(1, -1)
    return (torch.relu(acc) if relu else acc).float().to(a0.dtype)


def dense_layer_in_order(a0, w0, b, a1=None, w1=None, relu=True):
    """The layer with its products summed in f32 in the order of k, a0's
    columns then a1's, one rounding per term (a product of two bf16 values
    is exact in f32), then the f32 bias, the ReLU and the cast to a0's
    dtype: the plain sum that the tile's rounding is held against."""
    acc = torch.zeros((a0.shape[0], w0.shape[1]), dtype=F32,
                      device=a0.device)
    for a, w in ((a0, w0), (a1, w1)):
        if a is None:
            continue
        a, w = a.to(F32), w.to(F32)
        for k in range(a.shape[1]):
            acc = acc + a[:, k:k + 1] * w[k:k + 1, :]
    acc = acc + b.reshape(1, -1)
    return (torch.relu(acc) if relu else acc).to(a0.dtype)


def rounding_share(out, exact):
    """The share of ``out``'s values that differ from ``exact``
    (dense_layer_f64's rounded layer)."""
    return float((out != exact).float().mean())


def map_encode_us(w, reps: int = 10_000) -> float:
    """The host's microseconds for one encoding of the TMA tensor map of
    ``w``, a (k, n) bf16 CUDA matrix (the mean of ``reps``): each bf16
    launch of a tile kernel encodes one for every weight that its tiles
    read (``csrc/mlp_tile.cuh``'s ``tile_maps``)."""
    if w.device.type != "cuda" or w.dtype != torch.bfloat16 \
            or w.dim() != 2 or not w.is_contiguous():
        raise ValueError("w must be a contiguous 2-D bf16 CUDA tensor")
    fn = build.load("dense").dense_map_encode_us
    fn.restype = ctypes.c_double
    fn.argtypes = [PTR, INT, INT, INT]
    us = fn(w.data_ptr(), w.shape[0], w.shape[1], reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused the matrix")
    return us


def _check(a0, w0, b, a1, w1, dev):
    """Raise unless the operands are what the kernel takes; returns the
    output width."""
    cd = a0.dtype
    if cd not in (F32, torch.bfloat16):
        raise ValueError(f"a0 must be f32 or bf16, got {cd}")
    pairs = [("a0", a0, "w0", w0)]
    if (a1 is None) != (w1 is None):
        raise ValueError("a1 and w1 come together")
    if a1 is not None:
        pairs.append(("a1", a1, "w1", w1))
    n_out = w0.shape[1] if w0.dim() == 2 else -1
    for an, a, wn, w in pairs:
        check_device(a, dev, an)
        check_device(w, dev, wn)
        if a.dim() != 2 or a.dtype != cd or not a.is_contiguous() \
                or a.shape[0] != a0.shape[0] or a.shape[1] < 1:
            raise ValueError(f"{an} must be a contiguous (n, k) {cd} tensor "
                             f"with k >= 1, got {tuple(a.shape)} {a.dtype}")
        if w.dim() != 2 or w.dtype != cd or not w.is_contiguous() \
                or tuple(w.shape) != (a.shape[1], n_out):
            raise ValueError(f"{wn} must be a contiguous ({a.shape[1]}, "
                             f"{n_out}) {cd} tensor, got {tuple(w.shape)} "
                             f"{w.dtype}")
    check_device(b, dev, "b")
    if b.dtype != F32 or b.numel() != n_out or not b.is_contiguous():
        raise ValueError(f"b must be a contiguous f32 tensor of {n_out} "
                         f"values, got {tuple(b.shape)} {b.dtype}")
    if n_out < 8 or n_out % 8 != 0:
        raise ValueError(f"the output width must be a positive multiple of "
                         f"8, got {n_out}")
    return n_out


def dense_layer(a0, w0, b, a1=None, w1=None, relu=True, store=False,
                mask=False, device=None):
    """One layer through the fused kernels' tile: a0 (n, k0) and, for a
    skip layer, a1 (n, k1) contiguous in the compute dtype, w0 (k0, n_out)
    and w1 (k1, n_out) in that dtype, b n_out f32 values; n_out a multiple
    of 8.  Returns (out, stored, bits): out (n, n_out) in the compute dtype;
    with ``store`` the same rows as the tile's STORE path writes them, else
    None; with ``mask`` the tile's ReLU bits, (n, mask_words(n_out)) int32,
    else None.  On the CPU this is ``dense_layer_plain``."""
    dev = resolve_device(device)
    n_out = _check(a0, w0, b, a1, w1, dev)
    if dev.type == "cpu":
        return dense_layer_plain(a0, w0, b, a1, w1, relu, store, mask)
    n, cd = a0.shape[0], a0.dtype
    like = dict(device=a0.device)
    out = torch.empty((n, n_out), dtype=cd, **like)
    stored = torch.empty((n, n_out), dtype=cd, **like) if store else None
    bits = (torch.empty((n, mask_words(n_out)), dtype=torch.int32, **like)
            if mask else None)
    if n > 0:
        launch("dense_layer", cd, a0.device, a0.data_ptr(), a0.shape[1],
               w0.data_ptr(), a1.data_ptr() if a1 is not None else None,
               a1.shape[1] if a1 is not None else 0,
               w1.data_ptr() if w1 is not None else None, b.data_ptr(), n,
               n_out, int(relu), out.data_ptr(),
               stored.data_ptr() if store else None,
               bits.data_ptr() if mask else None)
    return out, stored, bits
