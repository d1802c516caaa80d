"""The split-K weight-grad pass of the backward kernels on its own.

Every backward kernel of the port ends in the same pass
(``csrc/wgrad.cuh``): for each weight-grad job (A (N, m), delta (N, k),
bias or not), each K-split of ``rows_per_split`` points computes the
partial dW = A^T delta and the bias sums of delta, and an ordered reduction
adds the splits.  ``wgrad_reduce`` (``csrc/wgrad.cu``) runs that pass alone
on a list of jobs, so that it can be held against its plain version and
timed at a backward's exact job lists; the backwards themselves launch it
from C, and nothing on the training path calls this entry.

Replaces: the ``grad_ref[...] += partial`` accumulation of the Pallas
backwards, nerf_tpu/ops/fused_mlp.py:228-237 and
nerf_tpu/ops/ref_fused.py:719, :794, :896.

Numerics: A is in the compute dtype (f32 or bf16); delta in the compute
dtype or in f32, then rounded to the compute dtype for the product and
summed unrounded for the bias.  Products accumulate in f32, per split
(``wgrad_reduce_f64`` and ``wgrad_reduce_in_order`` are the two sums that
the bf16 kernel's summation is held between on the card); with
``round_partial`` each split's weight grad (not the bias) is rounded to the
compute dtype first, as the TPU's per-tile ``.astype(cd)`` of the Ref-NeRF
backwards; the splits are summed in order, onto ``grads`` when given (a
backward that walks its points in chunks of whole splits).  bf16 operands
multiply on the tensor cores, f32 ones on the CUDA cores in full f32.

Bound by bytes on an H100 SXM (3.35 TB/s): the pass reads each operand once
and writes f32 partials, and does 2 m k FLOPs per point and job, far below
the bf16 tensor cores' 295 FLOPs per byte.

Dispatch as in ``fused_mlp``: a CPU tensor takes ``wgrad_reduce_plain``; a
CUDA tensor launches the kernel or raises.  ``LAUNCHES["wgrad_reduce"]``
counts this entry's launches only, not the passes inside the backwards.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nerf_tpu_torch.device import check_device, resolve_device
from nerf_tpu_torch.ops.launch import (
    I64, INT, PTR, U64P, launch, pointers, register,
)

F32 = torch.float32
MAX_JOBS = 16       # csrc/wgrad.cuh
MAX_GRADS = 24
MAX_SPLITS = 65535  # the grid's second dimension

register({"wgrad_reduce": ("wgrad", [U64P, U64P, ctypes.POINTER(I64), INT,
                                     I64, I64, INT, INT, PTR, U64P])})


def _splits(n: int, rows_per_split: int) -> int:
    return max(1, math.ceil(n / rows_per_split))


def grad_shapes(jobs):
    """The grads' shapes, in job order: (m, k) and, with bias, (1, k)."""
    out = []
    for a, d, bias in jobs:
        out.append((a.shape[1], d.shape[1]))
        if bias:
            out.append((1, d.shape[1]))
    return out


def wgrad_reduce_plain(jobs, rows_per_split: int, round_partial=False,
                       grads=None):
    """The pass in plain PyTorch: for each job, f32 products of A and delta
    rounded to A's dtype, split by split (``torch.mm`` on each split's
    rows), each rounded to that dtype with ``round_partial``, summed in
    split order from 0 or from ``grads``; the bias from the unrounded delta.
    Returns the grads in job order, dW (m, k) and db (1, k)."""
    start = iter(grads if grads is not None else [
        torch.zeros(s, dtype=F32, device=jobs[0][0].device)
        for s in grad_shapes(jobs)])
    out = []
    for a, d, bias in jobs:
        cd = a.dtype
        n = a.shape[0]
        w = next(start)
        b = next(start) if bias else None
        for lo in range(0, max(n, 1), rows_per_split):
            a_s, d_s = a[lo:lo + rows_per_split], d[lo:lo + rows_per_split]
            p = torch.mm(a_s.to(F32).T, d_s.to(cd).to(F32))
            w = w + (p.to(cd).to(F32) if round_partial else p)
            if bias:
                b = b + d_s.to(F32).sum(0, keepdim=True)
        out.append(w)
        if bias:
            out.append(b)
    return out


def _by_split(jobs, rows_per_split, round_partial, grads, split_sums):
    """The frame of the yardsticks below: ``split_sums(a, d, cd)`` gives
    every split's f32 (dW, db) at once from A and delta cut into (splits,
    rows, width) with the last split's missing rows as zeros; each dW is
    rounded to A's dtype with ``round_partial`` and the splits are summed in
    f32 in order from 0 or from ``grads``, as the plain version sums them."""
    start = iter(grads if grads is not None else [
        torch.zeros(s, dtype=F32, device=jobs[0][0].device)
        for s in grad_shapes(jobs)])
    out = []
    for a, d, bias in jobs:
        n = a.shape[0]
        rows = min(rows_per_split, max(n, 1))
        splits = _splits(n, rows_per_split)

        def cut(t):
            pad = t.new_zeros((splits * rows - n, t.shape[1]))
            return torch.cat([t, pad]).reshape(splits, rows, t.shape[1])
        pw, pb = split_sums(cut(a), cut(d), a.dtype)
        w = next(start)
        b = next(start) if bias else None
        for s in range(splits):
            w = w + (pw[s].to(a.dtype).to(F32) if round_partial else pw[s])
            if bias:
                b = b + pb[s]
        out.append(w)
        if bias:
            out.append(b)
    return out


def _f64_sums(a, d, cd):
    return (torch.bmm(a.double().transpose(1, 2), d.to(cd).double()).to(F32),
            d.double().sum(1, keepdim=True).to(F32))


def _in_order_sums(a, d, cd):
    a32, d32, raw = a.to(F32), d.to(cd).to(F32), d.to(F32)
    w = a32.new_zeros((a.shape[0], a.shape[2], d.shape[2]))
    b = a32.new_zeros((a.shape[0], 1, d.shape[2]))
    for r in range(a.shape[1]):
        w = w + a32[:, r, :, None] * d32[:, r, None, :]
        b = b + raw[:, r:r + 1]
    return w, b


def wgrad_reduce_f64(jobs, rows_per_split: int, round_partial=False,
                     grads=None):
    """The pass with each split's products (and bias sums) summed in f64
    and rounded once to f32, then finished as the plain version: the
    correctly rounded split that the kernel's summation is held against.
    Same arguments and result as ``wgrad_reduce_plain``."""
    return _by_split(jobs, rows_per_split, round_partial, grads, _f64_sums)


def wgrad_reduce_in_order(jobs, rows_per_split: int, round_partial=False,
                          grads=None):
    """The pass with each point's product (exact in f32: two bf16 values)
    added to an f32 sum in the order of the points within a split, one
    rounding a point, then finished as the plain version: the plain sum
    whose error the kernel's may not exceed.  Same arguments and result as
    ``wgrad_reduce_plain``."""
    return _by_split(jobs, rows_per_split, round_partial, grads,
                     _in_order_sums)


def summation_error(got, exact):
    """How far an f32 grad ``got`` lies from ``exact`` (its
    ``wgrad_reduce_f64`` value): the relative Frobenius error, which the
    card's rounding gate reads, and the largest error in units in the last
    place of the grad's largest value (an element's own ulp would read a
    sum that cancels to near zero as millions of units)."""
    diff = got.double() - exact.double()
    top = exact.abs().max()
    ulp = float(torch.nextafter(top, torch.full_like(top, math.inf)) - top)
    return dict(rel=float(torch.linalg.vector_norm(diff)
                          / torch.linalg.vector_norm(exact.double())
                          .clamp_min(1e-300)),
                ulps=float(diff.abs().max()) / max(ulp, 1e-45))


def _check(jobs, rows_per_split, grads, dev):
    """Raise unless the jobs are what the kernel takes; returns the compute
    dtype and the point count."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"expected 1 to {MAX_JOBS} jobs, got {len(jobs)}")
    if rows_per_split < 1:
        raise ValueError(f"rows_per_split must be positive, got "
                         f"{rows_per_split}")
    cd, n = jobs[0][0].dtype, jobs[0][0].shape[0]
    if cd not in (F32, torch.bfloat16):
        raise ValueError(f"A must be f32 or bf16, got {cd}")
    for i, (a, d, bias) in enumerate(jobs):
        check_device(a, dev, f"job {i} A")
        check_device(d, dev, f"job {i} delta")
        if a.dim() != 2 or a.dtype != cd or not a.is_contiguous() \
                or a.shape[0] != n:
            raise ValueError(f"job {i}: A must be a contiguous ({n}, m) {cd} "
                             f"tensor, got {tuple(a.shape)} {a.dtype}")
        if d.dim() != 2 or d.dtype not in (cd, F32) or d.shape[0] != n \
                or d.stride(1) != 1 or d.stride(0) < max(d.shape[1], 1):
            raise ValueError(f"job {i}: delta must be ({n}, k) in {cd} or "
                             f"f32 with unit column stride, got "
                             f"{tuple(d.shape)} {d.dtype} strides "
                             f"{d.stride()}")
        if not isinstance(bias, bool):
            raise ValueError(f"job {i}: bias must be a bool")
    shapes = grad_shapes(jobs)
    if len(shapes) > MAX_GRADS:
        raise ValueError(f"at most {MAX_GRADS} grads, got {len(shapes)}")
    if _splits(n, rows_per_split) > MAX_SPLITS:
        raise ValueError(f"more than {MAX_SPLITS} K-splits")
    if grads is not None:
        if len(grads) != len(shapes):
            raise ValueError(f"expected {len(shapes)} grads, got "
                             f"{len(grads)}")
        for i, (g, s) in enumerate(zip(grads, shapes)):
            check_device(g, dev, f"grad {i}")
            if tuple(g.shape) != s or g.dtype != F32 \
                    or not g.is_contiguous():
                raise ValueError(f"grad {i} must be a contiguous f32 tensor "
                                 f"of shape {s}")
    return cd, n


def wgrad_reduce(jobs, rows_per_split: int, round_partial=False, grads=None,
                 device=None):
    """The weight-grad pass over ``jobs``, a sequence of (A, delta, bias):
    A (N, m) contiguous in the compute dtype, delta (N, k) in that dtype or
    f32 with unit column stride (a strided view of a wider array, at an
    offset, as the heads' f32 cotangent of the spatial recompute backward),
    bias a bool.  The points are cut into K-splits of ``rows_per_split``.
    Returns the f32 grads in job order, dW (m, k) and, with bias, db (1, k);
    with ``grads`` the splits are summed onto those tensors, in place on
    the card.  On the CPU this is ``wgrad_reduce_plain``."""
    dev = resolve_device(device)
    jobs = [tuple(j) for j in jobs]
    cd, n = _check(jobs, rows_per_split, grads, dev)
    if dev.type == "cpu":
        return wgrad_reduce_plain(jobs, rows_per_split, round_partial, grads)
    like = dict(dtype=F32, device=jobs[0][0].device)
    shapes = grad_shapes(jobs)
    out = list(grads) if grads is not None else [torch.empty(s, **like)
                                                 for s in shapes]
    partial = torch.empty(_splits(n, rows_per_split)
                          * sum(math.prod(s) for s in shapes), **like)
    # per job (m, k, ld, delta_f32, bias): delta_f32 is an f32 delta beside
    # bf16 A, rounded for the product
    dims = [(a.shape[1], d.shape[1], d.stride(0), int(d.dtype != cd),
             int(bias)) for a, d, bias in jobs]
    dims = (ctypes.c_int64 * (5 * len(jobs)))(*[v for j in dims for v in j])
    launch("wgrad_reduce", cd, jobs[0][0].device,
           pointers([a for a, _, _ in jobs]), pointers([d for _, d, _ in jobs]),
           dims, len(jobs), n, rows_per_split, int(round_partial),
           int(grads is not None), partial.data_ptr(), pointers(out))
    return out
