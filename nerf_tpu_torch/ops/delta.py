"""The backwards' delta pass on its own.

Every fused backward, and the density gradient of ``ref_spa_fwd_res`` and
``ref_spa_fwd_grad``, runs its chain rule through one device function
(``delta_tile``, ``csrc/mlp_tile.cuh``): out = mask(a @ W^T [+ gs wcol^T]),
rounded to the compute dtype, over a tile of 64 rows in shared memory, with
W the layer's (n_out, k_dim) forward matrix and the mask the stored
activation's ReLU (act > 0) or its bits.  ``delta_layer`` (``csrc/delta.cu``)
runs that pass alone over n rows, so that it can be held against its plain
version and timed at the fused kernels' layer shapes; nothing on the
training or render path calls this entry.

Replaces: the transposed products and masks of the Pallas backwards,
``jnp.where(act > 0, _dwt(delta, w), 0).astype(cd)`` (nerf_tpu/ops/
fused_mlp.py:69, the vanilla chain :203-221, the proposal chain :516-524,
and the same chain inside the hand-written ``jax.vjp``s of nerf_tpu/ops/
ref_fused.py :643, :701, :729, :867, :901).

Numerics: a, W and act in the compute dtype (f32 or bf16); the product
accumulates in f32 (bf16 operands on the tensor cores, f32 on the CUDA cores
in full f32); the K = 1 term ``gs[row] * wcol[c]`` (vanilla dz7, the
proposal's dh4) is added in f32 before the mask; with ``add`` the product
is rounded to the compute dtype and added to ``add`` in f32 (a sum of
pullbacks rounded after each add); then the mask and the cast.  ``store``
also returns the rows as the fused kernels write them to device memory: in
the compute dtype, or in f32 unrounded (vanilla dbvec).

Bound on an H100 SXM at widths of 128 and more: 2 n n_out k_dim FLOPs
against the bytes of a, act and the output, by operations; the heads
(k_dim <= 9) by bytes.  In bf16 the trunk passes (k_dim a multiple of 8)
multiply on wgmma with W brought by TMA, the heads on mma.sync; each
k-step's 16-term tensor-core sum is added to an f32 sum in the order of k.
``delta_layer_f64`` (the pass summed in f64, then rounded) and
``delta_layer_in_order`` (each term added to an f32 sum in the order of k)
are the two yardsticks of the card's rounding gate: no more of the
kernel's bf16 outputs may differ from the first than of the second's.

Dispatch as in ``fused_mlp``: a CPU tensor takes ``delta_layer_plain``; a
CUDA tensor launches the kernel or raises.  Any k_dim >= 0 and n_out >= 1
whose block fits the card's shared memory (``block_bytes``) is taken; the
wrapper rejects others on either device.  ``LAUNCHES["delta_layer"]``
counts this entry's launches only, not the passes inside the fused kernels.
"""

from __future__ import annotations

import torch

from nerf_tpu_torch.device import check_device, resolve_device
from nerf_tpu_torch.ops.dense import mask_words
from nerf_tpu_torch.ops.launch import I64, INT, PTR, launch, register

F32 = torch.float32
TM = 64                       # rows a block (csrc/mlp_tile.cuh)
SMEM_LIMIT = 232_448          # shared memory a block may use on an H100
RING_ALIGN, RING_BARS = 1024, 128   # mlp_tile.cuh's ring placement

register({"delta_layer": ("delta", [PTR, INT, PTR, INT, PTR, PTR, PTR, PTR,
                                    PTR, I64, PTR, PTR, INT])})


def unpack_mask(bits: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) bool of ReLU bit-mask words (``dense.pack_mask``'s)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    on = (bits.to(torch.int64).unsqueeze(-1) >> shifts) & 1
    return on.reshape(bits.shape[0], -1)[:, :width].bool()


def stage_bytes(at: int, dtype) -> int:
    """The delta pass's stage at byte ``at`` of a block's shared memory
    (mlp_tile.cuh's delta_stage_bytes): in bf16 the ring of two 256 x 16
    slots on the first 1024-byte boundary at least RING_BARS bytes in, the
    bytes below it included; the f32 path's 32 rows of W^T."""
    if dtype == torch.bfloat16:
        ring = -(-(at + RING_BARS) // RING_ALIGN) * RING_ALIGN
        return ring - at + 2 * 256 * 16 * 2
    return 32 * 257 * 4


def block_bytes(k_dim: int, n_out: int, dtype, bits: bool = False) -> int:
    """Shared memory of one block of the entry (csrc/delta.cu)."""
    size = torch.finfo(dtype).bits // 8
    at = (TM * (k_dim + n_out + 1) * size
          + (TM * mask_words(n_out) * 4 if bits else 0))
    return at + stage_bytes(at, dtype)


def delta_layer_plain(a, w, act=None, gs=None, wcol=None, add=None,
                      bits=None, store=None):
    """The pass in plain PyTorch: the f32 product of the upcast operands,
    plus gs wcol^T in f32, [rounded and added to ``add``], masked where act
    (or the bits) say the ReLU was off, cast to a's dtype.  Returns (out,
    stored): stored the rows in ``store``'s dtype (f32: unrounded), or
    None."""
    cd = a.dtype
    acc = torch.matmul(a.to(F32), w.to(F32).t())
    if gs is not None:
        acc = acc + gs.to(F32).reshape(-1, 1) * wcol.to(F32).reshape(1, -1)
    if add is not None:
        acc = acc.to(cd).to(F32) + add.to(F32)
    if act is not None:
        acc = torch.where(act.to(F32) > 0, acc, 0.0)
    elif bits is not None:
        acc = torch.where(unpack_mask(bits, w.shape[0]), acc, 0.0)
    out = acc.to(cd)
    if store is None:
        return out, None
    return out, (acc.clone() if store == F32 else out.clone())


def _finish(acc, cd, w, act, gs, wcol, add, bits):
    """The rest of the pass after its products ``acc`` (f32 or f64): the
    K = 1 term, the ADD, the mask, the cast to ``cd``; an f64 ``acc`` is
    rounded to f32 first."""
    if gs is not None:
        acc = acc + (gs.to(acc.dtype).reshape(-1, 1)
                     * wcol.to(acc.dtype).reshape(1, -1))
    acc = acc.to(F32)
    if add is not None:
        acc = acc.to(cd).to(F32) + add.to(F32)
    if act is not None:
        acc = torch.where(act.to(F32) > 0, acc, 0.0)
    elif bits is not None:
        acc = torch.where(unpack_mask(bits, w.shape[0]), acc, 0.0)
    return acc.to(cd)


def delta_layer_f64(a, w, act=None, gs=None, wcol=None, add=None,
                    bits=None):
    """The pass with its products (and the K = 1 term) summed in f64, exact
    for bf16 operands up to a few thousand terms, then rounded to f32 and
    finished as the plain version does: the correctly rounded pass that
    the rounding gate holds the kernel's outputs against."""
    acc = a.double() @ w.double().t()
    return _finish(acc, a.dtype, w, act, gs, wcol, add, bits)


def delta_layer_in_order(a, w, act=None, gs=None, wcol=None, add=None,
                         bits=None):
    """The pass with each k term added to an f32 sum in the order of k, one
    rounding per term (a product of two bf16 values is exact in f32), then
    finished as the plain version does: the plain sum that the kernel's
    rounding is held against."""
    a32, w32 = a.to(F32), w.to(F32)
    acc = torch.zeros((a.shape[0], w.shape[0]), dtype=F32, device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a32[:, k:k + 1] * w32[:, k].reshape(1, -1)
    return _finish(acc, a.dtype, w, act, gs, wcol, add, bits)


def _check(a, w, act, gs, wcol, add, bits, store, dev):
    """Raise unless the operands are what the kernel takes; returns n_out."""
    cd = a.dtype
    if cd not in (F32, torch.bfloat16):
        raise ValueError(f"a must be f32 or bf16, got {cd}")
    check_device(a, dev, "a")
    check_device(w, dev, "w")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"a must be a contiguous (n, k) tensor, got "
                         f"{tuple(a.shape)}")
    n, k = a.shape
    if w.dim() != 2 or w.dtype != cd or not w.is_contiguous() \
            or w.shape[1] != k or w.shape[0] < 1:
        raise ValueError(f"w must be a contiguous (n_out, {k}) {cd} tensor "
                         f"with n_out >= 1, got {tuple(w.shape)} {w.dtype}")
    n_out = w.shape[0]
    if act is not None and bits is not None:
        raise ValueError("act and bits are two forms of one mask: give one")
    if (gs is None) != (wcol is None):
        raise ValueError("gs and wcol come together")
    rows = [("act", act, (n, n_out), cd), ("add", add, (n, n_out), cd),
            ("bits", bits, (n, mask_words(n_out)), torch.int32)]
    if gs is not None:
        rows += [("gs", gs.reshape(-1), (n,), cd),
                 ("wcol", wcol.reshape(-1), (n_out,), cd)]
    for name, t, shape, dtype in rows:
        if t is None:
            continue
        check_device(t, dev, name)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape}, got {tuple(t.shape)} {t.dtype}")
    if store not in (None, cd, F32):
        raise ValueError(f"store must be None, {cd} or float32, got {store}")
    need = block_bytes(k, n_out, cd, bits is not None)
    if need > SMEM_LIMIT:
        raise ValueError(f"widths k={k}, n_out={n_out} need {need} bytes of "
                         f"shared memory a block, more than {SMEM_LIMIT}")
    return n_out


def delta_layer(a, w, act=None, gs=None, wcol=None, add=None, bits=None,
                store=None, device=None):
    """One layer of the chain rule through the fused backwards' pass: a (n,
    k_dim) contiguous in the compute dtype (k_dim may be 0), w the layer's
    (n_out, k_dim) forward matrix in that dtype; optionally act (n, n_out)
    (mask act > 0) or bits (n, mask_words(n_out)) int32 (its ReLU bits), gs
    (n,) with wcol (n_out,) (the K = 1 term), add (n, n_out) (the values the
    pullback is added to), all in the compute dtype.  Returns (out, stored):
    out (n, n_out) in the compute dtype; with ``store`` (the compute dtype or
    f32) the rows the gout path writes, else None.  On the CPU this is
    ``delta_layer_plain``."""
    dev = resolve_device(device)
    n_out = _check(a, w, act, gs, wcol, add, bits, store, dev)
    if dev.type == "cpu":
        return delta_layer_plain(a, w, act, gs, wcol, add, bits, store)
    n, cd = a.shape[0], a.dtype
    out = torch.empty((n, n_out), dtype=cd, device=a.device)
    stored = (torch.empty((n, n_out), dtype=store, device=a.device)
              if store is not None else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    if n > 0:
        launch("delta_layer", cd, a.device, ptr(a), a.shape[1], ptr(w),
               n_out, ptr(act), ptr(gs), ptr(wcol), ptr(add), ptr(bits), n,
               out.data_ptr(), ptr(stored), int(store == F32 and cd != F32))
    return out, stored
