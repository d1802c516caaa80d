"""Fused whole-network MLP forward kernels and their plain versions.

Two kernels, CUDA C++ for ``sm_90a`` in ``csrc/fused_mlp.cu``:

``prop_mlp_fwd``
    Replaces ``_prop_fwd_kernel`` (nerf_tpu/ops/fused_mlp.py:478) via
    ``make_prop_fused`` (:540), forward-only.  enc (N, 63) -> 4 x (dense 256,
    ReLU, cast) -> raw density (N,) f32.
``vanilla_mlp_fwd``
    Replaces ``_vanilla_fwd_kernel`` (:128) over ``_vanilla_forward_tile``
    (:96) via ``make_vanilla_fused`` (:305), forward-only.  enc_x (N, 63),
    enc_d (N, 27) -> rgb3 (3, N) f32 and raw sigma (N,) f32.

Contract (fused_mlp.py:96-125, :326-331): weight matrices (in, out) in the
compute dtype (f32, or bf16 under ``-s``), biases (1, W) f32; products
accumulated in f32, the bias added in f32, ReLU, then a cast to the compute
dtype after every layer.  Weight tuples follow fused_mlp.py:79-92 and :457
(``ProposalNetwork.kernel_weights``, ``VanillaNeRF.kernel_weights``).

Bound on an H100 SXM at its full 700 W power limit (989 TFLOP/s bf16
tensor-core peak, 3.35 TB/s, from the data sheet): the vanilla net costs
527,872 MACs per point, 0.554 TFLOP for one 4096-ray chunk of 128 samples
(0.56 ms at peak); the proposal net 212,992 MACs per point, 0.112 TFLOP per
64-sample chunk (0.11 ms).  Device-memory traffic is under
0.2 KB per point, so both are compute-bound.  The kernels keep every
activation of a 64-point tile in shared memory and read the weights from L2;
this first version multiplies on the CUDA cores, not the tensor cores, so it
sits far from the bound (PERF.md has its times).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  There is no fallback from the kernel to the plain
version.  ``LAUNCHES`` counts kernel launches, one per launch, nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_tpu_torch.device import check_device, resolve_device
from nerf_tpu_torch.ops import build

N_PROP_WS = 10      # w0 b0 w1 b1 w2 b2 w3 b3 wo bo
N_VANILLA_WS = 24   # fused_mlp.py:79-92
PROP_BIASES = (1, 3, 5, 7, 9)
VANILLA_BIASES = (1, 3, 5, 7, 10, 12, 14, 16, 18, 21, 23)
TILE_ROWS = 64      # points per block, TM in csrc/fused_mlp.cu
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on sm_90

LAUNCHES = {"prop_mlp_fwd": 0, "vanilla_mlp_fwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

def _dense(a, w, b=None):
    """f32 product of upcast operands, plus the f32 bias."""
    out = torch.matmul(a.to(torch.float32), w.to(torch.float32))
    return out if b is None else out + b


def _hidden(a, w, b, cd):
    return torch.relu(_dense(a, w, b)).to(cd)


def prop_mlp_plain(ws, enc: torch.Tensor) -> torch.Tensor:
    """Proposal forward in plain PyTorch: (N,) f32 raw density."""
    w0, b0, w1, b1, w2, b2, w3, b3, wo, bo = ws
    cd = enc.dtype
    h = _hidden(enc, w0, b0, cd)
    h = _hidden(h, w1, b1, cd)
    h = _hidden(h, w2, b2, cd)
    h = _hidden(h, w3, b3, cd)
    return _dense(h, wo, bo)[:, 0]


def vanilla_mlp_plain(ws, enc_x: torch.Tensor, enc_d: torch.Tensor):
    """VanillaNeRF forward in plain PyTorch: (rgb3 (3, N) f32, sigma (N,) f32)."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     wsig, bsig, wb, bb, wr1a, wr1b, br1, wr2, br2) = ws
    cd = enc_x.dtype
    h = _hidden(enc_x, w0, b0, cd)
    h = _hidden(h, w1, b1, cd)
    h = _hidden(h, w2, b2, cd)
    h = _hidden(h, w3, b3, cd)
    z = torch.relu(_dense(enc_x, w4a) + _dense(h, w4b, b4)).to(cd)
    z = _hidden(z, w5, b5, cd)
    z = _hidden(z, w6, b6, cd)
    sigma = _dense(z, wsig, bsig)[:, 0]
    bvec = _dense(z, wb, bb).to(cd)
    r1 = torch.relu(_dense(bvec, wr1a) + _dense(enc_d, wr1b, br1)).to(cd)
    rgb3 = torch.sigmoid(_dense(r1, wr2, br2)).T.contiguous()
    return rgb3, sigma


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_operands(ws, encs, n_ws: int, biases, dev: torch.device):
    """Validate what the kernels take: 2-D contiguous f32/bf16 encodings of
    one dtype and row count, (in, out) matrices in that dtype and (1, W) f32
    biases, all on ``dev``."""
    if len(ws) != n_ws:
        raise ValueError(f"expected {n_ws} weights, got {len(ws)}")
    cd = encs[0].dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be f32 or bf16, got {cd}")
    for i, e in enumerate(encs):
        check_device(e, dev, f"encoding {i}")
        if e.dim() != 2 or e.dtype != cd or not e.is_contiguous():
            raise ValueError(f"encoding {i} must be a contiguous 2-D {cd} "
                             f"tensor, got {tuple(e.shape)} {e.dtype}")
        if e.shape[0] != encs[0].shape[0]:
            raise ValueError("encodings differ in row count")
    for i, w in enumerate(ws):
        check_device(w, dev, f"weight {i}")
        if w.dim() != 2 or not w.is_contiguous():
            raise ValueError(f"weight {i} must be a contiguous 2-D tensor")
        want = torch.float32 if i in biases else cd
        if w.dtype != want:
            raise ValueError(f"weight {i} must be {want}, got {w.dtype}")


def _chain(shapes, pairs):
    """Check that each (index, expected shape) pair holds."""
    for i, want in pairs:
        if tuple(shapes[i]) != tuple(want):
            raise ValueError(f"weight {i} has shape {tuple(shapes[i])}, "
                             f"expected {tuple(want)}")


def _smem_bytes(widths, dtype) -> int:
    elem = 2 if dtype == torch.bfloat16 else 4
    return TILE_ROWS * sum(widths) * elem


def _launch(fn_name: str, dtype, *args):
    lib = build.load("fused_mlp")
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"{fn_name}_{suffix}")
    if fn.argtypes is None:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p, u64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p] if fn_name == "prop_mlp_fwd"
            else [ctypes.c_void_p, ctypes.c_void_p, u64p, ctypes.c_int64,
                  ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p])
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
        lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
    err = fn(*args)
    if err != 0:
        msg = lib.fused_mlp_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")


def _pointers(ws):
    return (ctypes.c_uint64 * len(ws))(*[w.data_ptr() for w in ws])


def prop_mlp_fwd(ws, enc: torch.Tensor, device=None) -> torch.Tensor:
    """Fused ProposalNetwork forward: enc (N, Dx) -> raw density (N,) f32.

    ``device`` defaults to ``cuda``; the operands must lie there.  On the CPU
    (``device="cpu"``) this is ``prop_mlp_plain``.
    """
    dev = resolve_device(device)
    _check_operands(ws, (enc,), N_PROP_WS, PROP_BIASES, dev)
    n, dx = enc.shape
    h = ws[0].shape[1]
    _chain([w.shape for w in ws],
           [(0, (dx, h)), (2, (h, h)), (4, (h, h)), (6, (h, h)), (8, (h, 1))]
           + [(i, (1, ws[i - 1].shape[1])) for i in PROP_BIASES])
    if dev.type == "cpu":
        return prop_mlp_plain(ws, enc)
    smem = _smem_bytes((dx, h, h), enc.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"prop_mlp_fwd needs {smem} B of shared memory per "
                         f"block at width {h}; the card allows {SMEM_LIMIT}")
    out = torch.empty(n, dtype=torch.float32, device=enc.device)
    if n == 0:
        return out
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("prop_mlp_fwd", enc.dtype, enc.data_ptr(), _pointers(ws), n,
                dx, h, out.data_ptr(), stream)
    LAUNCHES["prop_mlp_fwd"] += 1
    return out


def vanilla_mlp_fwd(ws, enc_x: torch.Tensor, enc_d: torch.Tensor,
                    device=None):
    """Fused VanillaNeRF forward: enc_x (N, Dx), enc_d (N, Dd) ->
    (rgb3 (3, N) f32, raw sigma (N,) f32).

    ``device`` defaults to ``cuda``; the operands must lie there.  On the CPU
    (``device="cpu"``) this is ``vanilla_mlp_plain``.
    """
    dev = resolve_device(device)
    _check_operands(ws, (enc_x, enc_d), N_VANILLA_WS, VANILLA_BIASES, dev)
    n, dx = enc_x.shape
    dd = enc_d.shape[1]
    h, bn, r = ws[0].shape[1], ws[13].shape[1], ws[19].shape[1]
    _chain([w.shape for w in ws],
           [(0, (dx, h)), (2, (h, h)), (4, (h, h)), (6, (h, h)),
            (8, (dx, h)), (9, (h, h)), (11, (h, h)), (13, (h, bn)),
            (15, (bn, 1)), (17, (bn, bn)), (19, (bn, r)), (20, (dd, r)),
            (22, (r, 3))]
           + [(i, (1, ws[i - 1].shape[1])) for i in VANILLA_BIASES])
    if dev.type == "cpu":
        return vanilla_mlp_plain(ws, enc_x, enc_d)
    maxw = max(h, bn, r)
    smem = _smem_bytes((dx, dd, maxw, maxw), enc_x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"vanilla_mlp_fwd needs {smem} B of shared memory "
                         f"per block at width {maxw}; the card allows "
                         f"{SMEM_LIMIT}")
    rgb3 = torch.empty((3, n), dtype=torch.float32, device=enc_x.device)
    sigma = torch.empty(n, dtype=torch.float32, device=enc_x.device)
    if n == 0:
        return rgb3, sigma
    dims = (ctypes.c_int * 5)(dx, dd, h, bn, r)
    with torch.cuda.device(enc_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("vanilla_mlp_fwd", enc_x.dtype, enc_x.data_ptr(),
                enc_d.data_ptr(), _pointers(ws), n, dims, rgb3.data_ptr(),
                sigma.data_ptr(), stream)
    LAUNCHES["vanilla_mlp_fwd"] += 1
    return rgb3, sigma
