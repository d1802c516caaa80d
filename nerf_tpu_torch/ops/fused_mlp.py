"""Fused whole-network MLP kernels, their plain versions and their autograd.

Eight kernels, CUDA C++ for ``sm_90a`` (``csrc/``), each replacing a Pallas
kernel of nerf_tpu/ops/fused_mlp.py:

``prop_mlp_fwd`` (``fused_mlp.cu``; in bf16 ``prop_frame.cuh``)
    ``_prop_fwd_kernel`` (:478) via ``make_prop_fused`` (:540).  enc (N, 63)
    -> 4 x (dense 256, ReLU, cast) -> raw density (N,) f32.
``prop_mlp_fwd_res`` (``fused_mlp.cu``; in bf16 ``prop_frame.cuh``)
    ``_prop_fwd_res_kernel`` (:483), the training forward of
    ``prop_store_residuals=True``: the same density, bit for bit, and the 4
    activations h1 h2 h3 h4, (N, width) each in the compute dtype.
``vanilla_mlp_fwd`` (``fused_mlp.cu``; in bf16 ``vanilla_frame.cuh``)
    ``_vanilla_fwd_kernel`` (:128) over ``_vanilla_forward_tile`` (:96), the
    forward-only form.  enc_x (N, 63), enc_d (N, 27) -> rgb3 (3, N) f32 and
    raw sigma (N,) f32.
``vanilla_mlp_fwd_res`` (``fused_mlp.cu``; in bf16 ``vanilla_frame.cuh``)
    ``_vanilla_fwd_res_kernel`` (:150), the training forward of
    ``store_residuals=True``: the same outputs, and the 9 activations h1 h2 h3
    h4 z5 z6 z7 bvec r1, (N, width) each in the compute dtype.
``vanilla_mlp_bwd`` (``fused_mlp_bwd.cu``)
    ``_vanilla_bwd_res_kernel`` (:163) with ``_vanilla_bwd_math`` (:195):
    g_rgb (3, N), g_sigma (N,) f32 and the stored activations -> the 24 f32
    grads of the weight tuple.
``prop_mlp_bwd`` (``fused_mlp_bwd.cu``)
    ``_prop_bwd_kernel`` (:493) with ``_prop_bwd_math`` (:506), the recompute
    form: h1..h4 are rebuilt in the tile; g (N,) f32 -> the 10 f32 grads.
``prop_mlp_bwd_res`` (``fused_mlp_bwd.cu``)
    ``_prop_bwd_res_kernel`` (:499): the same chain rule over the stored
    h1..h4, without the rebuild; the grads equal ``prop_mlp_bwd``'s.
    Both proposal backwards walk the points in chunks of whole K-splits, as
    ``vanilla_mlp_bwd_recompute`` does, so their deltas take scratch of one
    chunk.
``vanilla_mlp_bwd_recompute`` (``fused_mlp_recompute.cu``)
    ``_vanilla_bwd_kernel`` (:136) over ``_vanilla_bwd_tile`` (:181), the
    backward of ``store_residuals=False``: enc_x, enc_d, g_rgb (3, N) and
    g_sigma (N,) f32 -> the 24 f32 grads.  h1 .. r1 and rgb3 are rebuilt
    from the encodings, chunk by chunk of whole K-splits, so that no
    activation of all N points is held: the chain rule and the sums are
    ``vanilla_mlp_bwd``'s.

Contract (fused_mlp.py:96-125, :195-246, :326-331): weight matrices (in, out)
in the compute dtype (f32, or bf16 under ``-s``), biases (1, W) f32; products
accumulated in f32, the bias added in f32, ReLU, then a cast to the compute
dtype after every layer.  Weight tuples follow fused_mlp.py:79-92 and :457.
The backward casts every layer's delta to the compute dtype, reads each ReLU
mask from the stored activation (``act > 0``), keeps dbvec in f32 for dbb,
and returns f32 grads; the input cotangents are zero by construction
(fused_mlp.py:14-19: the encodings are of detached sample points).

The TPU backwards sum the tiles' grads into one buffer in grid order, which a
GPU's concurrent blocks cannot do.  The CUDA backwards run a per-tile delta
pass that writes each layer's delta to device memory, a split-K pass that
computes dW = A^T delta and the bias sums per K-split into partials, and a
reduction that adds the partials in a fixed order: deterministic, no atomics.

Bounds on an H100 SXM at its 700 W limit (989 TFLOP/s bf16 tensor-core peak,
3.35 TB/s): the vanilla forward costs 527,872 MACs per point and the proposal
forward 212,992, both compute-bound; the res forward also writes 4.35 KB of
bf16 activations per point and is bound by those bytes; the vanilla backward
costs 1,020,032 MACs per point and the proposal backward 622,848, both bound
by operations.  The hidden layers (``dense_tile``, ``ops.dense``) and the
backwards' weight-grad pass (csrc/wgrad.cuh, ``ops.wgrad``) multiply bf16
operands on the tensor cores; the heads and the backwards' delta passes
multiply on the CUDA cores (PERF.md has their times).  The bf16 kernels take
hidden widths that are multiples of 8 (the launch raises otherwise).

The two bf16 vanilla forwards run the persistent frame of
``csrc/vanilla_frame.cuh`` (tiles of 128 points, one block an SM, a
producer that streams every layer's weights through one ring), and the two
bf16 proposal forwards the same frame's parts in ``csrc/prop_frame.cuh``,
or the 64-row tile of ``csrc/fused_mlp.cu`` at widths whose frame does not
fit a block (chosen by shape before the launch; each launch counts the body
it ran in ``BODIES``, named by ``vanilla_body_name`` and
``prop_body_name``).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  There is no fallback from the kernel to the plain
version.  ``LAUNCHES`` (``ops/launch.py``) counts the wrappers' kernel
launches, one per call that launches (a backward is one count for its three
CUDA launches), and nowhere else.

``VanillaMLP``, ``VanillaMLPRecompute``, ``PropMLP`` and ``PropMLPRes`` are
the ``torch.autograd.Function``s of the training path (the
``jax.custom_vjp`` of ``make_vanilla_fused`` with ``store_residuals`` True
and False, and of ``make_prop_fused`` with it False and True).  They take
the f32 parameters and cast them inside, as
``_prep`` does (fused_mlp.py:326-331), so the f32 grads reach the parameters
unrounded.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.ops import launch as launch_lib
from nerf_tpu_torch.ops.launch import (
    I64, INT, INTP, PTR, U64P, check_operands, check_shapes, check_tensor,
    count_body, launch, pointers, register,
)

F32 = torch.float32
N_PROP_WS = 10      # w0 b0 w1 b1 w2 b2 w3 b3 wo bo
N_PROP_ACTS = 4     # h1 h2 h3 h4 (fused_mlp.py:475)
N_VANILLA_WS = 24   # fused_mlp.py:79-92
N_VANILLA_ACTS = 9  # h1 h2 h3 h4 z5 z6 z7 bvec r1 (fused_mlp.py:144-147)
PROP_BIASES = (1, 3, 5, 7, 9)
VANILLA_BIASES = (1, 3, 5, 7, 10, 12, 14, 16, 18, 21, 23)
ROWS_PER_SPLIT = 4096  # points per K-split of the weight-grad pass
MAX_SPLITS = 64
# points per chunk of a recompute backward (rounded down to whole K-splits):
# its scratch holds this many points' activations and deltas
CHUNK_ROWS = 32768


def prep_weights(ws, cd: torch.dtype):
    """Kernel operands of a weight tuple: matrices in ``cd``, biases f32,
    all contiguous (``_prep`` of fused_mlp.py:326-331)."""
    biases = VANILLA_BIASES if len(ws) == N_VANILLA_WS else PROP_BIASES
    return launch_lib.prep_weights(ws, biases, cd)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels on the card)
# ---------------------------------------------------------------------------

def _dense(a, w, b=None):
    """f32 product of upcast operands, plus the f32 bias."""
    out = torch.matmul(a.to(F32), w.to(F32))
    return out if b is None else out + b


def _hidden(a, w, b, cd):
    return torch.relu(_dense(a, w, b)).to(cd)


def _prop_forward(ws, enc):
    w0, b0, w1, b1, w2, b2, w3, b3, wo, bo = ws
    cd = enc.dtype
    h1 = _hidden(enc, w0, b0, cd)
    h2 = _hidden(h1, w1, b1, cd)
    h3 = _hidden(h2, w2, b2, cd)
    h4 = _hidden(h3, w3, b3, cd)
    return (h1, h2, h3, h4), _dense(h4, wo, bo)[:, 0]


def prop_mlp_plain(ws, enc: torch.Tensor) -> torch.Tensor:
    """Proposal forward in plain PyTorch: (N,) f32 raw density."""
    return _prop_forward(ws, enc)[1]


def prop_mlp_fwd_res_plain(ws, enc: torch.Tensor):
    """The prop_store_residuals forward in plain PyTorch: (raw density (N,)
    f32, the 4 activations (N, width) in the compute dtype)."""
    acts, density = _prop_forward(ws, enc)
    return density, acts


def _vanilla_forward(ws, enc_x, enc_d):
    """All of ``_vanilla_forward_tile``'s values:
    (h1 h2 h3 h4 z5 z6 z7 bvec r1), sigma (N,), rgb3 (3, N)."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     wsig, bsig, wb, bb, wr1a, wr1b, br1, wr2, br2) = ws
    cd = enc_x.dtype
    h1 = _hidden(enc_x, w0, b0, cd)
    h2 = _hidden(h1, w1, b1, cd)
    h3 = _hidden(h2, w2, b2, cd)
    h4 = _hidden(h3, w3, b3, cd)
    z5 = torch.relu(_dense(enc_x, w4a) + _dense(h4, w4b, b4)).to(cd)
    z6 = _hidden(z5, w5, b5, cd)
    z7 = _hidden(z6, w6, b6, cd)
    sigma = _dense(z7, wsig, bsig)[:, 0]
    bvec = _dense(z7, wb, bb).to(cd)
    r1 = torch.relu(_dense(bvec, wr1a) + _dense(enc_d, wr1b, br1)).to(cd)
    rgb3 = torch.sigmoid(_dense(r1, wr2, br2)).T.contiguous()
    return (h1, h2, h3, h4, z5, z6, z7, bvec, r1), sigma, rgb3


def vanilla_mlp_plain(ws, enc_x: torch.Tensor, enc_d: torch.Tensor):
    """VanillaNeRF forward in plain PyTorch: (rgb3 (3, N) f32, sigma (N,) f32)."""
    _, sigma, rgb3 = _vanilla_forward(ws, enc_x, enc_d)
    return rgb3, sigma


def vanilla_mlp_fwd_res_plain(ws, enc_x: torch.Tensor, enc_d: torch.Tensor):
    """The store_residuals forward in plain PyTorch: (rgb3 (3, N) f32,
    sigma (N,) f32, the 9 activations (N, width) in the compute dtype)."""
    acts, sigma, rgb3 = _vanilla_forward(ws, enc_x, enc_d)
    return rgb3, sigma, acts


def _mask(act, v, cd):
    """where(act > 0, v, 0) cast to ``cd``: the ReLU mask from the stored
    activation."""
    return torch.where(act.to(F32) > 0, v, 0.0).to(cd)


def _dwt(delta, w):
    """delta (T, N) @ w (M, N)^T -> (T, M) f32."""
    return torch.matmul(delta.to(F32), w.to(F32).T)


def _dxw(a, delta):
    """a (T, M)^T @ delta (T, N) -> (M, N) f32."""
    return torch.matmul(a.to(F32).T, delta.to(F32))


def _bsum(delta):
    return delta.to(F32).sum(0, keepdim=True)


def grads_of_jobs(jobs, dxw=None):
    """The grads of a weight tuple from its backward's weight-grad jobs, a
    list of (A, delta, bias) in the order of the tuple: ``dxw(A, delta
    rounded to A's dtype)`` (default ``_dxw``, one f32 product) and, with
    bias, the f32 column sums of delta as stored.  The lists are the
    kernels' own (the ``add_job`` calls of csrc/*.cu), which
    ``ops.wgrad_reduce`` takes too."""
    out = []
    for a, d, bias in jobs:
        out.append((dxw or _dxw)(a, d.to(a.dtype)))
        if bias:
            out.append(_bsum(d))
    return tuple(out)


def vanilla_mlp_bwd_plain(ws, enc_x, enc_d, g_rgb, g_sigma, rgb3, acts):
    """``_vanilla_bwd_math`` (fused_mlp.py:195-246) in plain PyTorch, cast
    for cast: the 24 f32 grads of the weight tuple from the row-land
    cotangents g_rgb (3, N), g_sigma (N,) f32 and the forward's rgb3 (3, N)
    and 9 activations."""
    return grads_of_jobs(vanilla_wgrad_jobs(ws, enc_x, enc_d, g_rgb, g_sigma,
                                            rgb3, acts))


def vanilla_wgrad_jobs(ws, enc_x, enc_d, g_rgb, g_sigma, rgb3, acts):
    """The deltas of ``vanilla_mlp_bwd_plain`` as its 13 weight-grad jobs
    (csrc/fused_mlp_bwd.cu:221-233), each delta (N, k) with unit column
    stride as the kernel's; dbvec stays f32."""
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6,
     wsig, bsig, wb, bb, wr1a, wr1b, br1, wr2, br2) = ws
    h1, h2, h3, h4, z5, z6, z7, bvec, r1 = acts
    cd = enc_x.dtype
    g_rgb, g_sigma, rgb3 = g_rgb.to(F32), g_sigma.to(F32), rgb3.to(F32)
    dlogit3 = (g_rgb * rgb3 * (1.0 - rgb3)).to(cd)              # (3, N)
    dr1 = _mask(r1, torch.matmul(dlogit3.to(F32).T, wr2.to(F32).T), cd)
    dbvec = _dwt(dr1, wr1a)                                      # f32
    gsig_c = g_sigma.to(cd)[:, None]                             # (N, 1)
    dz7 = _dwt(dbvec.to(cd), wb) + gsig_c.to(F32) * wsig.to(F32)[:, 0]
    dz7 = _mask(z7, dz7, cd)
    dz6 = _mask(z6, _dwt(dz7, w6), cd)
    dz5 = _mask(z5, _dwt(dz6, w5), cd)
    dh4 = _mask(h4, _dwt(dz5, w4b), cd)
    dh3 = _mask(h3, _dwt(dh4, w3), cd)
    dh2 = _mask(h2, _dwt(dh3, w2), cd)
    dh1 = _mask(h1, _dwt(dh2, w1), cd)
    return [(enc_x, dh1, True), (h1, dh2, True), (h2, dh3, True),
            (h3, dh4, True), (enc_x, dz5, False), (h4, dz5, True),
            (z5, dz6, True), (z6, dz7, True), (z7, gsig_c, True),
            (z7, dbvec, True), (bvec, dr1, False), (enc_d, dr1, True),
            (r1, dlogit3.T.contiguous(), True)]


def vanilla_mlp_bwd_recompute_plain(ws, enc_x, enc_d, g_rgb, g_sigma,
                                    fwd=None):
    """``_vanilla_bwd_tile`` (fused_mlp.py:181-192) in plain PyTorch: the
    forward recomputed, then ``vanilla_mlp_bwd_plain`` on its activations
    and rgb3.  ``fwd`` = (rgb3, acts) gives the forward instead: the card's
    checks differentiate through the kernel's own forward, which the kernel
    rebuilds bit for bit and whose bf16 rounding the plain forward does not
    share."""
    if fwd is None:
        acts, _, rgb3 = _vanilla_forward(ws, enc_x, enc_d)
    else:
        rgb3, acts = fwd
    return vanilla_mlp_bwd_plain(ws, enc_x, enc_d, g_rgb, g_sigma, rgb3, acts)


def prop_mlp_bwd_plain(ws, enc, g):
    """``_prop_bwd_kernel`` with ``_prop_bwd_math`` (fused_mlp.py:493,
    :506-536) in plain PyTorch: the forward recomputed, then
    ``prop_mlp_bwd_res_plain`` on its activations."""
    return prop_mlp_bwd_res_plain(ws, enc, g, _prop_forward(ws, enc)[0])


def prop_mlp_bwd_res_plain(ws, enc, g, acts):
    """``_prop_bwd_res_kernel`` with ``_prop_bwd_math`` (fused_mlp.py:499,
    :506-536) in plain PyTorch, cast for cast: the 10 f32 grads of the
    weight tuple from g (N,) f32 and the stored activations h1..h4."""
    return grads_of_jobs(prop_wgrad_jobs(ws, enc, g, acts))


def prop_wgrad_jobs(ws, enc, g, acts):
    """The deltas of ``prop_mlp_bwd_res_plain`` as its 5 weight-grad jobs
    (csrc/fused_mlp_bwd.cu:274-278)."""
    w0, b0, w1, b1, w2, b2, w3, b3, wo, bo = ws
    cd = enc.dtype
    h1, h2, h3, h4 = acts
    go = g.to(F32).to(cd)[:, None]                               # (N, 1)
    dh4 = _mask(h4, go.to(F32) * wo.to(F32)[:, 0], cd)
    dh3 = _mask(h3, _dwt(dh4, w3), cd)
    dh2 = _mask(h2, _dwt(dh3, w2), cd)
    dh1 = _mask(h1, _dwt(dh2, w1), cd)
    return [(enc, dh1, True), (h1, dh2, True), (h2, dh3, True),
            (h3, dh4, True), (h4, go, True)]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _prop_dims(ws, enc):
    n, dx = enc.shape
    h = ws[0].shape[1]
    check_shapes(ws, [(0, (dx, h)), (2, (h, h)), (4, (h, h)), (6, (h, h)),
                      (8, (h, 1))], PROP_BIASES)
    return n, dx, h


def _vanilla_dims(ws, enc_x, enc_d):
    n, dx = enc_x.shape
    dd = enc_d.shape[1]
    h, bn, r = ws[0].shape[1], ws[13].shape[1], ws[19].shape[1]
    check_shapes(ws, [(0, (dx, h)), (2, (h, h)), (4, (h, h)), (6, (h, h)),
                      (8, (dx, h)), (9, (h, h)), (11, (h, h)), (13, (h, bn)),
                      (15, (bn, 1)), (17, (bn, bn)), (19, (bn, r)),
                      (20, (dd, r)), (22, (r, 3))], VANILLA_BIASES)
    return n, dx, dd, h, bn, r


def _act_widths(h, bn, r):
    """Widths of h1 h2 h3 h4 z5 z6 z7 bvec r1."""
    return (h, h, h, h, h, h, bn, bn, r)


# library and C signature of each kernel (csrc/<library>.cu)
register({
    "prop_mlp_fwd": ("fused_mlp", [PTR, U64P, I64, INT, INT, PTR, INTP]),
    "prop_mlp_fwd_res": ("fused_mlp", [PTR, U64P, I64, INT, INT, PTR, U64P,
                                       INTP]),
    "vanilla_mlp_fwd": ("fused_mlp", [PTR, PTR, U64P, I64, INTP, PTR, PTR,
                                      INTP]),
    "vanilla_mlp_fwd_res": ("fused_mlp", [PTR, PTR, U64P, I64, INTP, PTR,
                                          PTR, U64P, INTP]),
    "vanilla_mlp_bwd": ("fused_mlp_bwd", [PTR, PTR, PTR, PTR, PTR, U64P,
                                          U64P, I64, INTP, U64P, PTR, INT,
                                          U64P]),
    "prop_mlp_bwd": ("fused_mlp_bwd", [PTR, PTR, U64P, I64, INT, INT, PTR,
                                       PTR, PTR, PTR, I64, I64, U64P]),
    "prop_mlp_bwd_res": ("fused_mlp_bwd", [PTR, PTR, U64P, I64, INT, INT,
                                           U64P, PTR, PTR, PTR, I64, I64,
                                           U64P]),
    "vanilla_mlp_bwd_recompute": ("fused_mlp_recompute", [
        PTR, PTR, PTR, PTR, U64P, I64, INTP, U64P, U64P, PTR, I64, I64,
        U64P]),
})


def _splits(n: int) -> int:
    """K-splits of the weight-grad pass for ``n`` points."""
    return max(1, min(MAX_SPLITS, math.ceil(n / ROWS_PER_SPLIT)))


def prop_mlp_fwd(ws, enc: torch.Tensor, device=None) -> torch.Tensor:
    """Fused ProposalNetwork forward: enc (N, Dx) -> raw density (N,) f32.

    ``device`` defaults to ``cuda``; the operands must lie there.  On the CPU
    (``device="cpu"``) this is ``prop_mlp_plain``.
    """
    return _prop_fwd(ws, enc, device, res=False)


def prop_mlp_fwd_res(ws, enc: torch.Tensor, device=None):
    """The proposal training forward of ``prop_store_residuals=True``:
    ``prop_mlp_fwd``'s density and the 4 activations h1 h2 h3 h4, (N,
    width) each in the compute dtype, for ``prop_mlp_bwd_res``.  On the CPU
    this is ``prop_mlp_fwd_res_plain``."""
    return _prop_fwd(ws, enc, device, res=True)


def _prop_fwd(ws, enc, device, res: bool):
    dev = resolve_device(device)
    check_operands(ws, (enc,), N_PROP_WS, PROP_BIASES, dev)
    n, dx, h = _prop_dims(ws, enc)
    if dev.type == "cpu":
        density, acts = prop_mlp_fwd_res_plain(ws, enc)
        return (density, acts) if res else density
    out = torch.empty(n, dtype=F32, device=enc.device)
    acts = tuple(torch.empty((n, h), dtype=enc.dtype, device=enc.device)
                 for _ in range(N_PROP_ACTS)) if res else ()
    if n > 0:
        name = "prop_mlp_fwd_res" if res else "prop_mlp_fwd"
        extra = (pointers(acts),) if res else ()
        body = ctypes.c_int(-1)
        launch(name, enc.dtype, enc.device, enc.data_ptr(), pointers(ws), n,
               dx, h, out.data_ptr(), *extra, ctypes.byref(body))
        count_body(name, prop_body_name(body.value, res))
    return (out, acts) if res else out


def prop_body_name(cons: int, res: bool) -> str:
    """The name of the body that a ``prop_mlp_fwd`` (``prop_mlp_fwd_res``
    with ``res``) launch ran, from what its C entry reports:
    "prop_frame_kernel<eval|res> x2" (the frame, two consumer warpgroups,
    128-point tiles), "x1" (one, 64-point tiles) or, for 0,
    "prop_mlp_fwd_kernel" (the 64-row tile: f32, and bf16 where no frame
    fits)."""
    if cons == 0:
        return "prop_mlp_fwd_kernel"
    return f"prop_frame_kernel<{'res' if res else 'eval'}> x{cons}"


def _vanilla_fwd(ws, enc_x, enc_d, device, res: bool):
    dev = resolve_device(device)
    check_operands(ws, (enc_x, enc_d), N_VANILLA_WS, VANILLA_BIASES, dev)
    n, dx, dd, h, bn, r = _vanilla_dims(ws, enc_x, enc_d)
    if dev.type == "cpu":
        rgb3, sigma, acts = vanilla_mlp_fwd_res_plain(ws, enc_x, enc_d)
        return (rgb3, sigma, acts) if res else (rgb3, sigma)
    name = "vanilla_mlp_fwd_res" if res else "vanilla_mlp_fwd"
    like = dict(device=enc_x.device)
    rgb3 = torch.empty((3, n), dtype=F32, **like)
    sigma = torch.empty(n, dtype=F32, **like)
    acts = tuple(torch.empty((n, w), dtype=enc_x.dtype, **like)
                 for w in _act_widths(h, bn, r)) if res else ()
    if n > 0:
        dims = (ctypes.c_int * 5)(dx, dd, h, bn, r)
        extra = (pointers(acts),) if res else ()
        body = ctypes.c_int(-1)
        launch(name, enc_x.dtype, enc_x.device, enc_x.data_ptr(),
               enc_d.data_ptr(), pointers(ws), n, dims, rgb3.data_ptr(),
               sigma.data_ptr(), *extra, ctypes.byref(body))
        count_body(name, vanilla_body_name(body.value, res))
    return (rgb3, sigma, acts) if res else (rgb3, sigma)


def vanilla_body_name(cons: int, res: bool) -> str:
    """The name of the body that a ``vanilla_mlp_fwd`` (``vanilla_mlp_fwd_res``
    with ``res``) launch ran, from what its C entry reports:
    "vanilla_frame_kernel<eval|res> x2" (the frame, two consumer
    warpgroups, 128-point tiles), "x1" (one, 64-point tiles) or, for 0,
    "vanilla_mlp_fwd_kernel" (the 64-row tile: f32, and bf16 where no frame
    fits)."""
    if cons == 0:
        return "vanilla_mlp_fwd_kernel"
    return f"vanilla_frame_kernel<{'res' if res else 'eval'}> x{cons}"


def vanilla_mlp_fwd(ws, enc_x: torch.Tensor, enc_d: torch.Tensor,
                    device=None):
    """Fused VanillaNeRF forward: enc_x (N, Dx), enc_d (N, Dd) ->
    (rgb3 (3, N) f32, raw sigma (N,) f32).

    ``device`` defaults to ``cuda``; the operands must lie there.  On the CPU
    (``device="cpu"``) this is ``vanilla_mlp_plain``.
    """
    return _vanilla_fwd(ws, enc_x, enc_d, device, res=False)


def vanilla_mlp_fwd_res(ws, enc_x: torch.Tensor, enc_d: torch.Tensor,
                        device=None):
    """The training forward: ``vanilla_mlp_fwd``'s outputs and the 9
    activations h1 h2 h3 h4 z5 z6 z7 bvec r1, (N, width) each in the compute
    dtype, for ``vanilla_mlp_bwd``.  On the CPU this is
    ``vanilla_mlp_fwd_res_plain``."""
    return _vanilla_fwd(ws, enc_x, enc_d, device, res=True)


def _grad_buffers(ws, device):
    return tuple(torch.empty(w.shape, dtype=F32, device=device) for w in ws)


def vanilla_mlp_bwd(ws, enc_x, enc_d, g_rgb, g_sigma, rgb3, acts,
                    device=None):
    """Fused VanillaNeRF backward over stored activations: the 24 f32 grads
    of the weight tuple, in its order and shapes.

    g_rgb (3, N) and g_sigma (N,) are the f32 cotangents of the forward's
    outputs; rgb3 (3, N) f32 and ``acts`` are what ``vanilla_mlp_fwd_res``
    returned.  On the CPU this is ``vanilla_mlp_bwd_plain``.
    """
    dev = resolve_device(device)
    check_operands(ws, (enc_x, enc_d), N_VANILLA_WS, VANILLA_BIASES, dev)
    n, dx, dd, h, bn, r = _vanilla_dims(ws, enc_x, enc_d)
    cd = enc_x.dtype
    if len(acts) != N_VANILLA_ACTS:
        raise ValueError(f"expected {N_VANILLA_ACTS} activations, "
                         f"got {len(acts)}")
    for i, (a, w) in enumerate(zip(acts, _act_widths(h, bn, r))):
        check_tensor(a, (n, w), cd, dev, f"activation {i}")
    check_tensor(g_rgb, (3, n), F32, dev, "g_rgb")
    check_tensor(g_sigma, (n,), F32, dev, "g_sigma")
    check_tensor(rgb3, (3, n), F32, dev, "rgb3")
    if dev.type == "cpu":
        return vanilla_mlp_bwd_plain(ws, enc_x, enc_d, g_rgb, g_sigma, rgb3,
                                     acts)
    like = dict(device=enc_x.device)
    # dlogit gsig dr1 dbvec dz7 dz6 dz5 dh4 dh3 dh2 dh1
    deltas = tuple(
        torch.empty((n, w), dtype=F32 if i == 3 else cd, **like)
        for i, w in enumerate((3, 1, r, bn, bn, h, h, h, h, h, h)))
    splits = _splits(n)
    partial = torch.empty(splits * sum(w.numel() for w in ws), dtype=F32,
                          **like)
    grads = _grad_buffers(ws, enc_x.device)
    dims = (ctypes.c_int * 5)(dx, dd, h, bn, r)
    launch("vanilla_mlp_bwd", cd, enc_x.device, enc_x.data_ptr(),
           enc_d.data_ptr(), g_rgb.data_ptr(), g_sigma.data_ptr(),
           rgb3.data_ptr(), pointers(acts), pointers(ws), n, dims,
           pointers(deltas), partial.data_ptr(), splits, pointers(grads))
    return grads


def chunk_rows(rows_per_split: int) -> int:
    """Points per chunk of a recompute backward: as many whole K-splits of
    ``rows_per_split`` points as fit in ``CHUNK_ROWS``, at least one."""
    return max(1, CHUNK_ROWS // rows_per_split) * rows_per_split


def vanilla_mlp_bwd_recompute(ws, enc_x, enc_d, g_rgb, g_sigma,
                              device=None):
    """Fused VanillaNeRF backward in the recompute form: the 24 f32 grads of
    the weight tuple from the encodings and the f32 cotangents g_rgb (3, N)
    and g_sigma (N,) alone.  The points are walked in chunks of whole
    K-splits (``chunk_rows``), each chunk's activations rebuilt into scratch
    of the chunk's size; the grads do not depend on the chunk size.  On the
    CPU this is ``vanilla_mlp_bwd_recompute_plain``."""
    dev = resolve_device(device)
    check_operands(ws, (enc_x, enc_d), N_VANILLA_WS, VANILLA_BIASES, dev)
    n, dx, dd, h, bn, r = _vanilla_dims(ws, enc_x, enc_d)
    check_tensor(g_rgb, (3, n), F32, dev, "g_rgb")
    check_tensor(g_sigma, (n,), F32, dev, "g_sigma")
    splits = _splits(n)
    rows = math.ceil(n / splits) if n else ROWS_PER_SPLIT
    chunk = chunk_rows(rows)
    if dev.type == "cpu":
        return vanilla_mlp_bwd_recompute_plain(ws, enc_x, enc_d, g_rgb,
                                               g_sigma)
    cd = enc_x.dtype
    like = dict(device=enc_x.device)
    m = min(n, chunk)
    acts = tuple(torch.empty((m, w), dtype=cd, **like)
                 for w in _act_widths(h, bn, r))
    # dlogit gsig dr1 dbvec dz7 dz6 dz5 dh4 dh3 dh2 dh1
    deltas = tuple(
        torch.empty((m, w), dtype=F32 if i == 3 else cd, **like)
        for i, w in enumerate((3, 1, r, bn, bn, h, h, h, h, h, h)))
    partial = torch.empty(min(splits, chunk // rows)
                          * sum(w.numel() for w in ws), dtype=F32, **like)
    grads = _grad_buffers(ws, enc_x.device)
    dims = (ctypes.c_int * 5)(dx, dd, h, bn, r)
    launch("vanilla_mlp_bwd_recompute", cd, enc_x.device, enc_x.data_ptr(),
           enc_d.data_ptr(), g_rgb.data_ptr(), g_sigma.data_ptr(),
           pointers(ws), n, dims, pointers(acts), pointers(deltas),
           partial.data_ptr(), rows, chunk, pointers(grads))
    return grads


def prop_mlp_bwd(ws, enc: torch.Tensor, g: torch.Tensor, device=None):
    """Fused ProposalNetwork backward in the recompute form: the 10 f32
    grads of the weight tuple from g (N,) f32, the cotangent of the raw
    density.  The points are walked in chunks of whole K-splits
    (``chunk_rows``), each chunk's activations rebuilt and its deltas
    written into scratch of the chunk's size; the grads do not depend on the
    chunk size.  On the CPU this is ``prop_mlp_bwd_plain``."""
    return _prop_bwd(ws, enc, g, None, device)


def prop_mlp_bwd_res(ws, enc: torch.Tensor, g: torch.Tensor, acts,
                     device=None):
    """Fused ProposalNetwork backward over stored activations: the 10 f32
    grads of the weight tuple from g (N,) f32 and the 4 activations that
    ``prop_mlp_fwd_res`` returned, walked in chunks as ``prop_mlp_bwd`` is;
    the grads equal ``prop_mlp_bwd``'s.  On the CPU this is
    ``prop_mlp_bwd_res_plain``."""
    return _prop_bwd(ws, enc, g, acts, device)


def _prop_bwd(ws, enc, g, acts, device):
    dev = resolve_device(device)
    check_operands(ws, (enc,), N_PROP_WS, PROP_BIASES, dev)
    n, dx, h = _prop_dims(ws, enc)
    cd = enc.dtype
    check_tensor(g, (n,), F32, dev, "g")
    if acts is not None:
        if len(acts) != N_PROP_ACTS:
            raise ValueError(f"expected {N_PROP_ACTS} activations, "
                             f"got {len(acts)}")
        for i, a in enumerate(acts):
            check_tensor(a, (n, h), cd, dev, f"activation {i}")
    splits = _splits(n)
    rows = math.ceil(n / splits) if n else ROWS_PER_SPLIT
    chunk = chunk_rows(rows)
    if dev.type == "cpu":
        return (prop_mlp_bwd_plain(ws, enc, g) if acts is None
                else prop_mlp_bwd_res_plain(ws, enc, g, acts))
    like = dict(device=enc.device)
    m = min(n, chunk)
    go = torch.empty(m, dtype=cd, **like)
    dhs = torch.empty((N_PROP_ACTS, m, h), dtype=cd, **like)
    partial = torch.empty(min(splits, chunk // rows)
                          * sum(w.numel() for w in ws), dtype=F32, **like)
    grads = _grad_buffers(ws, enc.device)
    if acts is None:
        name, hs = "prop_mlp_bwd", torch.empty((N_PROP_ACTS, m, h), dtype=cd,
                                                **like).data_ptr()
    else:
        name, hs = "prop_mlp_bwd_res", pointers(acts)
    launch(name, cd, enc.device, enc.data_ptr(), g.data_ptr(), pointers(ws),
           n, dx, h, hs, go.data_ptr(), dhs.data_ptr(), partial.data_ptr(),
           rows, chunk, pointers(grads))
    return grads


# ---------------------------------------------------------------------------
# autograd (the custom_vjp of make_vanilla_fused / make_prop_fused)
# ---------------------------------------------------------------------------

class VanillaMLP(torch.autograd.Function):
    """(device, enc_x, enc_d, *ws) -> (rgb3 (3, N), sigma (N,)) through
    ``vanilla_mlp_fwd_res``; the backward is ``vanilla_mlp_bwd``.

    ``ws`` are the 24 f32 parameters (matrices (in, out), biases (1, out)),
    cast inside to the encodings' dtype.  It saves what
    ``make_vanilla_fused``'s ``fused_fwd`` keeps (fused_mlp.py:375-379): the
    weights, the encodings, the 9 activations and rgb3.  The encodings get
    no gradient.
    """

    @staticmethod
    def forward(ctx, device, enc_x, enc_d, *ws):
        wsc = prep_weights(ws, enc_x.dtype)
        rgb3, sigma, acts = vanilla_mlp_fwd_res(wsc, enc_x, enc_d,
                                                device=device)
        ctx.device = device
        ctx.save_for_backward(enc_x, enc_d, rgb3, *acts, *wsc)
        return rgb3, sigma

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        enc_x, enc_d, rgb3, *rest = ctx.saved_tensors
        acts, wsc = rest[:N_VANILLA_ACTS], rest[N_VANILLA_ACTS:]
        grads = vanilla_mlp_bwd(wsc, enc_x, enc_d,
                                g_rgb.to(F32).contiguous(),
                                g_sigma.to(F32).contiguous(), rgb3, acts,
                                device=ctx.device)
        return (None, None, None, *grads)


class VanillaMLPRecompute(torch.autograd.Function):
    """``VanillaMLP`` in the recompute form (``store_residuals=False``): the
    forward is ``vanilla_mlp_fwd`` and saves what ``make_vanilla_fused``'s
    ``fused_fwd`` keeps then (fused_mlp.py:375-379), the weights and the
    encodings; the backward is ``vanilla_mlp_bwd_recompute``."""

    @staticmethod
    def forward(ctx, device, enc_x, enc_d, *ws):
        wsc = prep_weights(ws, enc_x.dtype)
        ctx.device = device
        ctx.save_for_backward(enc_x, enc_d, *wsc)
        return vanilla_mlp_fwd(wsc, enc_x, enc_d, device=device)

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        enc_x, enc_d, *wsc = ctx.saved_tensors
        grads = vanilla_mlp_bwd_recompute(
            wsc, enc_x, enc_d, g_rgb.to(F32).contiguous(),
            g_sigma.to(F32).contiguous(), device=ctx.device)
        return (None, None, None, *grads)


class PropMLP(torch.autograd.Function):
    """(device, enc, *ws) -> raw density (N,) through ``prop_mlp_fwd``; the
    backward is ``prop_mlp_bwd``, which recomputes the forward.

    Saves what ``make_prop_fused``'s ``fused_fwd`` keeps
    (fused_mlp.py:587-589): the weights and the encoding.
    """

    @staticmethod
    def forward(ctx, device, enc, *ws):
        wsc = prep_weights(ws, enc.dtype)
        ctx.device = device
        ctx.save_for_backward(enc, *wsc)
        return prop_mlp_fwd(wsc, enc, device=device)

    @staticmethod
    def backward(ctx, g):
        enc, *wsc = ctx.saved_tensors
        grads = prop_mlp_bwd(wsc, enc, g.to(F32).contiguous(),
                             device=ctx.device)
        return (None, None, *grads)


class PropMLPRes(torch.autograd.Function):
    """``PropMLP`` in the residual form (``prop_store_residuals=True``): the
    forward is ``prop_mlp_fwd_res`` and saves what ``make_prop_fused``'s
    ``fused_fwd`` keeps then (fused_mlp.py:587-589), the weights, the
    encoding and the 4 activations; the backward is ``prop_mlp_bwd_res``."""

    @staticmethod
    def forward(ctx, device, enc, *ws):
        wsc = prep_weights(ws, enc.dtype)
        density, acts = prop_mlp_fwd_res(wsc, enc, device=device)
        ctx.device = device
        ctx.save_for_backward(enc, *acts, *wsc)
        return density

    @staticmethod
    def backward(ctx, g):
        enc, *rest = ctx.saved_tensors
        acts, wsc = rest[:N_PROP_ACTS], rest[N_PROP_ACTS:]
        grads = prop_mlp_bwd_res(wsc, enc, g.to(F32).contiguous(), acts,
                                 device=ctx.device)
        return (None, None, *grads)
