"""The split-K weight-grad pass on its own (nerf_tpu_torch.ops.wgrad): its
plain version against float64 products over a grid of the backwards' job
shapes, against the weight-grad half of the plain backwards on their own
deltas, and through those against the Pallas backwards of nerf_tpu.ops in
interpret mode; the wrapper's dispatch and checks.  The CUDA kernel is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import configs, jax_variables, port_models
from torch_port_common import random_params
from nerf_tpu.models import ProposalNetwork as JaxProp
from nerf_tpu.models import VanillaNeRF as JaxVanilla
from nerf_tpu.ops import (
    make_prop_fused, make_vanilla_fused, prop_weights_from_params,
    ref_spatial_weights_from_params, vanilla_weights_from_params,
)
from nerf_tpu.ops import ref_fused as jref
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.models import ProposalNetwork, VanillaNeRF
from nerf_tpu_torch.ops import fused_mlp, ref_fused
from nerf_tpu_torch.ops import wgrad as wgrad_lib

BF16, F32 = torch.bfloat16, torch.float32
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
U32 = 2.0 ** -24        # f32 unit roundoff
U16 = 2.0 ** -8         # bf16 unit roundoff (8 significant bits)
N_GRID, ROWS = 613, 128  # 5 K-splits, the last of 101 points
CHUNK = 256              # a chunk of two whole splits

# the Pallas backwards against the plain pass on the plain backwards'
# deltas: the limits of tests/test_torch_ops.py (vanilla, proposal) and
# tests/test_torch_ref_train.py (Ref-NeRF spatial), which hold the plain
# backwards themselves against the same Pallas kernels
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_GRAD_REL = 1e-4
REF_TOLS = {F32: dict(rtol=2e-4, atol=1e-5), BF16: dict(rtol=0.05, atol=0.02)}


def _abs_products(a, d, rows):
    """(sum over points of |a| |d|, sum over splits of |partial|), float64,
    with d rounded as the product rounds it."""
    a64, d64 = a.double(), d.to(a.dtype).double()
    parts = [a64[lo:lo + rows].T @ d64[lo:lo + rows]
             for lo in range(0, a.shape[0], rows)]
    return a64.abs().T @ d64.abs(), sum(p.abs() for p in parts)


def _assert_within(got, exact, bound, name):
    err = (got.double() - exact).abs()
    assert bool((err <= bound + 1e-30).all()), (
        name, float((err - bound).max()))


LAYOUTS = ["bf16", "f32", "strided_f32", "strided_bf16"]


def _grid_jobs(m, k, layout, seed):
    """A (N, m) bf16 and delta (N, k): contiguous bf16 or f32, or columns
    [5, 5 + k) of an (N, k + 13) f32 or bf16 array (an f32 one is the heads'
    cotangent of the spatial recompute backward); a second job shares delta
    and takes a 128-wide A without bias."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(N_GRID, m))).to(BF16)
    a2 = torch.from_numpy(rng.normal(size=(N_GRID, 128))).to(BF16)
    dt = F32 if "f32" in layout else BF16
    if layout.startswith("strided"):
        wide = torch.from_numpy(rng.normal(size=(N_GRID, k + 13))).to(dt)
        d = wide[:, 5:5 + k]
        assert d.stride(0) > k and d.storage_offset() == 5
    else:
        d = torch.from_numpy(rng.normal(size=(N_GRID, k))).to(dt)
    return [(a, d, True), (a2, d, False)]


@pytest.mark.parametrize("round_partial", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 3, 9, 128, 256])
@pytest.mark.parametrize("m", [63, 27, 128, 256])
def test_plain_pass_matches_float64(m, k, layout, round_partial):
    """wgrad_reduce on the CPU against float64 A^T delta (delta rounded to
    bf16) and float64 column sums of the unrounded delta.  The f32 sums
    bound the error by (points + splits) u32 sum |a||d| (u32 = 2^-24, any
    order of summation); each split's partial rounded to bf16 adds at most
    u16 |partial| (u16 = 2^-8).  Then the chunked walk: two chunks of whole
    splits, the second reduced onto the first, equal one pass exactly."""
    jobs = _grid_jobs(m, k, layout, seed=m * 1000 + k)
    got = ops.wgrad_reduce(jobs, ROWS, round_partial, device="cpu")
    assert [tuple(g.shape) for g in got] == [(m, k), (1, k), (128, k)]
    splits = -(-N_GRID // ROWS)
    for (a, d, _), g in zip(jobs, (got[0], got[2])):
        absum, parts = _abs_products(a, d, ROWS)
        bound = (N_GRID + splits) * U32 * absum
        if round_partial:
            bound = bound + 1.01 * U16 * parts
        exact = a.double().T @ d.to(BF16).double()
        _assert_within(g, exact, bound, "dW")
    d64 = jobs[0][1].double()
    _assert_within(got[1], d64.sum(0, keepdim=True),
                   (N_GRID + splits) * U32 * d64.abs().sum(0, keepdim=True),
                   "db")

    walked = None
    for c0 in range(0, N_GRID, CHUNK):
        walked = ops.wgrad_reduce(
            [(a[c0:c0 + CHUNK], d[c0:c0 + CHUNK], b) for a, d, b in jobs],
            ROWS, round_partial, grads=walked, device="cpu")
    for g, w in zip(got, walked):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the rounding gate's two yardsticks (the card holds the bf16 kernel's
# summation between them)
# ---------------------------------------------------------------------------

def _numpy_splits(jobs, rows, round_partial, grads, split):
    """The frame of wgrad_reduce_plain in numpy: ``split(a, d)`` gives a
    split's f32 (dW, db) from A (float32) and delta (its float32 values and
    the values rounded to bf16), each dW rounded to bf16 with
    round_partial, the splits summed in float32 in order."""
    starts = iter([g.numpy() for g in grads] if grads is not None else [
        np.zeros(s, np.float32) for s in wgrad_lib.grad_shapes(jobs)])
    out = []
    for a, d, bias in jobs:
        a32 = a.float().numpy()
        draw, dr = d.float().numpy(), d.to(a.dtype).float().numpy()
        w = next(starts)
        b = next(starts) if bias else None
        for lo in range(0, max(a.shape[0], 1), rows):
            pw, pb = split(a32[lo:lo + rows], draw[lo:lo + rows],
                           dr[lo:lo + rows])
            if round_partial:
                pw = torch.from_numpy(pw).to(BF16).float().numpy()
            w = (w + pw).astype(np.float32)
            if bias:
                b = (b + pb).astype(np.float32)
        out.append(w)
        if bias:
            out.append(b)
    return out


def _numpy_f64(a, draw, dr):
    return ((a.astype(np.float64).T @ dr.astype(np.float64))
            .astype(np.float32),
            draw.astype(np.float64).sum(0, keepdims=True).astype(np.float32))


def _numpy_in_order(a, draw, dr):
    w = np.zeros((a.shape[1], dr.shape[1]), np.float32)
    b = np.zeros((1, dr.shape[1]), np.float32)
    for p in range(a.shape[0]):
        w = (w + np.outer(a[p], dr[p])).astype(np.float32)
        b = (b + draw[p:p + 1]).astype(np.float32)
    return w, b


YARDSTICK_CASES = [(63, 256, "bf16"), (256, 3, "strided_f32"),
                   (27, 128, "f32"), (128, 9, "strided_bf16")]


@pytest.mark.parametrize("with_grads", [False, True])
@pytest.mark.parametrize("round_partial", [False, True])
@pytest.mark.parametrize("m, k, layout", YARDSTICK_CASES)
def test_f64_yardstick_matches_numpy_float64(m, k, layout, round_partial,
                                             with_grads):
    """wgrad_reduce_f64: each split's products and bias sums in float64,
    rounded once to float32 (then to bf16 with round_partial), the splits
    summed in float32 in order from 0 or from given grads, equal to a
    numpy float64 loop.  The products of bf16 values are exact in float64
    and these sums span few enough binades to be exact in any order, so
    the two agree to the bit."""
    jobs = _grid_jobs(m, k, layout, seed=m + k)
    grads = ([torch.randn(s, generator=torch.Generator().manual_seed(1))
              for s in wgrad_lib.grad_shapes(jobs)] if with_grads else None)
    got = wgrad_lib.wgrad_reduce_f64(jobs, ROWS, round_partial, grads)
    want = _numpy_splits(jobs, ROWS, round_partial, grads, _numpy_f64)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(w))


@pytest.mark.parametrize("round_partial", [False, True])
@pytest.mark.parametrize("m, k, layout", YARDSTICK_CASES[:3])
def test_in_order_yardstick_matches_numpy_float32(m, k, layout,
                                                  round_partial):
    """wgrad_reduce_in_order: each point's product added to a float32 sum
    in point order within a split (one rounding a point), the bias of the
    unrounded delta likewise, equal to numpy's float32 loop point by point,
    on the ragged grid (the last split 101 points) with given grads."""
    jobs = _grid_jobs(m, k, layout, seed=m * k)
    grads = [torch.randn(s, generator=torch.Generator().manual_seed(2))
             for s in wgrad_lib.grad_shapes(jobs)]
    got = wgrad_lib.wgrad_reduce_in_order(jobs, ROWS, round_partial, grads)
    want = _numpy_splits(jobs, ROWS, round_partial, grads, _numpy_in_order)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(w))


def test_gate_reading_of_a_hand_built_split():
    """Points whose in-order f32 sum and f64 sum differ: 1 * 1, then four
    products of 2^-24, each of which an f32 sum of 1 rounds away (a tie,
    to even), while f64 keeps them: 1 + 2^-22, exact in f32.  The in-order
    sum reads a relative error of 2^-22 / (1 + 2^-22), 2 units in the last
    place; the f64 yardstick reads 0."""
    tiny = 2.0 ** -12
    a = torch.tensor([[1.0]] + [[tiny]] * 4, dtype=BF16)
    d = torch.tensor([[1.0]] + [[tiny]] * 4, dtype=BF16)
    jobs = [(a, d, False)]
    exact = wgrad_lib.wgrad_reduce_f64(jobs, 16)[0]
    assert float(exact) == 1.0 + 2.0 ** -22
    in_order = wgrad_lib.summation_error(
        wgrad_lib.wgrad_reduce_in_order(jobs, 16)[0], exact)
    assert in_order == dict(rel=2.0 ** -22 / (1.0 + 2.0 ** -22), ulps=2.0)
    assert wgrad_lib.summation_error(exact, exact) == dict(rel=0.0, ulps=0.0)


# ---------------------------------------------------------------------------
# against the plain backwards, and through them against Pallas
# ---------------------------------------------------------------------------

N, TILE = 70, 32          # the shapes of tests/test_torch_ops.py
POS_L, DIR_L = 4, 2
DX, DD = 3 * (2 * POS_L + 1), 3 * (2 * DIR_L + 1)


def _flax_params(module, *args, seed):
    template = module.init(jax.random.PRNGKey(0), *args)["params"]
    return random_params(template, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def small_nets():
    rng = np.random.default_rng(11)
    enc_x = rng.uniform(-1, 1, (N, DX)).astype(np.float32)
    enc_d = rng.uniform(-1, 1, (N, DD)).astype(np.float32)
    g_rgb = rng.normal(size=(3, N)).astype(np.float32)
    g = rng.normal(size=(N,)).astype(np.float32)
    pos = np.zeros((1, 2, 3), np.float32)
    vp = _flax_params(JaxVanilla(pos_levels=POS_L, dir_levels=DIR_L,
                                 hidden=48, bottleneck=40), pos, pos + 1,
                      seed=12)
    pp = _flax_params(JaxProp(pos_levels=POS_L, hidden=48), pos, seed=13)
    return vp, pp, enc_x, enc_d, g_rgb, g


def _f32_close(got, want, jobs):
    """Each grad against the plain backward's single f32 product: both
    within (points + splits) u32 sum |a||d| of the exact sum."""
    i = 0
    for a, d, bias in jobs:
        absum, _ = _abs_products(a, d, TILE)
        _assert_within(got[i], want[i].double(),
                       2 * (N + 4) * U32 * absum, f"grad {i}")
        i += 1
        if bias:
            col = d.double().abs().sum(0, keepdim=True)
            _assert_within(got[i], want[i].double(), 2 * (N + 4) * U32 * col,
                           f"grad {i}")
            i += 1
    assert i == len(got) == len(want)


def _assert_pallas(got, want, dtype):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, i
        if dtype == F32:
            np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL,
                                       err_msg=str(i))
        else:
            rel = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w),
                                                      1e-30)
            assert rel < BF16_GRAD_REL, (i, rel)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("net", ["vanilla", "prop"])
def test_plain_pass_is_the_plain_backwards_weight_grads(small_nets, net,
                                                        dtype):
    """The jobs of vanilla_mlp_bwd_plain / prop_mlp_bwd_res_plain (their
    deltas, csrc/fused_mlp_bwd.cu's lists) through wgrad_reduce, splits of
    TILE points, unrounded partials, against those plain backwards' grads
    and against jax.vjp of the Pallas kernels in interpret mode."""
    vp, pp, enc_x, enc_d, g_rgb, g = small_nets
    x = torch.from_numpy(enc_x).to(dtype)
    if net == "vanilla":
        v = VanillaNeRF(POS_L, DIR_L, hidden=48, bottleneck=40, dtype=dtype)
        v.load_state_dict(bridge.flax_to_state_dict(vp, "nerf"))
        ws = v.kernel_weights()
        d = torch.from_numpy(enc_d).to(dtype)
        rgb3, _, acts = ops.vanilla_mlp_fwd_res(ws, x, d, device="cpu")
        args = (ws, x, d, torch.from_numpy(g_rgb), torch.from_numpy(g),
                rgb3, acts)
        jobs = fused_mlp.vanilla_wgrad_jobs(*args)
        want = ops.vanilla_mlp_bwd_plain(*args)
        fused = make_vanilla_fused(JDT[dtype], TILE, interpret=True,
                                   store_residuals=True)
        _, vjp = jax.vjp(lambda w: fused(w, jnp.asarray(enc_x),
                                         jnp.asarray(enc_d)),
                         vanilla_weights_from_params(vp))
        (jgrads,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g)))
    else:
        p = ProposalNetwork(POS_L, hidden=48, dtype=dtype)
        p.load_state_dict(bridge.flax_to_state_dict(pp, "prop"))
        ws = p.kernel_weights()
        _, acts = ops.prop_mlp_fwd_res(ws, x, device="cpu")
        jobs = fused_mlp.prop_wgrad_jobs(ws, x, torch.from_numpy(g), acts)
        want = ops.prop_mlp_bwd_res_plain(ws, x, torch.from_numpy(g), acts)
        fused = make_prop_fused(JDT[dtype], TILE, interpret=True,
                                store_residuals=True)
        _, vjp = jax.vjp(lambda w: fused(w, jnp.asarray(enc_x)),
                         prop_weights_from_params(pp))
        (jgrads,) = vjp(jnp.asarray(g))
    got = ops.wgrad_reduce(jobs, TILE, device="cpu")
    _f32_close(got, want, jobs)
    _assert_pallas(got, jgrads, dtype)


REF_TILE = 64


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("recompute", [False, True])
def test_plain_pass_is_the_ref_spatial_weight_grads(dtype, recompute):
    """The jobs of ref_spa_bwd_plain (recompute: ref_spa_bwd_recompute_plain,
    whose heads' deltas are f32 strided views of the cotangent at offsets 0,
    2 and 11) through wgrad_reduce in splits of the tile, each partial
    rounded: equal to those plain backwards' grads within one bf16 step of
    each split's partial (u16 2 sum |partial|: the two sums may round a
    partial to neighbouring values) and the f32 sums' bound, and within the
    limits of tests/test_torch_ref_train.py of jax.vjp through the Pallas
    spatial pair in interpret mode."""
    jcfg, cfg = configs(model="ref", pallas_tile=REF_TILE,
                        bottleneck_noise=0.0, white_bkg=False,
                        use_bf16=dtype == BF16)
    v = jax_variables(configs(model="ref", pallas_tile=REF_TILE,
                              bottleneck_noise=0.0, white_bkg=False)[0],
                      seed=0, gain=1.0, bias_std=0.1)
    nerf, _ = port_models(cfg, v)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1.2, 1.2, (8 * 23, 3)).astype(np.float32)
    n = pos.shape[0]
    enc = cat_pos_pe(torch.from_numpy(pos), 10, dtype)
    g_heads = rng.normal(size=(n, jref.SPA_HEAD_DIM)).astype(np.float32)
    ws = nerf.kernel_weights()[0]
    _, _, acts = ops.ref_spa_fwd_res(ws, enc, torch.from_numpy(pos),
                                     device="cpu")
    g = torch.from_numpy(g_heads)
    jobs = ref_fused.ref_spa_wgrad_jobs(ws, enc, g, acts, recompute)
    if recompute:
        assert [d.storage_offset() for _, d, _ in jobs[-3:]] == [0, 2, 11]
        want = ops.ref_spa_bwd_recompute_plain(ws, enc, g, REF_TILE,
                                               acts=acts)
    else:
        want = ops.ref_spa_bwd_plain(ws, enc, g, acts, REF_TILE)
    got = ops.wgrad_reduce(jobs, REF_TILE, round_partial=True, device="cpu")
    splits = -(-n // REF_TILE)
    i = 0
    for a, d, bias in jobs:
        absum, parts = _abs_products(a, d, REF_TILE)
        bound = 2 * (n + splits) * U32 * absum
        if dtype == BF16:
            bound = bound + 2.02 * U16 * parts
        _assert_within(got[i], want[i].double(), bound, f"grad {i}")
        i += 1
        if bias:
            col = d.double().abs().sum(0, keepdim=True)
            _assert_within(got[i], want[i].double(),
                           2 * (n + splits) * U32 * col, f"grad {i}")
            i += 1
    assert i == len(got) == len(want) == 23

    cd = JDT[dtype]
    jenc = jnp.asarray(enc.float().numpy(), cd)
    spa = jref._make_spa_fused(cd, REF_TILE, True, True,
                               store_residuals=not recompute)
    _, vjp = jax.vjp(lambda w: spa(w, jenc, jnp.asarray(pos)),
                     ref_spatial_weights_from_params(v["nerf"]))
    (jgrads,) = vjp((jnp.asarray(g_heads), jnp.zeros((3, n), jnp.float32)))
    for i, (a, b) in enumerate(zip(got, jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   **REF_TOLS[dtype], err_msg=f"grad {i}")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _jobs(n=40, m=16, k=8, dtype=BF16):
    gen = torch.Generator().manual_seed(0)
    return [(torch.randn((n, m), generator=gen).to(dtype),
             torch.randn((n, k), generator=gen).to(dtype), True)]


def test_cpu_dispatch_counts_no_launch():
    ops.reset_launches()
    jobs = _jobs()
    got = ops.wgrad_reduce(jobs, 16, device="cpu")
    for a, b in zip(got, ops.wgrad_reduce_plain(jobs, 16)):
        assert torch.equal(a, b)
    assert not any(ops.LAUNCHES.values())


def test_wrapper_never_runs_quietly_on_cpu():
    """Without device="cpu" the wrapper targets the card: with CPU tensors
    it raises instead of taking the plain version."""
    with pytest.raises((RuntimeError, ValueError)):
        ops.wgrad_reduce(_jobs(), 16)


@pytest.mark.parametrize("fault", ["rows", "column_stride", "dtype",
                                   "too_many_jobs", "grads_shape",
                                   "rows_per_split"])
def test_wrapper_rejects_bad_jobs(fault):
    (a, d, bias), = _jobs()
    jobs, kw = [(a, d, bias)], {}
    if fault == "rows":
        jobs = [(a, d[:-1], bias)]
    elif fault == "column_stride":
        jobs = [(a, d.T.contiguous().T, bias)]
    elif fault == "dtype":
        jobs = [(a, d.to(torch.float16), bias)]
    elif fault == "too_many_jobs":
        jobs = jobs * 17
    elif fault == "grads_shape":
        kw = dict(grads=[torch.zeros(16, 8), torch.zeros(1, 7)])
    with pytest.raises(ValueError):
        ops.wgrad_reduce(jobs, 0 if fault == "rows_per_split" else 16,
                         device="cpu", **kw)
