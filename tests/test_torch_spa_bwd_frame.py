"""The plain versions that the card holds the bf16 spatial backward frame
(``csrc/spa_bwd_frame.cuh``) to, against the Pallas kernels of nerf_tpu in
interpret mode, at the shapes the card phase uses: the spatial backward
pair (ref_spa_bwd over the stored activations, ref_spa_bwd_recompute from
enc alone) through ``jax.vjp`` of ``_make_spa_fused`` with
``store_residuals`` True and False, at the width pairs and point counts of
chip_smoke.py's ``spa_bwd_frame`` phase; d(inter) rebuilt from
``ops.delta.delta_layer_plain`` calls in each form's order of the heads, as
the card phase rebuilds the frame's; the CPU dispatch of both, which counts
no launch and no body; and the names of the bodies that their C entries
report.

Tolerances: those of tests/test_ref_fused.py:185 for the fused kernels'
grads, f32 rtol 2e-4 / atol 1e-5 and bf16 rtol 0.05 / atol 0.02, for all 23
grads, but for one: in bf16 the recompute form's bias grad of the last
trunk layer (db7, grad 16) is held by its relative Frobenius error, at most
5e-3.  The Pallas kernel runs ``jax.vjp`` under ``jit``, where XLA keeps the
bf16 sum of the heads' three pullbacks in f32 (tests/test_torch_recompute.py
pins it), and db7 sums d(inter) over the points: it reads 1.3e-3 to 2.6e-3
here, a few of its small elements beyond the elementwise tolerance.
d(inter) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops import ref_fused as jref
from nerf_tpu_torch import ops
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.ops.delta import delta_layer_plain
from nerf_tpu_torch.ops.ref_fused import REF_SPA_BIASES

TILE = 64                       # Pallas tile, and the weight grads' rounding
NB = 128                        # the bottleneck (SPA_HEAD_DIM = 11 + NB)
TOLS = {torch.float32: dict(rtol=2e-4, atol=1e-5),   # test_ref_fused.py:185
        torch.bfloat16: dict(rtol=0.05, atol=0.02)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# db7 of the bf16 recompute form (see above): its relative Frobenius limit
DB7, DB7_REL = 16, 5e-3
# (H, O) and N of chip_smoke.py's spa_bwd_frame phase below its main-path
# point counts: the card tests' narrow pair and the model's own, at one
# point and either side of the frame's 128-point tile
WIDTHS = [(48, 80), (256, 256)]
NS = [1, 127, 129]


def _spa_ws(seed, h, o):
    """A seeded f32 spatial weight tuple (nerf_tpu/ops/ref_fused.py:51-63)
    at widths h, o: matrices N(0, 1 / fan_in), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    mats = [(63, h), (h, h), (h, h), (h, h), (63, h), (h, h), (h, h),
            (h, h), (h, o), (o, 2), (o, 9), (o, NB)]
    ws = []
    for i, m in enumerate(mats):
        ws.append(rng.normal(0, 1 / np.sqrt(m[0]), m).astype(np.float32))
        if i != 4:                        # w4a and w4b share b4
            ws.append(rng.normal(0, 0.1, (1, m[1])).astype(np.float32))
    return ws


def _torch_ws(ws, dtype):
    return tuple(torch.from_numpy(w).to(torch.float32 if i in REF_SPA_BIASES
                                        else dtype)
                 for i, w in enumerate(ws))


def _case(seed, h, o, n, dtype):
    """(f32 weights, enc in ``dtype``, pos, the heads' cotangent g) of a
    seeded case: points in the scene's box, g N(0, 1)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    g = rng.normal(size=(n, 11 + NB)).astype(np.float32)
    enc = cat_pos_pe(torch.from_numpy(pos), 10, dtype)
    return _spa_ws(seed, h, o), enc, torch.from_numpy(pos), torch.from_numpy(g)


def _pallas_grads(ws, enc, pos, g, dtype, recompute):
    """The 23 grads of ``_make_spa_fused`` in interpret mode for the heads'
    cotangent g (the normal target's cotangent zero), through jax.vjp:
    store_residuals False (``recompute``) or True."""
    cd = JDT[dtype]
    spa = jref._make_spa_fused(cd, TILE, True, True,
                               store_residuals=not recompute)
    jenc = jnp.asarray(enc.float().numpy(), cd)
    n = enc.shape[0]
    _, vjp = jax.vjp(lambda w: spa(w, jenc, jnp.asarray(pos.numpy())),
                     tuple(jnp.asarray(w) for w in ws))
    (grads,) = vjp((jnp.asarray(g.numpy()), jnp.zeros((3, n), jnp.float32)))
    return grads


@pytest.mark.parametrize("recompute", [False, True], ids=["res", "recompute"])
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("h, o", WIDTHS)
def test_spa_bwd_plain_matches_pallas_at_frame_shapes(h, o, n, dtype,
                                                      recompute):
    """ref_spa_bwd (on ref_spa_fwd_res's activations) and
    ref_spa_bwd_recompute on the CPU, their plain versions and the card
    phase's oracle, against the spatial pair of make_ref_fused in interpret
    mode with store_residuals True and False: all 23 grads."""
    ws, enc, pos, g = _case(1000 * h + n, h, o, n, dtype)
    wt = _torch_ws(ws, dtype)
    if recompute:
        grads = ops.ref_spa_bwd_recompute(wt, enc, g, tile=TILE,
                                          device="cpu")
    else:
        acts = ops.ref_spa_fwd_res(wt, enc, pos, device="cpu")[2]
        grads = ops.ref_spa_bwd(wt, enc, g, acts, tile=TILE, device="cpu")
    want = _pallas_grads(ws, enc, pos, g, dtype, recompute)
    assert len(grads) == len(want) == 23
    for i, (a, b) in enumerate(zip(grads, want)):
        a, b = a.numpy(), np.asarray(b, np.float32)
        assert a.dtype == np.float32 and a.shape == b.shape, i
        if recompute and dtype == torch.bfloat16 and i == DB7:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= DB7_REL, rel
            continue
        np.testing.assert_allclose(a, b, **TOLS[dtype], err_msg=f"grad {i}")


@pytest.mark.parametrize("recompute", [False, True], ids=["res", "recompute"])
@pytest.mark.parametrize("dtype", list(TOLS))
def test_delta_layer_chain_rebuilds_d_inter(dtype, recompute):
    """d(inter) of the plain backwards (ref_spa_wgrad_jobs' delta of the z7
    job) equals three delta_layer_plain calls bit for bit: the heads'
    pullbacks added in the 64-row tile's order, g_rt, g_nct, then g_bn
    masked by inter in the residual form, the reverse in the recompute
    form; chip_smoke's spa_bwd_inter makes the same calls on the card."""
    h, o, n = 48, 80, 129
    ws, enc, pos, g = _case(7, h, o, n, dtype)
    wt = _torch_ws(ws, dtype)
    acts = ops.ref_spa_fwd_res(wt, enc, pos, device="cpu")[2]
    jobs = ops.ref_fused.ref_spa_wgrad_jobs(wt, enc, g, acts, recompute)
    d_inter = jobs[8][1]
    heads = [(g[:, :2], wt[17]), (g[:, 2:11], wt[19]), (g[:, 11:], wt[21])]
    if recompute:
        heads.reverse()
    (a0, w0), (a1, w1), (a2, w2) = [(a.to(dtype).contiguous(), w)
                                    for a, w in heads]
    t = delta_layer_plain(a0, w0)[0]
    t = delta_layer_plain(a1, w1, add=t)[0]
    got = delta_layer_plain(a2, w2, act=acts[7], add=t)[0]
    assert got.dtype == dtype and got.shape == (n, o)
    assert torch.equal(got, d_inter)
    # and d7 from it, as spa_bwd_chain holds the frame's
    assert torch.equal(jobs[7][1],
                       delta_layer_plain(d_inter, wt[15], act=acts[6])[0])


def test_spa_bwd_on_cpu_counts_no_launch_and_no_body():
    """On the CPU both spatial backwards run their plain versions: they
    count no launch and no body (ops.BODIES holds the bodies that the C
    entries report they launched, named by ref_fused.spa_bwd_body_name)."""
    ws, enc, pos, g = _case(3, 48, 80, 14, torch.bfloat16)
    wt = _torch_ws(ws, torch.bfloat16)
    acts = ops.ref_spa_fwd_res(wt, enc, pos, device="cpu")[2]
    ops.reset_launches()
    res = ops.ref_spa_bwd(wt, enc, g, acts, device="cpu")
    rc = ops.ref_spa_bwd_recompute(wt, enc, g, device="cpu")
    assert not any(ops.LAUNCHES.values()) and ops.BODIES == {}
    assert len(res) == len(rc) == 23


def test_spa_bwd_body_names():
    """The names of the bodies that the spatial backwards' C entries report:
    0 for the 64-row tile, else the frame's consumer warpgroups."""
    name = ops.ref_fused.spa_bwd_body_name
    assert [name(c, f) for c in (0, 1, 2) for f in ("res", "recompute")] == [
        "ref_spa_delta_kernel", "ref_spa_recompute_kernel",
        "spa_bwd_frame_kernel<res> x1", "spa_bwd_frame_kernel<recompute> x1",
        "spa_bwd_frame_kernel<res> x2", "spa_bwd_frame_kernel<recompute> x2"]


def test_kernel_ab_spa_bwd_turn_times_what_chip_smoke_checks():
    """kernel_ab.py --spa_bwd times the two spatial backwards with a
    checkout's own chip_smoke.py (each one whose main-path case it builds),
    and the code of its turn compiles; its width scan and the card phase's
    reach past the 64-row tile's widest in both forms; chip_smoke.py holds
    each backward to its frame on the main paths, builds both forms with
    no stack frame and with the narrow pullbacks' HMMA, and reads their
    occupancy; the card phase's width pairs are the forward frame's and
    320/320, where both forms run one consumer warpgroup."""
    import chip_smoke
    import kernel_ab

    assert set(kernel_ab.SPA_BWD_KERNELS) <= set(chip_smoke.KERNELS)
    compile(kernel_ab.SPA_BWD_TURN, "spa_bwd turn", "exec")
    widest = max(chip_smoke.SPA_BWD_TILE_WIDEST.values())
    assert max(kernel_ab.SPA_BWD_WIDTHS) > widest
    assert max(chip_smoke.SPA_BWD_WIDTH_SCAN) > widest
    assert chip_smoke.BODY_KERNELS["ref_spa_bwd"] == \
        "spa_bwd_frame_kernel<res> x2"
    assert chip_smoke.BODY_KERNELS["ref_spa_bwd_recompute"] == \
        "spa_bwd_frame_kernel<recompute> x2"
    assert chip_smoke.FRAME_FORMS["spa_bwd_frame_kernel"] == 2
    assert "spa_bwd_frame_kernel" in chip_smoke.STACKLESS_FRAMES
    assert "spa_bwd_frame_kernel" in chip_smoke.FRAME_HEAD_MMA
    assert {"spa_bwd_frame_kernel<res>", "spa_bwd_frame_kernel<recompute>"} \
        <= set(chip_smoke.OCCUPANCY_BF16)
    assert set(chip_smoke.FRAME_WIDTHS) < set(chip_smoke.SPA_BWD_FRAME_WIDTHS)
    assert chip_smoke.SPA_BWD_FRAME_WIDTHS[(320, 320)] == (1, 1)
    assert chip_smoke.frame_launched(
        {"ref_spa_bwd": 2, "ref_spa_bwd_recompute": 0}) == ("ref_spa_bwd",)
