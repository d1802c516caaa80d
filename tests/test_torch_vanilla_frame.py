"""The plain versions that the card holds the bf16 frame forwards to, against
the Pallas kernels of nerf_tpu in interpret mode, at the shapes the card
phases use: the vanilla forward pair (vanilla_mlp_fwd, vanilla_mlp_fwd_res)
at the widths and point counts of chip_smoke.py's ``vanilla_frame`` phase,
and the Ref-NeRF spatial forwards at a width above the frame's fit, where
the launchers choose the 64-row tile; and the CPU dispatch of both, which
counts no launch and no body.

Tolerances:
- vanilla: those of tests/test_torch_ops.py (test_vanilla_plain_matches_
  pallas and test_vanilla_fwd_res_matches_pallas): f32 rtol 2e-5 / atol
  2e-6 (tests/test_ops.py:53), bf16 rtol 0.05 / atol 0.02
  (tests/test_ops.py:117), for the outputs and the stored activations alike.
- spatial: KERNEL_TOLS of tests/test_torch_ref_train.py (f32 rtol 2e-4 /
  atol 1e-5, bf16 rtol 0.05 / atol 0.02), the normal target where the
  density gradient's norm exceeds 1e-2 (DGRAD_MIN_NORM there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.ops import make_vanilla_fused
from nerf_tpu.ops import ref_fused as jref
from nerf_tpu_torch import ops
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.ops.fused_mlp import VANILLA_BIASES
from nerf_tpu_torch.ops.ref_fused import REF_SPA_BIASES

DX, DD = 63, 27                 # the full-width encodings
TILE = 64                       # Pallas tile of the interpret-mode kernels
TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-6),   # tests/test_ops.py:53
        torch.bfloat16: dict(rtol=0.05, atol=0.02)}  # tests/test_ops.py:117
SPA_TOLS = {torch.float32: dict(rtol=2e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=0.05, atol=0.02)}
DGRAD_MIN_NORM = 1e-2
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (H, B, R) and N of chip_smoke.py's vanilla_frame phase below its main-path
# point counts: the card tests' narrow widths and the model's own, at one
# point and either side of the frame's 128-point tile
VANILLA_WIDTHS = [(48, 40, 24), (64, 64, 32), (256, 256, 128)]
VANILLA_NS = [1, 127, 129]
# a spatial width above the bf16 frame's fit in every form, below the
# 64-row tile's widest (616 for ref_spa_fwd_grad)
SPA_WIDE = 600


def _weights(rng, shapes, biases, fan_in):
    """Seeded f32 weights of ``shapes``: matrices N(0, 1 / fan_in of their
    layer), the entries at ``biases`` N(0, 0.1^2), as
    tests/test_torch_ref_train.py draws them (WEIGHTS).  The activations stay
    of order 1: at 256 wide with twice the weights' spread they reach 10,
    and a bf16 rounding flip between two f32 summation orders, carried
    through the later layers, parts an element by 0.03, beyond the bf16
    atol."""
    return [rng.normal(0.0, 0.1 if i in biases
                       else 1.0 / np.sqrt(fan_in[i]), s).astype(np.float32)
            for i, s in enumerate(shapes)]


def _vanilla_ws(seed, h, bn, r):
    """A seeded vanilla weight tuple (nerf_tpu/ops/fused_mlp.py:79-92) at
    trunk width h, bottleneck bn and rgb width r; the split layers' fan-in
    is their whole input's."""
    shapes = [(DX, h), (1, h), (h, h), (1, h), (h, h), (1, h), (h, h), (1, h),
              (DX, h), (h, h), (1, h), (h, h), (1, h), (h, bn), (1, bn),
              (bn, 1), (1, 1), (bn, bn), (1, bn), (bn, r), (DD, r), (1, r),
              (r, 3), (1, 3)]
    fan_in = [s[0] for s in shapes]
    fan_in[8] = fan_in[9] = DX + h
    fan_in[19] = fan_in[20] = bn + DD
    return _weights(np.random.default_rng(seed), shapes, VANILLA_BIASES,
                    fan_in)


def _torch_ws(ws, biases, dtype):
    return tuple(torch.from_numpy(w).to(torch.float32 if i in biases
                                        else dtype)
                 for i, w in enumerate(ws))


def _pallas_vanilla_res(ws, enc_x, enc_d, cd):
    """``_vanilla_fwd_res_kernel`` in interpret mode, as ``_fwd_impl`` of
    make_vanilla_fused(store_residuals=True) calls it: (rgb3, sigma, the 9
    activations), unpadded."""
    ws = tuple(w.astype(jnp.float32) if w.shape[0] == 1 else w.astype(cd)
               for w in ws)
    n = enc_x.shape[0]
    x = jfused._pad_rows(enc_x.astype(cd), TILE)
    d = jfused._pad_rows(enc_d.astype(cd), TILE)
    h, bn, r = ws[2].shape[1], ws[17].shape[1], ws[19].shape[1]
    widths = (h,) * 6 + (bn, bn, r)
    np_ = x.shape[0]
    outs = pl.pallas_call(
        jfused._vanilla_fwd_res_kernel, grid=(np_ // TILE,),
        in_specs=[jfused._row_spec(TILE, x.shape[1]),
                  jfused._row_spec(TILE, d.shape[1])]
        + [jfused._full_spec(w.shape) for w in ws],
        out_specs=tuple([jfused._col_spec(3, TILE), jfused._col_spec(1, TILE)]
                        + [jfused._row_spec(TILE, w) for w in widths]),
        out_shape=tuple(
            [jax.ShapeDtypeStruct((3, np_), jnp.float32),
             jax.ShapeDtypeStruct((1, np_), jnp.float32)]
            + [jax.ShapeDtypeStruct((np_, w), cd) for w in widths]),
        interpret=True)(x, d, *ws)
    return outs[0][:, :n], outs[1][0, :n], [a[:n] for a in outs[2:]]


def _close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol, err_msg=name)


@pytest.mark.parametrize("res", [False, True], ids=["fwd", "fwd_res"])
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", VANILLA_NS)
@pytest.mark.parametrize("h, bn, r", VANILLA_WIDTHS)
def test_vanilla_plain_matches_pallas_at_frame_shapes(h, bn, r, n, dtype,
                                                      res):
    """vanilla_mlp_fwd and vanilla_mlp_fwd_res on the CPU (their plain
    versions, the card phase's oracle) against make_vanilla_fused and the
    residual kernel in interpret mode: rgb3, sigma and the 9 activations."""
    ws = _vanilla_ws(1000 * h + n, h, bn, r)
    rng = np.random.default_rng(n + 7)
    enc_x = rng.uniform(-1, 1, (n, DX)).astype(np.float32)
    enc_d = rng.uniform(-1, 1, (n, DD)).astype(np.float32)
    jws = tuple(jnp.asarray(w) for w in ws)
    if res:
        jrgb, jsig, jacts = _pallas_vanilla_res(
            jws, jnp.asarray(enc_x), jnp.asarray(enc_d), JDT[dtype])
    else:
        fused = make_vanilla_fused(JDT[dtype], TILE, interpret=True)
        jrgb, jsig = fused(jws, jnp.asarray(enc_x), jnp.asarray(enc_d))
    fn = ops.vanilla_mlp_fwd_res if res else ops.vanilla_mlp_fwd
    out = fn(_torch_ws(ws, VANILLA_BIASES, dtype),
             torch.from_numpy(enc_x).to(dtype),
             torch.from_numpy(enc_d).to(dtype), device="cpu")
    assert out[0].dtype == out[1].dtype == torch.float32
    _close(out[0], jrgb, TOLS[dtype], "rgb3")
    _close(out[1], jsig, TOLS[dtype], "sigma")
    if res:
        assert len(out[2]) == len(jacts) == ops.fused_mlp.N_VANILLA_ACTS
        for i, (a, ja) in enumerate(zip(out[2], jacts)):
            assert a.dtype == dtype, i
            _close(a, ja, TOLS[dtype], f"activation {i}")


def test_vanilla_fwd_on_cpu_counts_no_launch_and_no_body():
    """On the CPU the vanilla forwards run their plain versions: they count
    no launch and no body (ops.BODIES holds the bodies that the C entries
    report they launched, named by fused_mlp.vanilla_body_name)."""
    ws = _torch_ws(_vanilla_ws(3, 48, 40, 24), VANILLA_BIASES,
                   torch.bfloat16)
    x = torch.zeros((14, DX), dtype=torch.bfloat16)
    d = torch.zeros((14, DD), dtype=torch.bfloat16)
    ops.reset_launches()
    for fn in (ops.vanilla_mlp_fwd, ops.vanilla_mlp_fwd_res):
        fn(ws, x, d, device="cpu")
    assert not any(ops.LAUNCHES.values()) and ops.BODIES == {}
    name = ops.fused_mlp.vanilla_body_name
    assert [name(c, r) for c in (0, 1, 2) for r in (False, True)] == [
        "vanilla_mlp_fwd_kernel", "vanilla_mlp_fwd_kernel",
        "vanilla_frame_kernel<eval> x1", "vanilla_frame_kernel<res> x1",
        "vanilla_frame_kernel<eval> x2", "vanilla_frame_kernel<res> x2"]


def _spa_ws(seed, h, o, nb=128):
    """A seeded spatial weight tuple (nerf_tpu/ops/ref_fused.py:51-63) at
    trunk width h and output width o."""
    shapes = [(DX, h), (1, h), (h, h), (1, h), (h, h), (1, h), (h, h), (1, h),
              (DX, h), (h, h), (1, h), (h, h), (1, h), (h, h), (1, h), (h, o),
              (1, o), (o, 2), (1, 2), (o, 9), (1, 9), (o, nb), (1, nb)]
    fan_in = [s[0] for s in shapes]
    fan_in[8] = fan_in[9] = DX + h
    return _weights(np.random.default_rng(seed), shapes, REF_SPA_BIASES,
                    fan_in)


@pytest.mark.parametrize("form", ["eval", "res", "grad"])
@pytest.mark.parametrize("dtype", list(SPA_TOLS))
def test_spa_plain_matches_pallas_above_the_frame(dtype, form):
    """ref_spa_fwd, ref_spa_fwd_res and ref_spa_fwd_grad on the CPU (their
    plain versions) against the Pallas spatial forwards in interpret mode at
    H = O = 600, where the bf16 launchers run the 64-row tile: the heads
    and, in the training forms, the normal target."""
    n = 70
    ws = _spa_ws(SPA_WIDE + len(form), SPA_WIDE, SPA_WIDE)
    pos = np.random.default_rng(9).uniform(-1.5, 1.5, (n, 3)).astype(
        np.float32)
    enc = cat_pos_pe(torch.from_numpy(pos), 10)
    cd = JDT[dtype]
    spa = jref._make_spa_fused(cd, TILE, True, form != "eval",
                               store_residuals=form == "res")
    jheads, jdgrad = spa(tuple(jnp.asarray(w) for w in ws),
                         jnp.asarray(enc.numpy(), cd), jnp.asarray(pos))
    tws = _torch_ws(ws, REF_SPA_BIASES, dtype)
    x = enc.to(dtype)
    if form == "eval":
        heads = ops.ref_spa_fwd(tws, x, device="cpu")
    else:
        fn = ops.ref_spa_fwd_res if form == "res" else ops.ref_spa_fwd_grad
        heads, dgrad = fn(tws, x, torch.from_numpy(pos), device="cpu")[:2]
        acts = ops.ref_spa_fwd_res_plain(tws, x, torch.from_numpy(pos))[2]
        g = ops.ref_fused.density_grad_plain(tws, x, torch.from_numpy(pos),
                                             acts)
        live = torch.linalg.vector_norm(g, dim=-1) > DGRAD_MIN_NORM
        assert int(live.sum()) >= n - 4, int(live.sum())
        _close(dgrad[live], np.asarray(jdgrad).T[live.numpy()],
               SPA_TOLS[dtype], "normal target")
    _close(heads, jheads, SPA_TOLS[dtype], "heads")


def test_spa_fwd_on_cpu_counts_no_launch_and_no_body():
    """On the CPU the spatial forwards count no launch and no body; the
    names of the bodies their C entries report (ref_fused.spa_body_name:
    the frame's consumer warpgroups, or 0 for the 64-row tile)."""
    tws = _torch_ws(_spa_ws(4, 48, 80), REF_SPA_BIASES, torch.bfloat16)
    pos = torch.zeros((14, 3))
    x = cat_pos_pe(pos, 10, torch.bfloat16)
    ops.reset_launches()
    ops.ref_spa_fwd(tws, x, device="cpu")
    for fn in (ops.ref_spa_fwd_res, ops.ref_spa_fwd_grad):
        fn(tws, x, pos, device="cpu")
    assert not any(ops.LAUNCHES.values()) and ops.BODIES == {}
    name = ops.ref_fused.spa_body_name
    assert [name(c, f) for c in (0, 1, 2)
            for f in ("eval", "res", "grad")] == [
        "ref_spa_fwd_kernel", "ref_spa_fwd_res_kernel<true>",
        "ref_spa_fwd_res_kernel<false>", "spa_frame_kernel<eval> x1",
        "spa_frame_kernel<res> x1", "spa_frame_kernel<grad> x1",
        "spa_frame_kernel<eval> x2", "spa_frame_kernel<res> x2",
        "spa_frame_kernel<grad> x2"]


def test_kernel_ab_vanilla_turn_times_what_chip_smoke_checks():
    """kernel_ab.py --vanilla times the two vanilla forwards with a
    checkout's own chip_smoke.py (each one whose main-path case it builds),
    and the code of its turn compiles; chip_smoke.py holds each kernel
    that reports a body to its frame at the main paths' widths."""
    import chip_smoke
    import kernel_ab

    assert set(kernel_ab.VANILLA_KERNELS) <= set(chip_smoke.KERNELS)
    compile(kernel_ab.VANILLA_TURN, "vanilla turn", "exec")
    assert chip_smoke.BODY_KERNELS["vanilla_mlp_fwd"] == \
        "vanilla_frame_kernel<eval> x2"
    assert chip_smoke.BODY_KERNELS["ref_spa_fwd_grad"] == \
        "spa_frame_kernel<grad> x2"
    assert chip_smoke.frame_launched(
        {"vanilla_mlp_fwd": 3, "vanilla_mlp_bwd": 1,
         "ref_spa_fwd": 0}) == ("vanilla_mlp_fwd",)
