"""The plain versions that the card holds the bf16 proposal frame
(``csrc/prop_frame.cuh``) to, against the Pallas kernels of nerf_tpu in
interpret mode, at the shapes the card phase uses: the proposal forward
pair (prop_mlp_fwd, prop_mlp_fwd_res) at the widths and point counts of
chip_smoke.py's ``prop_frame`` phase and at a width above the frame's fit,
where the launcher chooses the 64-row tile; the CPU dispatch of both, which
counts no launch and no body; and the names of the bodies that their C
entries report.

Tolerances: those of tests/test_ops.py, f32 rtol 2e-5 / atol 2e-6
(tests/test_ops.py:53), bf16 rtol 0.05 / atol 0.02 (tests/test_ops.py:117),
for the density and the four stored activations alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops.fused_mlp import PROP_BIASES

DX = 63                         # the full-width encoding
TILE = 64                       # Pallas tile of the interpret-mode kernels
TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-6),   # tests/test_ops.py:53
        torch.bfloat16: dict(rtol=0.05, atol=0.02)}  # tests/test_ops.py:117
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# H and N of chip_smoke.py's prop_frame phase below its main-path point
# counts: the card tests' narrow widths and the model's own, at one point
# and either side of the frame's 128-point tile
PROP_WIDTHS = [48, 64, 256]
PROP_NS = [1, 127, 129]
# a width above the bf16 frame's widest fit in both forms (752 on an H100),
# at or below the 64-row tile's widest (chip_smoke.PROP_TILE_WIDEST)
PROP_WIDE = 768


def _prop_ws(seed, h):
    """A seeded f32 proposal weight tuple (nerf_tpu/ops/fused_mlp.py:457) at
    width h: matrices N(0, 1 / fan_in), biases N(0, 0.1^2), as
    tests/test_torch_prop_res.py draws them."""
    rng = np.random.default_rng(seed)
    ws = []
    for m in ((DX, h), (h, h), (h, h), (h, h), (h, 1)):
        ws += [rng.normal(0, 1 / np.sqrt(m[0]), m).astype(np.float32),
               rng.normal(0, 0.1, (1, m[1])).astype(np.float32)]
    return ws


def _torch_ws(ws, dtype):
    return tuple(torch.from_numpy(w).to(torch.float32 if i in PROP_BIASES
                                        else dtype)
                 for i, w in enumerate(ws))


def _pallas_prop_res(ws, enc, cd):
    """``_prop_fwd_res_kernel`` in interpret mode, as ``_fwd_impl`` of
    make_prop_fused(store_residuals=True) calls it: (density, the 4
    activations), unpadded."""
    ws = tuple(w.astype(jnp.float32) if w.shape[0] == 1 else w.astype(cd)
               for w in ws)
    n = enc.shape[0]
    x = jfused._pad_rows(enc.astype(cd), TILE)
    h = ws[2].shape[1]
    np_ = x.shape[0]
    outs = pl.pallas_call(
        jfused._prop_fwd_res_kernel, grid=(np_ // TILE,),
        in_specs=[jfused._row_spec(TILE, x.shape[1])]
        + [jfused._full_spec(w.shape) for w in ws],
        out_specs=tuple([jfused._col_spec(1, TILE)]
                        + [jfused._row_spec(TILE, h)] * jfused.N_PROP_ACTS),
        out_shape=tuple([jax.ShapeDtypeStruct((1, np_), jnp.float32)]
                        + [jax.ShapeDtypeStruct((np_, h), cd)]
                        * jfused.N_PROP_ACTS),
        interpret=True)(x, *ws)
    return outs[0][0, :n], [a[:n] for a in outs[1:]]


def _close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol, err_msg=name)


def _check_against_pallas(h, n, dtype, res, seed):
    """prop_mlp_fwd (prop_mlp_fwd_res with ``res``) on the CPU, its plain
    version, against make_prop_fused (the residual kernel) in interpret
    mode: the density and, with ``res``, h1 .. h4."""
    ws = _prop_ws(seed, h)
    enc = np.random.default_rng(n + 7).uniform(-1, 1, (n, DX)).astype(
        np.float32)
    jws = tuple(jnp.asarray(w) for w in ws)
    if res:
        jden, jacts = _pallas_prop_res(jws, jnp.asarray(enc), JDT[dtype])
    else:
        fused = jfused.make_prop_fused(JDT[dtype], TILE, interpret=True)
        jden = fused(jws, jnp.asarray(enc))
    fn = ops.prop_mlp_fwd_res if res else ops.prop_mlp_fwd
    out = fn(_torch_ws(ws, dtype), torch.from_numpy(enc).to(dtype),
             device="cpu")
    den = out[0] if res else out
    assert den.dtype == torch.float32 and den.shape == (n,)
    _close(den, jden, TOLS[dtype], "density")
    if res:
        assert len(out[1]) == len(jacts) == ops.fused_mlp.N_PROP_ACTS
        for i, (a, ja) in enumerate(zip(out[1], jacts)):
            assert a.dtype == dtype and a.shape == (n, h), i
            _close(a, ja, TOLS[dtype], f"h{i + 1}")


@pytest.mark.parametrize("res", [False, True], ids=["fwd", "fwd_res"])
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", PROP_NS)
@pytest.mark.parametrize("h", PROP_WIDTHS)
def test_prop_plain_matches_pallas_at_frame_shapes(h, n, dtype, res):
    """prop_mlp_fwd and prop_mlp_fwd_res on the CPU (their plain versions,
    the card phase's oracle) against make_prop_fused and the residual
    kernel in interpret mode: the density and the 4 activations."""
    _check_against_pallas(h, n, dtype, res, 1000 * h + n)


@pytest.mark.parametrize("res", [False, True], ids=["fwd", "fwd_res"])
@pytest.mark.parametrize("dtype", list(TOLS))
def test_prop_plain_matches_pallas_above_the_frame(dtype, res):
    """The same at H = PROP_WIDE, above the bf16 frame's fit, where the
    launcher runs the 64-row tile on the card, at 70 points (a ragged
    64-row tile)."""
    _check_against_pallas(PROP_WIDE, 70, dtype, res, PROP_WIDE)


def test_prop_fwd_on_cpu_counts_no_launch_and_no_body():
    """On the CPU the proposal forwards run their plain versions: they
    count no launch and no body (ops.BODIES holds the bodies that the C
    entries report they launched, named by fused_mlp.prop_body_name), and
    the residual form's density equals the forward's."""
    ws = _torch_ws(_prop_ws(3, 48), torch.bfloat16)
    x = torch.zeros((14, DX), dtype=torch.bfloat16)
    ops.reset_launches()
    den = ops.prop_mlp_fwd(ws, x, device="cpu")
    den_res, acts = ops.prop_mlp_fwd_res(ws, x, device="cpu")
    assert not any(ops.LAUNCHES.values()) and ops.BODIES == {}
    assert torch.equal(den, den_res) and len(acts) == 4


def test_prop_body_names():
    """The names of the bodies that the proposal forwards' C entries report:
    0 for the 64-row tile, else the frame's consumer warpgroups."""
    name = ops.fused_mlp.prop_body_name
    assert [name(c, r) for c in (0, 1, 2) for r in (False, True)] == [
        "prop_mlp_fwd_kernel", "prop_mlp_fwd_kernel",
        "prop_frame_kernel<eval> x1", "prop_frame_kernel<res> x1",
        "prop_frame_kernel<eval> x2", "prop_frame_kernel<res> x2"]


def test_kernel_ab_prop_turn_times_what_chip_smoke_checks():
    """kernel_ab.py --prop times the two proposal forwards with a
    checkout's own chip_smoke.py (each one whose main-path case it builds),
    and the code of its turn compiles; its width scan reaches past the
    64-row tile's widest; chip_smoke.py holds each proposal forward to its
    frame at the main paths' widths and builds both proposal forms with no
    stack frame."""
    import chip_smoke
    import kernel_ab

    assert set(kernel_ab.PROP_KERNELS) <= set(chip_smoke.KERNELS)
    compile(kernel_ab.PROP_TURN, "prop turn", "exec")
    assert max(kernel_ab.PROP_WIDTHS) > chip_smoke.PROP_TILE_WIDEST
    assert max(chip_smoke.PROP_WIDTH_SCAN) > chip_smoke.PROP_TILE_WIDEST
    assert chip_smoke.BODY_KERNELS["prop_mlp_fwd"] == \
        "prop_frame_kernel<eval> x2"
    assert chip_smoke.BODY_KERNELS["prop_mlp_fwd_res"] == \
        "prop_frame_kernel<res> x2"
    assert chip_smoke.FRAME_FORMS["prop_frame_kernel"] == 2
    assert "prop_frame_kernel" in chip_smoke.STACKLESS_FRAMES
    assert chip_smoke.TRACE_FUNCTIONS["prop_mlp_fwd"] == "prop_frame_kernel"
    assert chip_smoke.frame_launched(
        {"prop_mlp_fwd": 3, "prop_mlp_fwd_res": 0,
         "vanilla_mlp_fwd": 1}) == ("prop_mlp_fwd", "vanilla_mlp_fwd")
