"""The plain versions of the directional kernels' dissection
(``nerf_tpu_torch.ops.ref_dissect``: five forward stages, four backward
modes) against the JAX package's own dissection kernels
(tools/bench_ref_kernels.py's ``_dissect_dir_fwd`` and
``_dissect_dir_bwd``), run in Pallas interpret mode on the CPU: the tool's
``pl.pallas_call`` is wrapped to force ``interpret=True`` and to record each
call's operands and outputs, and its ``timeit_scan`` runs the timed body
once.  The port's plain versions then run on the recorded operands.

Size: N = 512 points in the tool's 256-row tiles, trunk widths H = 48,
O = 80, IDE level 4; the tool's kernels are bf16 only.  Tolerance: bf16
rtol 0.05 / atol 0.02 (tests/test_ops.py).  The tool's backward takes its
rules from jax.vjp without ``bwd_cd`` (f32 cotangents into the products,
where the shipped kernels cast them to bf16 first) and rounds each
256-row tile's weight grad to bf16, which the plain version is given as
its tile; the two rules part by bf16 rounding only.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu.core.encoding import ide_tables
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops.launch import prep_weights
from nerf_tpu_torch.ops.ref_dissect import BWD_MODES
from nerf_tpu_torch.ops.ref_fused import DIR_STAGES, REF_DIR_BIASES

N, TILE = 512, 256
H, O = 48, 80
TOLS = dict(rtol=0.05, atol=0.02)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, n_ch, nb=128):
    """f32 numpy directional weights: matrices N(0, 1/fan_in), biases
    N(0, 0.1^2)."""
    dd = nb + 2 * n_ch + 1
    mats = [(dd, H), None, (H, H), None, (H, H), None, (H, H), None,
            (dd, H), (H, H), None, (H, H), None, (H, O), None, (O, O), None,
            (O, 3), None]
    out = []
    for i, m in enumerate(mats):
        if m is None:
            prev = next(x for x in reversed(mats[:i]) if x is not None)
            out.append(rng.normal(0, 0.1, (1, prev[1])))
        else:
            out.append(rng.normal(0, 1 / np.sqrt(m[0]), m))
    return [w.astype(np.float32) for w in out]


@pytest.fixture(scope="module")
def recorded():
    """Run the tool's two dissections with interpret mode forced: {"fwd":
    [(operands, outputs)] per stage, "bwd": ... per mode}, numpy."""
    from jax.experimental import pallas as real_pl

    import tools.bench_ref_kernels as bench

    rng = np.random.default_rng(0)
    ws = _weights(rng, ide_tables(4)["n_ch"])
    heads = rng.normal(size=(N, 139)).astype(np.float32)
    d = rng.normal(size=(3, N))
    dirs = (d / np.linalg.norm(d, axis=0)
            * rng.uniform(1.0, 1.12, N)).astype(np.float32)
    noise = rng.normal(0, 0.02, (N, 128)).astype(np.float32)
    records = []

    def pallas_call(kernel, **kw):
        call = real_pl.pallas_call(kernel, **dict(kw, interpret=True))

        def run(*args):
            out = call(*args)
            records.append(([np.asarray(a) for a in args],
                            [np.asarray(o) for o in out]))
            return out
        return run

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(bench, "pl", types.SimpleNamespace(
            **{**vars(real_pl), "pallas_call": pallas_call}))
        mp.setattr(bench, "timeit_scan",
                   lambda name, body, init: body(init))
        args = tuple(map(jnp.asarray, ws)), jnp.asarray(heads), \
            jnp.asarray(noise), jnp.asarray(dirs)
        bench._dissect_dir_fwd(*args, TILE)
        fwd = list(records)
        records.clear()
        bench._dissect_dir_bwd(*args, TILE)
    finally:
        mp.undo()
    assert len(fwd) == len(DIR_STAGES) and len(records) == len(BWD_MODES)
    return {"fwd": fwd, "bwd": list(records)}


def _port_weights(operands):
    """The recorded weight tuple (the last 19 operands) as the port's
    kernel operands: bf16 matrices, f32 biases."""
    return prep_weights([_t(w.astype(np.float32)) for w in operands[-19:]],
                        REF_DIR_BIASES, torch.bfloat16)


@pytest.mark.parametrize("stage", DIR_STAGES)
def test_forward_stage_plain_matches_the_tool(recorded, stage):
    """ref_dir_fwd_dissect (its plain version on the CPU) against the
    tool's stage: rgb, normal and density."""
    operands, (rgb3, nrm3, den) = recorded["fwd"][DIR_STAGES.index(stage)]
    h, nz, d, rows = operands[:4]
    ops.reset_launches()
    rgb, normal, density = ops.ref_dir_fwd_dissect(
        _port_weights(operands), _t(h), _t(d.T.copy()), 1, stage,
        noise=_t(nz.astype(np.float32)).to(torch.bfloat16), rows=_t(rows),
        device="cpu")
    assert not any(ops.LAUNCHES.values())
    assert float(rgb3.std()) > 0.01
    for name, got, want in (("rgb", rgb, rgb3.T), ("normal", normal, nrm3.T),
                            ("density", density, den[0])):
        np.testing.assert_allclose(got.numpy(), want, **TOLS,
                                   err_msg=f"{stage} {name}")


def test_forward_stages_differ(recorded):
    """Each stage computes something the one before it does not: the rgb
    of consecutive stages parts."""
    rgbs = [out[0] for _, out in recorded["fwd"]]
    for a, b, name in zip(rgbs, rgbs[1:], DIR_STAGES[1:]):
        assert float(np.abs(a - b).max()) > 1e-3, name


@pytest.mark.parametrize("mode", BWD_MODES)
def test_backward_mode_plain_matches_the_tool(recorded, mode):
    """ref_dir_bwd_dissect (its plain version on the CPU, weight grads
    rounded per 256-row tile as the tool's are) against the tool's mode:
    d(heads) and the 19 grads, zeros where the mode computes nothing."""
    operands, (dheads, *grads) = recorded["bwd"][BWD_MODES.index(mode)]
    h, nz, d, grgb, gnrm, gden = operands[:6]
    got_dh, got_g = ops.ref_dir_bwd_dissect(
        _port_weights(operands), _t(h), _t(d.T.copy()), 1,
        _t(nz.astype(np.float32)).to(torch.bfloat16), _t(grgb.T.copy()),
        _t(gnrm.T.copy()), _t(gden[0].copy()), mode, tile=TILE,
        device="cpu")
    np.testing.assert_allclose(got_dh.numpy(), dheads, **TOLS,
                               err_msg=f"{mode} d(heads)")
    assert len(got_g) == len(grads) == 19
    for i, (a, b) in enumerate(zip(got_g, grads)):
        np.testing.assert_allclose(a.numpy(), b, **TOLS,
                                   err_msg=f"{mode} grad {i}")
    live = {"recompute": (True, False), "dheads": (True, False),
            "wgrads": (False, True), "full": (True, True)}[mode]
    assert (np.abs(dheads).max() > 0) == live[0]
    assert (max(np.abs(g).max() for g in grads) > 0) == live[1]


def test_dissect_wrappers_check_their_operands():
    """The stage and mode names, and the input rows that the first two
    stages take, are checked on the CPU as on the card; without a card the
    wrappers refuse to run quietly."""
    rng = np.random.default_rng(1)
    n_ch = ide_tables(4)["n_ch"]
    ws = prep_weights([_t(w) for w in _weights(rng, n_ch)], REF_DIR_BIASES,
                      torch.float32)
    heads, dirs = torch.zeros((8, 139)), torch.ones((8, 3))
    with pytest.raises(ValueError, match="stage must be one of"):
        ops.ref_dir_fwd_dissect(ws, heads, dirs, 1, "tail", device="cpu")
    with pytest.raises(ValueError, match="takes the input rows"):
        ops.ref_dir_fwd_dissect(ws, heads, dirs, 1, "trunk", device="cpu")
    with pytest.raises(ValueError, match="rows must be"):
        ops.ref_dir_fwd_dissect(ws, heads, dirs, 1, "reflect",
                                rows=torch.zeros((2 * n_ch, 8)),
                                device="cpu")
    g = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="mode must be one of"):
        ops.ref_dir_bwd_dissect(ws, heads, dirs, 1, None, g, g,
                                torch.zeros(8), "glue", device="cpu")
    out = ops.ref_dir_fwd_dissect(ws, heads, dirs, 1, "polar", device="cpu")
    assert [tuple(t.shape) for t in out] == [(8, 3), (8, 3), (8,)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.ref_dir_fwd_dissect(ws, heads, dirs, 1, "full")
