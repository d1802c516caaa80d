"""The fused MLP wrappers of nerf_tpu_torch.ops: their plain versions, forward
and backward, against the Pallas kernels of nerf_tpu.ops in interpret mode;
the autograd Functions against autograd through the nn.Modules; and their
dispatch.  The CUDA kernels themselves are held against the plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import random_params
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.models import ProposalNetwork as JaxProp
from nerf_tpu.models import VanillaNeRF as JaxVanilla
from nerf_tpu.ops import (
    make_prop_fused, make_vanilla_fused, prop_weights_from_params,
    vanilla_weights_from_params,
)
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.models import ProposalNetwork, VanillaNeRF

POS_L, DIR_L = 4, 2     # small encodings keep interpret mode fast
N, TILE = 70, 32        # N deliberately not a multiple of the tile
DX, DD = 3 * (2 * POS_L + 1), 3 * (2 * DIR_L + 1)
TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-6),   # tests/test_ops.py:53
        torch.bfloat16: dict(rtol=0.05, atol=0.02)}  # tests/test_ops.py:117
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# backward grads against the Pallas backward.  f32: tests/test_ops.py:79.
# bf16, as the relative Frobenius error of each grad tensor: both sides cast
# every delta to bf16 per layer, after f32 sums taken in another order, so
# they part only where a sum lands on the other side of a rounding edge
# (1.2e-7 vanilla, 5.4e-8 proposal at these shapes), while a backward with a
# cast left out or added reads 5e-4 or more
# (test_bf16_grad_limit_catches_planted_cast_faults).
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_GRAD_REL = 1e-4


def _flax_params(module, *args, seed):
    import jax

    template = module.init(jax.random.PRNGKey(0), *args)["params"]
    return random_params(template, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def nets():
    """Flax params and the bridged port modules (f32 and bf16) of both nets,
    plus encodings made from one numpy seed."""
    rng = np.random.default_rng(11)
    enc_x = rng.uniform(-1, 1, (N, DX)).astype(np.float32)
    enc_d = rng.uniform(-1, 1, (N, DD)).astype(np.float32)
    pos = np.zeros((1, 2, 3), np.float32)
    vp = _flax_params(JaxVanilla(pos_levels=POS_L, dir_levels=DIR_L, hidden=48,
                                 bottleneck=40), pos, pos + 1, seed=12)
    pp = _flax_params(JaxProp(pos_levels=POS_L, hidden=48), pos, seed=13)
    port = {}
    for dt in TOLS:
        v = VanillaNeRF(POS_L, DIR_L, hidden=48, bottleneck=40, dtype=dt)
        v.load_state_dict(bridge.flax_to_state_dict(vp, "nerf"))
        p = ProposalNetwork(POS_L, hidden=48, dtype=dt)
        p.load_state_dict(bridge.flax_to_state_dict(pp, "prop"))
        port[dt] = (v, p)
    return vp, pp, port, enc_x, enc_d


@pytest.mark.parametrize("dtype", list(TOLS))
def test_vanilla_plain_matches_pallas(nets, dtype):
    vp, _, port, enc_x, enc_d = nets
    fused = make_vanilla_fused(JDT[dtype], TILE, interpret=True)
    jrgb, jsig = fused(vanilla_weights_from_params(vp), jnp.asarray(enc_x),
                       jnp.asarray(enc_d))
    ws = port[dtype][0].kernel_weights()
    rgb3, sig = ops.vanilla_mlp_fwd(ws, torch.from_numpy(enc_x).to(dtype),
                                    torch.from_numpy(enc_d).to(dtype),
                                    device="cpu")
    assert rgb3.shape == (3, N) and sig.shape == (N,)
    assert rgb3.dtype == sig.dtype == torch.float32
    np.testing.assert_allclose(rgb3.numpy(), np.asarray(jrgb), **TOLS[dtype])
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), **TOLS[dtype])


@pytest.mark.parametrize("dtype", list(TOLS))
def test_prop_plain_matches_pallas(nets, dtype):
    _, pp, port, enc_x, _ = nets
    fused = make_prop_fused(JDT[dtype], TILE, interpret=True)
    ref = fused(prop_weights_from_params(pp), jnp.asarray(enc_x))
    out = ops.prop_mlp_fwd(port[dtype][1].kernel_weights(),
                           torch.from_numpy(enc_x).to(dtype), device="cpu")
    assert out.shape == (N,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOLS[dtype])


def test_cpu_dispatch_counts_no_launch(nets):
    _, _, port, enc_x, enc_d = nets
    v, p = port[torch.float32]
    ops.reset_launches()
    x, d = torch.from_numpy(enc_x), torch.from_numpy(enc_d)
    torch.testing.assert_close(
        ops.prop_mlp_fwd(p.kernel_weights(), x, device="cpu"),
        ops.prop_mlp_plain(p.kernel_weights(), x), rtol=0, atol=0)
    ops.vanilla_mlp_fwd(v.kernel_weights(), x, d, device="cpu")
    rgb3, sig, acts = ops.vanilla_mlp_fwd_res(v.kernel_weights(), x, d,
                                              device="cpu")
    ops.vanilla_mlp_bwd(v.kernel_weights(), x, d, torch.ones_like(rgb3),
                        torch.ones_like(sig), rgb3, acts, device="cpu")
    ops.prop_mlp_bwd(p.kernel_weights(), x, torch.ones_like(sig),
                     device="cpu")
    ops.vanilla_mlp_bwd_recompute(v.kernel_weights(), x, d,
                                  torch.ones_like(rgb3), torch.ones_like(sig),
                                  device="cpu")
    assert set(ops.LAUNCHES) == {"prop_mlp_fwd", "vanilla_mlp_fwd",
                                 "vanilla_mlp_fwd_res", "vanilla_mlp_bwd",
                                 "prop_mlp_bwd", "ref_spa_fwd", "ref_dir_fwd",
                                 "ref_spa_fwd_res", "ref_dir_fwd_res",
                                 "ref_spa_bwd", "ref_dir_bwd",
                                 "vanilla_mlp_bwd_recompute",
                                 "ref_spa_fwd_grad", "ref_spa_bwd_recompute",
                                 "ref_dir_bwd_recompute", "prop_mlp_fwd_res",
                                 "prop_mlp_bwd_res", "ref_dir_fwd_dissect",
                                 "ref_dir_bwd_dissect", "wgrad_reduce",
                                 "dense_layer", "delta_layer"}
    assert not any(ops.LAUNCHES.values())


def test_wrappers_reject_bad_operands(nets):
    _, _, port, enc_x, enc_d = nets
    v, p = port[torch.bfloat16]
    x = torch.from_numpy(enc_x)
    with pytest.raises(ValueError, match="weight 0 must be torch.float32"):
        ops.prop_mlp_fwd(p.kernel_weights(), x, device="cpu")
    ws = list(v.kernel_weights())
    ws[16] = ws[16].to(torch.bfloat16)            # bsig must stay f32
    with pytest.raises(ValueError, match="weight 16"):
        ops.vanilla_mlp_fwd(ws, x.to(torch.bfloat16),
                            torch.from_numpy(enc_d).to(torch.bfloat16),
                            device="cpu")
    with pytest.raises(ValueError, match="expected 10 weights"):
        ops.prop_mlp_fwd(p.kernel_weights()[:8], x.to(torch.bfloat16),
                         device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ops.prop_mlp_fwd(p.kernel_weights(), x[:, :10].to(torch.bfloat16)
                         .contiguous(), device="cpu")


@pytest.mark.parametrize("fn", ["prop", "vanilla", "vanilla_res",
                                "vanilla_bwd", "prop_bwd", "VanillaMLP",
                                "PropMLP"])
def test_wrappers_never_run_quietly_on_cpu(nets, fn):
    """Without device="cpu" a wrapper or Function targets the card: here,
    with CPU tensors, it raises instead of taking the plain version."""
    _, _, port, enc_x, enc_d = nets
    v, p = port[torch.float32]
    x, d = torch.from_numpy(enc_x), torch.from_numpy(enc_d)
    rgb3, sig, acts = ops.vanilla_mlp_fwd_res(v.kernel_weights(), x, d,
                                              device="cpu")
    calls = {
        "prop": lambda: ops.prop_mlp_fwd(p.kernel_weights(), x),
        "vanilla": lambda: ops.vanilla_mlp_fwd(v.kernel_weights(), x, d),
        "vanilla_res": lambda: ops.vanilla_mlp_fwd_res(v.kernel_weights(), x,
                                                       d),
        "vanilla_bwd": lambda: ops.vanilla_mlp_bwd(
            v.kernel_weights(), x, d, rgb3, sig, rgb3, acts),
        "prop_bwd": lambda: ops.prop_mlp_bwd(p.kernel_weights(), x, sig),
        "VanillaMLP": lambda: ops.VanillaMLP.apply(None, x, d,
                                                   *v.kernel_params()),
        "PropMLP": lambda: ops.PropMLP.apply(None, x, *p.kernel_params()),
    }
    with pytest.raises((RuntimeError, ValueError)):
        calls[fn]()


def _pallas_fwd_res(ws, enc_x, enc_d, cd):
    """``_vanilla_fwd_res_kernel`` in interpret mode, as ``_fwd_impl`` of
    make_vanilla_fused(store_residuals=True) calls it: (rgb3, sigma, the 9
    activations), unpadded."""
    from jax.experimental import pallas as pl

    ws = tuple(w.astype(jnp.float32) if w.shape[0] == 1 else w.astype(cd)
               for w in ws)
    n = enc_x.shape[0]
    x = jfused._pad_rows(enc_x.astype(cd), TILE)
    d = jfused._pad_rows(enc_d.astype(cd), TILE)
    h, z7w, b, rw = (ws[2].shape[1], ws[13].shape[1], ws[17].shape[1],
                     ws[19].shape[1])
    widths = (h, h, h, h, h, h, z7w, b, rw)
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


@pytest.mark.parametrize("dtype", list(TOLS))
def test_vanilla_fwd_res_matches_pallas(nets, dtype):
    """Outputs and the 9 stored activations of the residual forward."""
    vp, _, port, enc_x, enc_d = nets
    jrgb, jsig, jacts = _pallas_fwd_res(vanilla_weights_from_params(vp),
                                        jnp.asarray(enc_x),
                                        jnp.asarray(enc_d), JDT[dtype])
    rgb3, sig, acts = ops.vanilla_mlp_fwd_res(
        port[dtype][0].kernel_weights(), torch.from_numpy(enc_x).to(dtype),
        torch.from_numpy(enc_d).to(dtype), device="cpu")
    np.testing.assert_allclose(rgb3.numpy(), np.asarray(jrgb), **TOLS[dtype])
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), **TOLS[dtype])
    assert len(acts) == len(jacts) == ops.fused_mlp.N_VANILLA_ACTS
    for a, ja in zip(acts, jacts):
        assert a.dtype == dtype and tuple(a.shape) == ja.shape
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(ja, np.float32), **TOLS[dtype])


def _assert_grads(got, want, dtype):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, i
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL,
                                       err_msg=str(i))
        else:
            rel = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w),
                                                      1e-30)
            assert rel < BF16_GRAD_REL, (i, rel)


def _cotangents(seed=21):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, N)).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(TOLS))
def test_vanilla_bwd_plain_matches_pallas(nets, dtype):
    """jax.vjp of the shipped residual-storing fused function (Pallas, in
    interpret mode) against the residual forward and vanilla_mlp_bwd on the
    CPU, on the same cotangents: all 24 grads."""
    vp, _, port, enc_x, enc_d = nets
    g_rgb, g_sig = _cotangents()
    fused = make_vanilla_fused(JDT[dtype], TILE, interpret=True,
                               store_residuals=True)
    _, vjp = jax.vjp(lambda w: fused(w, jnp.asarray(enc_x),
                                     jnp.asarray(enc_d)),
                     vanilla_weights_from_params(vp))
    (want,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_sig)))
    ws = port[dtype][0].kernel_weights()
    x = torch.from_numpy(enc_x).to(dtype)
    d = torch.from_numpy(enc_d).to(dtype)
    rgb3, _, acts = ops.vanilla_mlp_fwd_res(ws, x, d, device="cpu")
    got = ops.vanilla_mlp_bwd(ws, x, d, torch.from_numpy(g_rgb),
                              torch.from_numpy(g_sig), rgb3, acts,
                              device="cpu")
    _assert_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", list(TOLS))
def test_prop_bwd_plain_matches_pallas(nets, dtype):
    """jax.vjp of the shipped recompute-form fused proposal function
    against prop_mlp_bwd on the CPU: all 10 grads."""
    _, pp, port, enc_x, _ = nets
    _, g = _cotangents(22)
    fused = make_prop_fused(JDT[dtype], TILE, interpret=True,
                            store_residuals=False)
    _, vjp = jax.vjp(lambda w: fused(w, jnp.asarray(enc_x)),
                     prop_weights_from_params(pp))
    (want,) = vjp(jnp.asarray(g))
    got = ops.prop_mlp_bwd(port[dtype][1].kernel_weights(),
                           torch.from_numpy(enc_x).to(dtype),
                           torch.from_numpy(g), device="cpu")
    _assert_grads(got, want, dtype)


@pytest.mark.parametrize("fault", ["vanilla_deltas_f32",
                                   "vanilla_dbb_from_rounded_dbvec",
                                   "prop_f32_throughout"])
def test_bf16_grad_limit_catches_planted_cast_faults(nets, fault):
    """A bf16 backward with one of the dtype steps of _vanilla_bwd_math /
    _prop_bwd_math planted wrong reads beyond BF16_GRAD_REL on some grad:
    every delta left in f32 (the plain backward on operands upcast to f32),
    or dbb summed from dbvec rounded to bf16 (fused_mlp.py:240 sums the f32
    dbvec)."""
    _, _, port, enc_x, enc_d = nets
    cd = torch.bfloat16
    v, p = port[cd]
    x, d = (torch.from_numpy(a).to(cd) for a in (enc_x, enc_d))

    def up(ts):
        return [t.float() for t in ts]

    if fault == "prop_f32_throughout":
        g = torch.from_numpy(_cotangents(22)[1])
        ws = p.kernel_weights()
        want = ops.prop_mlp_bwd_plain(ws, x, g)
        got = ops.prop_mlp_bwd_plain(up(ws), x.float(), g)
    else:
        g_rgb, g_sig = (torch.from_numpy(a) for a in _cotangents())
        ws = v.kernel_weights()
        rgb3, _, acts = ops.vanilla_mlp_fwd_res_plain(ws, x, d)
        want = ops.vanilla_mlp_bwd_plain(ws, x, d, g_rgb, g_sig, rgb3, acts)
        if fault == "vanilla_deltas_f32":
            got = ops.vanilla_mlp_bwd_plain(up(ws), x.float(), d.float(),
                                            g_rgb, g_sig, rgb3, up(acts))
        else:
            dlogit3 = (g_rgb * rgb3 * (1.0 - rgb3)).to(cd).float()
            dr1 = torch.where(acts[8].float() > 0,
                              dlogit3.T @ ws[22].float().T, 0.0)
            dbvec = dr1.to(cd).float() @ ws[19].float().T
            # the unrounded sum is the plain version's dbb
            torch.testing.assert_close(dbvec.sum(0, keepdim=True), want[18],
                                       rtol=1e-5, atol=1e-7)
            got = list(want)
            got[18] = dbvec.to(cd).float().sum(0, keepdim=True)
    worst = max(np.linalg.norm((a - b).numpy()) / np.linalg.norm(b.numpy())
                for a, b in zip(got, want))
    assert worst > BF16_GRAD_REL, worst


def test_autograd_functions_match_module_autograd(nets):
    """torch.autograd.grad through VanillaMLP and PropMLP (plain versions on
    the CPU) equals autograd through the nn.Module forwards, f32, for every
    parameter; the encodings get no gradient."""
    _, _, port, _, _ = nets
    v, p = port[torch.float32]
    rng = np.random.default_rng(23)
    pos = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    g_rgb, g_sig = (torch.from_numpy(a) for a in _cotangents(24))
    enc_x = cat_pos_pe(pos, POS_L)
    enc_d = v.encode_dirs(dirs)

    rgb3, sig = ops.VanillaMLP.apply("cpu", enc_x, enc_d, *v.kernel_params())
    got = torch.autograd.grad((rgb3 * g_rgb).sum() + (sig * g_sig).sum(),
                              list(v.parameters()))
    rgb, sig_m = v(pos, dirs)
    want = torch.autograd.grad((rgb.T * g_rgb).sum() + (sig_m * g_sig).sum(),
                               list(v.parameters()))
    for (name, _), a, b in zip(v.named_parameters(), got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)

    dens = ops.PropMLP.apply("cpu", enc_x, *p.kernel_params())
    got = torch.autograd.grad((dens * g_sig).sum(), list(p.parameters()))
    want = torch.autograd.grad((p(pos) * g_sig).sum(), list(p.parameters()))
    for (name, _), a, b in zip(p.named_parameters(), got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
