"""The fused MLP wrappers of nerf_tpu_torch.ops: their plain versions against
the Pallas kernels of nerf_tpu.ops in interpret mode, and their dispatch.
The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import random_params
from nerf_tpu.models import ProposalNetwork as JaxProp
from nerf_tpu.models import VanillaNeRF as JaxVanilla
from nerf_tpu.ops import (
    make_prop_fused, make_vanilla_fused, prop_weights_from_params,
    vanilla_weights_from_params,
)
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.models import ProposalNetwork, VanillaNeRF

POS_L, DIR_L = 4, 2     # small encodings keep interpret mode fast
N, TILE = 70, 32        # N deliberately not a multiple of the tile
DX, DD = 3 * (2 * POS_L + 1), 3 * (2 * DIR_L + 1)
TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-6),   # tests/test_ops.py:53
        torch.bfloat16: dict(rtol=0.05, atol=0.02)}  # tests/test_ops.py:117
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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
    assert ops.LAUNCHES == {"prop_mlp_fwd": 0, "vanilla_mlp_fwd": 0}


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


@pytest.mark.parametrize("fn", ["prop", "vanilla"])
def test_wrappers_never_run_quietly_on_cpu(nets, fn):
    """Without device="cpu" a wrapper targets the card: here, with CPU
    tensors, it raises instead of taking the plain version."""
    _, _, port, enc_x, enc_d = nets
    v, p = port[torch.float32]
    x, d = torch.from_numpy(enc_x), torch.from_numpy(enc_d)
    with pytest.raises((RuntimeError, ValueError)):
        if fn == "prop":
            ops.prop_mlp_fwd(p.kernel_weights(), x)
        else:
            ops.vanilla_mlp_fwd(v.kernel_weights(), x, d)

