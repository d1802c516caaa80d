"""Weight bridge and models of nerf_tpu_torch against the flax modules."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import configs, jax_variables, port_models
from nerf_tpu.models import ProposalNetwork as JaxProp
from nerf_tpu.models import VanillaNeRF as JaxVanilla
from nerf_tpu_torch import bridge
from nerf_tpu_torch.models import ProposalNetwork, VanillaNeRF
from nerf_tpu_torch.models.mlp import init_flax_, truncated_normal_

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from export_torch_checkpoint import (  # noqa: E402
    prop_to_torch_sd, vanilla_to_torch_sd,
)

TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-6),   # tests/test_ops.py:53
        torch.bfloat16: dict(rtol=0.05, atol=0.02)}  # tests/test_ops.py:117


@pytest.fixture(scope="module")
def variables():
    return jax_variables(configs()[0], seed=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("net", ["nerf", "prop"])
def test_bridge_round_trip_bit_exact(variables, net):
    params = variables[net]
    back = bridge.state_dict_to_flax(bridge.flax_to_state_dict(params, net),
                                     net)
    want = dict(_leaves(params))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


@pytest.mark.parametrize("net,export", [("nerf", vanilla_to_torch_sd),
                                        ("prop", prop_to_torch_sd)])
def test_bridge_matches_export_tool(variables, net, export):
    ours = bridge.flax_to_state_dict(variables[net], net)
    ref = export(variables[net])
    assert list(ours) == list(ref)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
    model = (VanillaNeRF(hidden=32) if net == "nerf"
             else ProposalNetwork(hidden=32))
    model.load_state_dict(ref)   # strict: the reference layout loads as is


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_models_match_flax(variables, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1.5, 1.5, (5, 7, 3)).astype(np.float32)
    dirs = rng.normal(size=(5, 7, 3)).astype(np.float32)
    nerf, prop = port_models(configs(use_bf16=dtype == torch.bfloat16)[1],
                             variables)
    rgb, sigma = nerf(torch.from_numpy(pos), torch.from_numpy(dirs))
    jrgb, jsigma = JaxVanilla(hidden=32, dtype=jdt).apply(
        {"params": variables["nerf"]}, pos, dirs)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **TOLS[dtype])
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma),
                               **TOLS[dtype])
    dens = prop(torch.from_numpy(pos))
    jdens = JaxProp(hidden=32, dtype=jdt).apply(
        {"params": variables["prop"]}, pos)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), **TOLS[dtype])


def test_init_variables_layout():
    """The port's fresh state dicts have the reference torch layout."""
    from nerf_tpu_torch.train.pipeline import init_variables

    jcfg, cfg = configs()
    ours = init_variables(cfg)
    params = jax_variables(jcfg)
    assert list(ours["nerf"]) == list(vanilla_to_torch_sd(params["nerf"]))
    assert list(ours["prop"]) == list(prop_to_torch_sd(params["prop"]))
    for net in ("nerf", "prop"):
        ref = bridge.flax_to_state_dict(params[net], net)
        for k, v in ours[net].items():
            assert v.shape == ref[k].shape and v.dtype == torch.float32, k


def test_flax_init_statistics():
    """Weights ~ N(0, 0.02) truncated at two of its own standard deviations,
    as flax's truncated_normal(stddev=0.02); biases zero."""
    w = truncated_normal_(torch.empty(400, 500), 0.02,
                          torch.Generator().manual_seed(0))
    assert abs(float(w.std()) - 0.02) < 4e-4
    assert float(w.abs().max()) <= 0.04 / 0.87962566103423978 + 1e-7
    assert abs(float(w.mean())) < 2e-4
    m = init_flax_(VanillaNeRF(hidden=32), torch.Generator().manual_seed(1))
    again = init_flax_(VanillaNeRF(hidden=32), torch.Generator().manual_seed(1))
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        if k.endswith("bias"):
            assert not a.any()
