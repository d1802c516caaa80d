"""The proposal net's residual pair of nerf_tpu_torch (``PropMLPRes``:
``prop_mlp_fwd_res`` and ``prop_mlp_bwd_res``, reached by
``prop_store_residuals=True`` or by None with ``store_residuals=True``)
against nerf_tpu: the plain versions through the autograd Function against
``make_prop_fused(store_residuals=True)`` in interpret mode, the residual
wrappers against the recompute ones on the CPU, and ``compute_loss`` of
both models with the proposal net in the residual form.

Small size: the kernels at H = 48, N = 150 points in 64-row tiles (a ragged
last tile); the steps at hidden 32 with 8 coarse + 16 fine samples
(``torch_port_common.step_loss_and_grads``).  Tolerances: the plain kernels
against Pallas f32 rtol 2e-4 / atol 1e-5, bf16 rtol 0.05 / atol 0.02
(tests/test_ops.py); ``compute_loss`` as tests/test_torch_recompute.py
states it (loss terms rtol 1e-4; vanilla grads by relative Frobenius error
2e-3 per weight-tuple tensor, Ref-NeRF rtol 5e-3 / atol 3e-4 on the flat
vector).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import assert_step_grads_close, step_loss_and_grads
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops.fused_mlp import prep_weights

TILE = 64
N = 150
H = 48
KERNEL_TOLS = {torch.float32: dict(rtol=2e-4, atol=1e-5),
               torch.bfloat16: dict(rtol=0.05, atol=0.02)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _prop_case(dtype, seed=0):
    """f32 numpy weights N(0, 1/fan_in), N(0, 0.1^2) of a width-H proposal
    net, its encoding (N, 63) in ``dtype`` and a cotangent (N,)."""
    rng = np.random.default_rng(seed)
    ws = []
    for m in ((63, H), (H, H), (H, H), (H, H), (H, 1)):
        ws += [rng.normal(0, 1 / np.sqrt(m[0]), m).astype(np.float32),
               rng.normal(0, 0.1, (1, m[1])).astype(np.float32)]
    x = _t(rng.uniform(-1, 1, (N, 63)).astype(np.float32)).to(dtype)
    g = rng.normal(size=N).astype(np.float32)
    return ws, x, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prop_res_matches_pallas(dtype):
    """PropMLPRes (prop_mlp_fwd_res_plain, then prop_mlp_bwd_res_plain on
    its activations) against make_prop_fused with store_residuals=True in
    interpret mode: the density and the 10 grads."""
    ws, x, g = _prop_case(dtype)
    cd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    fused = jfused.make_prop_fused(cd, TILE, interpret=True,
                                   store_residuals=True)
    jx = jnp.asarray(x.float().numpy(), cd)
    jden, vjp = jax.vjp(lambda w: fused(w, jx), tuple(map(jnp.asarray, ws)))
    (jgrads,) = vjp(jnp.asarray(g))

    params = [_t(w).requires_grad_() for w in ws]
    ops.reset_launches()
    den = ops.PropMLPRes.apply("cpu", x, *params)
    grads = torch.autograd.grad(den, params, _t(g))
    assert not any(ops.LAUNCHES.values())
    assert float(np.asarray(jden).std()) > 0.01
    np.testing.assert_allclose(den.detach().numpy(), np.asarray(jden),
                               **KERNEL_TOLS[dtype])
    assert len(grads) == 10
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   **KERNEL_TOLS[dtype], err_msg=f"grad {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prop_res_wrappers_equal_the_recompute_pair(dtype):
    """On the CPU the residual forward gives prop_mlp_fwd's density and the
    forward's activations, and the residual backward on them gives
    prop_mlp_bwd's grads, equal to the bit: the same arithmetic without the
    rebuild.  The operand checks refuse activations of the wrong count or
    shape."""
    ws, x, g = _prop_case(dtype, seed=1)
    wsc = prep_weights([_t(w) for w in ws], dtype)
    den, acts = ops.prop_mlp_fwd_res(wsc, x, device="cpu")
    assert len(acts) == 4 and all(a.shape == (N, H) and a.dtype == dtype
                                  for a in acts)
    assert torch.equal(den, ops.prop_mlp_fwd(wsc, x, device="cpu"))
    got = ops.prop_mlp_bwd_res(wsc, x, _t(g), acts, device="cpu")
    want = ops.prop_mlp_bwd(wsc, x, _t(g), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="expected 4 activations"):
        ops.prop_mlp_bwd_res(wsc, x, _t(g), acts[:3], device="cpu")
    with pytest.raises(ValueError, match="activation 2"):
        ops.prop_mlp_bwd_res(wsc, x, _t(g),
                             (*acts[:2], acts[2][:7], acts[3]), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.prop_mlp_fwd_res(wsc, x)


# ---------------------------------------------------------------------------
# compute_loss with the proposal net's residual pair against nerf_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["vanilla", "ref"])
@pytest.mark.parametrize("kw", [
    dict(prop_store_residuals=True),
    dict(prop_store_residuals=None, store_residuals=True)])
def test_compute_loss_prop_res_matches_jax(model, kw):
    """Loss, metrics and every parameter grad of the step with the proposal
    net's residual pair: nerf_tpu's Pallas residual pair against the port's
    PropMLPRes, either by prop_store_residuals=True or by None following
    store_residuals=True."""
    got, want = step_loss_and_grads(model, **kw)
    assert_step_grads_close(model, got, want)
