"""The optional regularizers of the training step (``--distortion_weight``,
``--entropy_weight``) against nerf_tpu: the two losses alone, values and
gradients, and ``compute_loss`` of both models with both weights set.

Tolerances: the losses alone rtol 1e-5 (f32, the same sums); the step as
``torch_port_common.step_loss_and_grads`` states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import assert_step_grads_close, step_loss_and_grads
from nerf_tpu.train import losses as jlosses
from nerf_tpu_torch.train import losses


def _t(a):
    return torch.from_numpy(np.array(a))


def test_regularizer_losses_match_jax():
    """reference_distortion_loss (with its row-normalised distances) and
    ray_entropy_loss, values and the gradient into the weights, on weights
    with some rays below the entropy mask's threshold and depths of the
    weights' own width, as the training step passes them."""
    rng = np.random.default_rng(4)
    w = rng.uniform(0, 0.2, (10, 16)).astype(np.float32)
    w[:3] *= 0.01                                  # masked out by entropy
    ts = np.sort(rng.uniform(2, 6, (10, 16)), -1).astype(np.float32)
    g = rng.normal(size=2).astype(np.float32)

    def jax_loss(x):
        return (g[0] * jlosses.reference_distortion_loss(x, jnp.asarray(ts))
                + g[1] * jlosses.ray_entropy_loss(x, 0.1))

    jval, jgrad = jax.value_and_grad(jax_loss)(jnp.asarray(w))
    wt = _t(w).requires_grad_()
    d = losses.reference_distortion_loss(wt, _t(ts))
    e = losses.ray_entropy_loss(wt, 0.1)
    np.testing.assert_allclose(
        float(d.detach()), float(jlosses.reference_distortion_loss(w, ts)),
        rtol=1e-5)
    np.testing.assert_allclose(float(e.detach()),
                               float(jlosses.ray_entropy_loss(w, 0.1)),
                               rtol=1e-5)
    total = g[0] * d + g[1] * e
    (grad,) = torch.autograd.grad(total, wt)
    np.testing.assert_allclose(float(total.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


def test_distortion_loss_over_interval_edges_raises_as_jax_does():
    """Over interval edges (P + 1 of them for P weights), the shape its
    docstring names, the JAX package's distortion loss raises (its pair
    matrix is P x P, its weight pairs (P - 1) x (P - 1)); so does the
    port's."""
    rng = np.random.default_rng(5)
    w = rng.uniform(0, 0.2, (4, 8)).astype(np.float32)
    ts = np.sort(rng.uniform(2, 6, (4, 9)), -1).astype(np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jlosses.reference_distortion_loss(jnp.asarray(w), jnp.asarray(ts))
    with pytest.raises(RuntimeError, match="must match the size"):
        losses.reference_distortion_loss(_t(w), _t(ts))


@pytest.mark.parametrize("model", ["vanilla", "ref"])
def test_compute_loss_with_regularizers_matches_jax(model):
    """Loss and every parameter grad of the step with distortion_w and
    entropy_w above 0 (the distortion loss over the fine depths, or the
    merged ones for Ref-NeRF): both terms move the loss far beyond its
    tolerance, so a step that dropped either one fails here."""
    got, want = step_loss_and_grads(model, distortion_w=0.5, entropy_w=0.05)
    assert_step_grads_close(model, got, want)
