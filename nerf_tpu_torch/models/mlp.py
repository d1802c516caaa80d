"""Dense layer with flax's initialization and compute-dtype semantics
(port of nerf_tpu/models/mlp.py).

Parameters stay f32; ``dtype`` is the compute dtype (bf16 under ``-s``):
input, weight and bias are cast to it, as flax ``nn.Dense(dtype=...)`` does.

Init: flax's ``truncated_normal(stddev=0.02)`` draws a standard normal
truncated to [-2, 2] and rescales it by 0.02 / 0.8796... (the truncated
normal's own std), so the result has std 0.02.  ``torch.nn.init
.trunc_normal_(std=0.02)`` truncates at +-2 absolute instead, so the port
draws its own.  Biases start at zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated to [-2, 2] (flax's stddev_adjust)
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Fill ``t`` as flax's ``truncated_normal(stddev)`` does, by inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    x = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    with torch.no_grad():
        t.copy_(torch.clamp(x, -2.0, 2.0) * (stddev / _TRUNC_STD))
    return t


class Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        # no draw from the global RNG: init_flax_ fills the weights from an
        # explicit generator
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax rounds the product to ``dtype`` and then adds the bias in
        # ``dtype``; F.linear with a bias (addmm) would round once
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd)) + self.bias.to(cd)


def init_flax_(module: nn.Module, generator: torch.Generator | None = None):
    """Flax init for every Dense in ``module``: truncated-normal(0.02)
    weights and zero biases, drawn on the CPU from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dense):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            truncated_normal_(w, 0.02, generator)
            with torch.no_grad():
                m.weight.copy_(w)
                m.bias.zero_()
    return module


def mlp(widths, in_features: int, dtype: torch.dtype,
        final_act: nn.Module | None = None) -> nn.Sequential:
    """Dense+ReLU stack in the reference's ``nn.Sequential`` layout (so the
    state-dict keys are ``<name>.0``, ``<name>.2``, ...); the last layer's
    activation is ReLU unless ``final_act`` is given."""
    layers = []
    for i, w in enumerate(widths):
        layers.append(Dense(in_features, w, dtype))
        last = i == len(widths) - 1
        act = final_act if last and final_act is not None else nn.ReLU()
        layers.append(act)
        in_features = w
    return nn.Sequential(*layers)


def kernel_matrix(layer: Dense) -> torch.Tensor:
    """(in, out) f32 weight, a differentiable view of the parameter."""
    return layer.weight.T


def kernel_bias(layer: Dense) -> torch.Tensor:
    """(1, out) f32 bias, a differentiable view of the parameter."""
    return layer.bias.reshape(1, -1)
