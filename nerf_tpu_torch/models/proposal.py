"""Proposal network (port of nerf_tpu/models/proposal.py:18-36).

[pos, PE(pos, 10)] -> 4 x (Dense 256 + ReLU) -> Dense 1: the raw density per
sample.  Parameters are named as the reference's torch module (``layers.0``
... ``layers.8``), so a reference or exported ``_prop.pt`` loads with
``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.models.mlp import Dense, kernel_bias, kernel_matrix, mlp
from nerf_tpu_torch.ops.fused_mlp import prep_weights


class ProposalNetwork(nn.Module):
    def __init__(self, pos_levels: int = 10, hidden: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_levels = pos_levels
        self.dtype = dtype
        trunk = mlp([hidden] * 4, 3 * (2 * pos_levels + 1), dtype)
        self.layers = nn.Sequential(*trunk, Dense(hidden, 1, dtype))

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        """pos (..., 3) -> raw density (...) f32; the caller activates it."""
        out = self.layers(cat_pos_pe(pos, self.pos_levels, self.dtype))
        return out[..., 0].to(torch.float32)

    def kernel_params(self):
        """The fused kernel's flat weight tuple (w0 b0 ... w3 b3 wo bo) as
        differentiable f32 views of the parameters ((in, out) matrices,
        (1, out) biases): the operands of ``ops.PropMLP`` in training."""
        ws = []
        for lin in self.layers[0::2]:
            ws += [kernel_matrix(lin), kernel_bias(lin)]
        return tuple(ws)

    def kernel_weights(self):
        """The kernel operands for inference: ``kernel_params`` detached,
        matrices in the compute dtype, biases f32."""
        return prep_weights([w.detach() for w in self.kernel_params()],
                            self.dtype)
