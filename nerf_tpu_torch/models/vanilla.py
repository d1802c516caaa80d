"""Vanilla NeRF MLP (port of nerf_tpu/models/vanilla.py:21-66).

[pos, PE(pos, 10)] -> 4-layer block -> skip concat -> 3-layer block ->
{opacity head, bottleneck}; the RGB head runs over
cat(bottleneck, [dir, PE(dir, 4)]) and ends in a sigmoid.  Parameters are
named as the reference's torch module (``lin_block1.0`` ... ``rgb_layer.2``),
so a reference or exported ``_mip.pt`` loads with ``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.models.mlp import Dense, kernel_bias, kernel_matrix, mlp
from nerf_tpu_torch.ops.fused_mlp import prep_weights


class VanillaNeRF(nn.Module):
    def __init__(self, pos_levels: int = 10, dir_levels: int = 4,
                 hidden: int = 256, bottleneck: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_levels = pos_levels
        self.dir_levels = dir_levels
        self.dtype = dtype
        self.d_x = 3 * (2 * pos_levels + 1)
        self.d_d = 3 * (2 * dir_levels + 1)
        self.lin_block1 = mlp([hidden] * 4, self.d_x, dtype)
        self.lin_block2 = mlp([hidden, hidden, bottleneck], self.d_x + hidden,
                              dtype)
        self.opacity_head = nn.Sequential(Dense(bottleneck, 1, dtype))
        self.bottle_neck = nn.Sequential(Dense(bottleneck, bottleneck, dtype))
        self.rgb_layer = mlp([128, 3], bottleneck + self.d_d, dtype,
                             final_act=nn.Sigmoid())

    def encode_dirs(self, dirs: torch.Tensor) -> torch.Tensor:
        """[d/|d|, PE(d/|d|)] (..., 27) f32 for unnormalized dirs (..., 3)."""
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        return cat_pos_pe(d, self.dir_levels)

    def forward(self, pos: torch.Tensor, dirs: torch.Tensor,
                enc_x: torch.Tensor | None = None,
                enc_d: torch.Tensor | None = None):
        """pos, dirs (..., 3) -> (rgb (..., 3), raw sigma (...)), both f32.

        ``enc_x`` (..., 63) replaces the position encoding [pos, PE(pos)]
        (the IPE paths pass [mu, IPE]); ``enc_d`` replaces the direction
        encoding of ``dirs`` (callers whose dirs are per ray encode once per
        ray and broadcast).
        """
        if enc_d is None:
            enc_d = self.encode_dirs(dirs)
        x = (cat_pos_pe(pos, self.pos_levels, self.dtype) if enc_x is None
             else enc_x.to(self.dtype))
        h = self.lin_block1(x)
        h = self.lin_block2(torch.cat([x, h], dim=-1))
        sigma = self.opacity_head(h)[..., 0]
        b = self.bottle_neck(h)
        rgb = self.rgb_layer(torch.cat([b, enc_d.to(self.dtype)], dim=-1))
        return rgb.to(torch.float32), sigma.to(torch.float32)

    def kernel_params(self):
        """The fused kernel's flat 24-entry weight tuple, in the order of
        nerf_tpu/ops/fused_mlp.py:79-92, as differentiable f32 views of the
        parameters ((in, out) matrices, (1, out) biases); the skip and
        rgb-input weights are split at the concat boundary.  The operands of
        ``ops.VanillaMLP`` in training: their grads flow back to the
        parameters, as through ``vanilla_weights_from_params``
        (fused_mlp.py:421-450)."""
        b1, b2, rgb = self.lin_block1, self.lin_block2, self.rgb_layer
        w4 = kernel_matrix(b2[0])
        wr1 = kernel_matrix(rgb[0])
        bneck = self.bottle_neck[0].out_features
        return (
            kernel_matrix(b1[0]), kernel_bias(b1[0]),
            kernel_matrix(b1[2]), kernel_bias(b1[2]),
            kernel_matrix(b1[4]), kernel_bias(b1[4]),
            kernel_matrix(b1[6]), kernel_bias(b1[6]),
            w4[:self.d_x], w4[self.d_x:], kernel_bias(b2[0]),
            kernel_matrix(b2[2]), kernel_bias(b2[2]),
            kernel_matrix(b2[4]), kernel_bias(b2[4]),
            kernel_matrix(self.opacity_head[0]),
            kernel_bias(self.opacity_head[0]),
            kernel_matrix(self.bottle_neck[0]),
            kernel_bias(self.bottle_neck[0]),
            wr1[:bneck], wr1[bneck:], kernel_bias(rgb[0]),
            kernel_matrix(rgb[2]), kernel_bias(rgb[2]),
        )

    def kernel_weights(self):
        """The kernel operands for inference: ``kernel_params`` detached,
        matrices in the compute dtype, biases f32."""
        return prep_weights([w.detach() for w in self.kernel_params()],
                            self.dtype)
