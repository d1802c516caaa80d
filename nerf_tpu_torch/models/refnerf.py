"""Ref-NeRF model (port of nerf_tpu/models/refnerf.py:37-137).

Spatial MLP: [pos, PE(pos, 10)] -> 4 layers -> skip concat -> 4 layers (the
last ``output_dim`` wide) -> heads {rho_tau 2, normal/diffuse/tint 9,
bottleneck}.  Directional MLP: [bottleneck, IDE(reflection, roughness),
n.d] -> 4 layers -> skip concat -> 4 layers -> sigmoid specular head, times
sigmoid(tint), plus sigmoid(diffuse), optionally through sRGB.  The density
is returned raw; the caller applies softplus(x + 0.5).  This is the eval
forward: the bottleneck noise of training comes with the training slice.

Numerics follow the flax module: every Dense computes in ``dtype`` (bf16
under ``-s``), the heads are rounded to it, and the normal, the reflection
and the IDE run in it too.  Parameters are named as the layout
``tools/export_torch_checkpoint.py -t`` writes (``spa_block1.0`` ...
``spec_rgb_head.0``), so an exported ``_mip.pt`` loads with
``load_state_dict``.  ``kernel_weights`` gives the operands of the fused
kernels (``ops/ref_fused.py``), whose numerics are the Pallas kernels'.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nerf_tpu_torch.core.encoding import (
    cat_pos_pe, ide_dim, integrated_dir_enc, linear_to_srgb,
)
from nerf_tpu_torch.models.mlp import Dense, kernel_bias, kernel_matrix, mlp
from nerf_tpu_torch.ops.launch import prep_weights
from nerf_tpu_torch.ops.ref_fused import (
    REF_DIR_BIASES, REF_SPA_BIASES, softplus,
)


def _trunk_params(block1, block2, d_in: int):
    """The weight tuple of a 4 + 4 skip trunk: (w0 b0 ... w3 b3 w4a w4b b4
    w5 b5 w6 b6 w7 b7), the skip layer's matrix split at the input width."""
    ws = []
    for lin in block1[0::2]:
        ws += [kernel_matrix(lin), kernel_bias(lin)]
    w4 = kernel_matrix(block2[0])
    ws += [w4[:d_in], w4[d_in:], kernel_bias(block2[0])]
    for lin in block2[2::2]:
        ws += [kernel_matrix(lin), kernel_bias(lin)]
    return ws


class RefNeRF(nn.Module):
    def __init__(self, pos_levels: int = 10, ide_level: int = 4,
                 hidden: int = 256, output_dim: int = 256,
                 bottleneck_dim: int = 128, use_srgb: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_levels = pos_levels
        self.ide_level = ide_level
        self.bottleneck_dim = bottleneck_dim
        self.use_srgb = use_srgb
        self.dtype = dtype
        self.d_x = 3 * (2 * pos_levels + 1)
        self.d_dir = bottleneck_dim + ide_dim(ide_level) + 1
        self.spa_block1 = mlp([hidden] * 4, self.d_x, dtype)
        self.spa_block2 = mlp([hidden, hidden, hidden, output_dim],
                              self.d_x + hidden, dtype)
        self.rho_tau_head = Dense(output_dim, 2, dtype)
        self.norm_col_tint_head = Dense(output_dim, 9, dtype)
        self.bottle_neck = Dense(output_dim, bottleneck_dim, dtype)
        self.dir_block1 = mlp([hidden] * 4, self.d_dir, dtype)
        self.dir_block2 = mlp([hidden, hidden, output_dim, output_dim],
                              self.d_dir + hidden, dtype)
        self.spec_rgb_head = mlp([3], output_dim, dtype,
                                 final_act=nn.Sigmoid())

    def spatial(self, pos: torch.Tensor) -> dict:
        """pos (..., 3) -> density (raw, f32), normal (unit, negated, f32),
        roughness softplus(rho - 1), diffuse and tint (pre-activation) and
        the bottleneck, the last four in the compute dtype."""
        enc = cat_pos_pe(pos, self.pos_levels, self.dtype)
        h = self.spa_block1(enc)
        inter = self.spa_block2(torch.cat([enc, h], dim=-1))
        rho_tau = self.rho_tau_head(inter)
        nct = self.norm_col_tint_head(inter)
        normal_raw = nct[..., 0:3]
        normal = -normal_raw / (torch.linalg.vector_norm(
            normal_raw, dim=-1, keepdim=True) + 1e-7)
        return {
            "density": rho_tau[..., 1].to(torch.float32),
            "normal": normal.to(torch.float32),
            "roughness": softplus(rho_tau[..., 0:1] - 1.0),
            "diffuse": nct[..., 3:6],
            "tint": nct[..., 6:9],
            "bottleneck": self.bottle_neck(inter),
        }

    def directional(self, spatial_out: dict,
                    dirs: torch.Tensor) -> torch.Tensor:
        """Spatial fields and the raw (unnormalized) view directions
        (..., 3) -> rgb (..., 3) f32, in eval: no bottleneck noise."""
        cd = self.dtype
        normal = spatial_out["normal"].to(cd)
        b = spatial_out["bottleneck"]
        dirs = dirs.to(cd)
        d_dot_n = torch.sum(dirs * normal, dim=-1, keepdim=True)
        reflect = dirs - 2.0 * d_dot_n * normal
        wr_ide = integrated_dir_enc(reflect, spatial_out["roughness"],
                                    self.ide_level)
        x = torch.cat([b, wr_ide, d_dot_n], dim=-1)
        h = self.dir_block1(x)
        h = self.dir_block2(torch.cat([x, h], dim=-1))
        specular = self.spec_rgb_head(h) * torch.sigmoid(spatial_out["tint"])
        diffuse = spatial_out["diffuse"]
        if self.use_srgb:
            diffuse = torch.sigmoid(diffuse - math.log(3.0))
            rgb = linear_to_srgb(specular + diffuse)
        else:
            rgb = specular + torch.sigmoid(diffuse)
        return rgb.to(torch.float32)

    def forward(self, pos: torch.Tensor, dirs: torch.Tensor):
        """(rgb (..., 3), raw density (...), normal (..., 3)), all f32."""
        spa = self.spatial(pos)
        rgb = self.directional(spa, dirs)
        return rgb, spa["density"], spa["normal"]

    def kernel_weights(self):
        """The fused kernels' operands: the spatial (23) and directional
        (19) weight tuples in the order of nerf_tpu/ops/ref_fused.py:51-75,
        (in, out) matrices in the compute dtype and (1, out) f32 biases; both
        skip layers are split at their trunk's input width, as
        ``ref_spatial_weights_from_params`` and
        ``ref_directional_weights_from_params`` (:1309, :1333) do."""
        spa = _trunk_params(self.spa_block1, self.spa_block2, self.d_x)
        for lin in (self.rho_tau_head, self.norm_col_tint_head,
                    self.bottle_neck):
            spa += [kernel_matrix(lin), kernel_bias(lin)]
        dr = _trunk_params(self.dir_block1, self.dir_block2, self.d_dir)
        head = self.spec_rgb_head[0]
        dr += [kernel_matrix(head), kernel_bias(head)]
        return (prep_weights([w.detach() for w in spa], REF_SPA_BIASES,
                             self.dtype),
                prep_weights([w.detach() for w in dr], REF_DIR_BIASES,
                             self.dtype))
