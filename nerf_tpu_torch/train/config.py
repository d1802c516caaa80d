"""Static pipeline configuration: the port's own copy of nerf_tpu's
``PipelineConfig`` (nerf_tpu/train/config.py), field for field, so that
``cli.flags.config_from_args`` maps the same flags to the same values.

Field defaults mirror the reference CLI defaults.  The vanilla render and
training paths read ``model``, ``near``, ``far``, ``n_coarse``, ``n_fine``,
``ray_batch``, ``white_bkg``, ``nerf_width``, ``prop_width``,
``max_blur_alpha``, ``use_bf16``, ``use_pallas``, ``store_residuals``,
``prop_store_residuals``, ``use_ipe`` and ``eval_use_pallas``; the other
fields belong to paths that are not ported yet (ROADMAP.md) and are kept so
that a config means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PipelineConfig:
    model: str = "vanilla"            # "vanilla" | "ref" | "mip"
    mip_coarse_loss_w: float = 0.1    # true Mip-NeRF coarse-pass MSE weight
    near: float = 2.0
    far: float = 6.0
    n_coarse: int = 64                # --coarse_sample_pnum
    n_fine: int = 128                 # --fine_sample_pnum
    ray_batch: int = 1024             # --sample_ray_num
    white_bkg: bool = False           # -w (eval composite only)
    use_srgb: bool = False            # -u
    prop_normal: bool = False         # --prop_normal
    ide_level: int = 4                # --ide_level
    bottleneck_noise: float = 0.02    # --bottle_neck_noise
    nerf_width: int = 256             # --nerf_net_width
    prop_width: int = 256             # --prop_net_width
    max_blur_alpha: float = 0.01      # proposal max-blur padding
    # loss coefficients
    normal_loss_w: float = 4e-4
    coarse_normal_rel_w: float = 0.1
    backface_w: float = 0.1
    # optional regularizers
    distortion_w: float = 0.0
    entropy_w: float = 0.0
    entropy_acc_threshold: float = 0.1
    # numerics: bf16 compute with f32 parameters (-s)
    use_bf16: bool = False
    # fused MLP kernels on the training path (None = on)
    use_pallas: bool | None = None
    # points per kernel grid step in the JAX package; the port's kernels
    # pick their own tile (ops/fused_mlp.py)
    pallas_tile: int = 2048
    # Mip-NeRF integrated positional encoding for the vanilla fine net
    use_ipe: bool = False
    ipe_radius: float = 0.0
    # differentiate through the density-gradient normal targets (Ref-NeRF)
    second_order_normals: bool = False
    # Ref-NeRF kernel strategy ("all" | "hybrid")
    ref_kernels: str = "all"
    # training-kernel backward strategies: the fine nets store their
    # activations (True) or recompute them in the backward (False); the
    # proposal net follows store_residuals when prop_store_residuals is
    # None.  The port raises for the proposal net's residual pair.
    store_residuals: bool = True
    prop_store_residuals: Optional[bool] = False
    bwd_bufs: Optional[int] = None
    # Eval/render MLP route.  None or True: the fused MLP kernels
    # (ops/fused_mlp.py, CUDA on the card, their plain versions on the CPU).
    # False: the nn.Module forward (models/), the per-layer oracle.
    eval_use_pallas: Optional[bool] = None
    # angle-doubling spatial PE for the kernel paths (JAX package only)
    pe_doubling: bool = False
    # reproduce the reference's coarse_grad_select off-by-one (Ref-NeRF)
    legacy_coarse_select: bool = False

    @property
    def n_merged(self) -> int:
        """Ref-path sample count after coarse/fine merge minus the dropped tail."""
        return self.n_coarse + self.n_fine

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
