"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions."""

from nerf_tpu_torch.ops.fused_mlp import (
    LAUNCHES, prop_mlp_fwd, prop_mlp_plain, reset_launches, vanilla_mlp_fwd,
    vanilla_mlp_plain,
)

__all__ = ["LAUNCHES", "reset_launches", "prop_mlp_fwd", "prop_mlp_plain",
           "vanilla_mlp_fwd", "vanilla_mlp_plain"]
