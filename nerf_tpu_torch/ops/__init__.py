"""Hand-written CUDA kernels for Hopper, their wrappers, plain versions and
autograd Functions."""

from nerf_tpu_torch.ops.fused_mlp import (
    LAUNCHES, PropMLP, VanillaMLP, prep_weights, prop_mlp_bwd,
    prop_mlp_bwd_plain, prop_mlp_fwd, prop_mlp_plain, reset_launches,
    vanilla_mlp_bwd, vanilla_mlp_bwd_plain, vanilla_mlp_fwd,
    vanilla_mlp_fwd_res, vanilla_mlp_fwd_res_plain, vanilla_mlp_plain,
)

__all__ = ["LAUNCHES", "reset_launches", "prep_weights", "PropMLP",
           "VanillaMLP", "prop_mlp_fwd", "prop_mlp_plain", "prop_mlp_bwd",
           "prop_mlp_bwd_plain", "vanilla_mlp_fwd", "vanilla_mlp_plain",
           "vanilla_mlp_fwd_res", "vanilla_mlp_fwd_res_plain",
           "vanilla_mlp_bwd", "vanilla_mlp_bwd_plain"]
