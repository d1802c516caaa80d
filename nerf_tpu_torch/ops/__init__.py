"""Hand-written CUDA kernels for Hopper, their wrappers, plain versions and
autograd Functions."""

from nerf_tpu_torch.ops.fused_mlp import (
    PropMLP, VanillaMLP, prep_weights, prop_mlp_bwd, prop_mlp_bwd_plain,
    prop_mlp_fwd, prop_mlp_plain, vanilla_mlp_bwd, vanilla_mlp_bwd_plain,
    vanilla_mlp_fwd, vanilla_mlp_fwd_res, vanilla_mlp_fwd_res_plain,
    vanilla_mlp_plain,
)
from nerf_tpu_torch.ops.launch import LAUNCHES, reset_launches
from nerf_tpu_torch.ops.ref_fused import (
    ref_dir_fwd, ref_dir_plain, ref_fine_fwd, ref_spa_fwd, ref_spa_plain,
)

__all__ = ["LAUNCHES", "reset_launches", "prep_weights", "PropMLP",
           "VanillaMLP", "prop_mlp_fwd", "prop_mlp_plain", "prop_mlp_bwd",
           "prop_mlp_bwd_plain", "vanilla_mlp_fwd", "vanilla_mlp_plain",
           "vanilla_mlp_fwd_res", "vanilla_mlp_fwd_res_plain",
           "vanilla_mlp_bwd", "vanilla_mlp_bwd_plain", "ref_spa_fwd",
           "ref_spa_plain", "ref_dir_fwd", "ref_dir_plain", "ref_fine_fwd"]
