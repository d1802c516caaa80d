"""Hand-written CUDA kernels for Hopper, their wrappers, plain versions and
autograd Functions."""

from nerf_tpu_torch.ops.fused_mlp import (
    PropMLP, PropMLPRes, VanillaMLP, VanillaMLPRecompute, prep_weights,
    prop_mlp_bwd, prop_mlp_bwd_plain, prop_mlp_bwd_res,
    prop_mlp_bwd_res_plain, prop_mlp_fwd, prop_mlp_fwd_res,
    prop_mlp_fwd_res_plain, prop_mlp_plain, vanilla_mlp_bwd,
    vanilla_mlp_bwd_plain, vanilla_mlp_bwd_recompute,
    vanilla_mlp_bwd_recompute_plain, vanilla_mlp_fwd, vanilla_mlp_fwd_res,
    vanilla_mlp_fwd_res_plain, vanilla_mlp_plain,
)
from nerf_tpu_torch.ops.launch import LAUNCHES, reset_launches
from nerf_tpu_torch.ops.ref_dissect import (
    ref_dir_bwd_dissect, ref_dir_bwd_dissect_plain, ref_dir_fwd_dissect,
    ref_dir_fwd_dissect_plain,
)
from nerf_tpu_torch.ops.ref_fused import (
    RefDirectionalMLP, RefDirectionalMLPRecompute, RefSpatialMLP,
    RefSpatialMLPRecompute, ref_dir_bwd, ref_dir_bwd_plain,
    ref_dir_bwd_recompute, ref_dir_bwd_recompute_plain, ref_dir_fwd,
    ref_dir_fwd_res, ref_dir_fwd_res_plain, ref_dir_plain, ref_fine_fwd,
    ref_spa_bwd, ref_spa_bwd_plain, ref_spa_bwd_recompute,
    ref_spa_bwd_recompute_plain, ref_spa_fwd, ref_spa_fwd_grad,
    ref_spa_fwd_grad_plain, ref_spa_fwd_res, ref_spa_fwd_res_plain,
    ref_spa_plain,
)

__all__ = ["LAUNCHES", "reset_launches", "prep_weights", "PropMLP",
           "PropMLPRes", "VanillaMLP", "VanillaMLPRecompute", "prop_mlp_fwd",
           "prop_mlp_plain", "prop_mlp_fwd_res", "prop_mlp_fwd_res_plain",
           "prop_mlp_bwd", "prop_mlp_bwd_plain", "prop_mlp_bwd_res",
           "prop_mlp_bwd_res_plain",
           "vanilla_mlp_fwd", "vanilla_mlp_plain", "vanilla_mlp_fwd_res",
           "vanilla_mlp_fwd_res_plain", "vanilla_mlp_bwd",
           "vanilla_mlp_bwd_plain", "vanilla_mlp_bwd_recompute",
           "vanilla_mlp_bwd_recompute_plain", "ref_spa_fwd",
           "ref_spa_plain", "ref_dir_fwd", "ref_dir_plain", "ref_fine_fwd",
           "RefSpatialMLP", "RefDirectionalMLP", "RefSpatialMLPRecompute",
           "RefDirectionalMLPRecompute", "ref_spa_fwd_res",
           "ref_spa_fwd_res_plain", "ref_spa_fwd_grad",
           "ref_spa_fwd_grad_plain", "ref_dir_fwd_res",
           "ref_dir_fwd_res_plain", "ref_spa_bwd", "ref_spa_bwd_plain",
           "ref_spa_bwd_recompute", "ref_spa_bwd_recompute_plain",
           "ref_dir_bwd", "ref_dir_bwd_plain", "ref_dir_bwd_recompute",
           "ref_dir_bwd_recompute_plain", "ref_dir_fwd_dissect",
           "ref_dir_fwd_dissect_plain", "ref_dir_bwd_dissect",
           "ref_dir_bwd_dissect_plain"]
