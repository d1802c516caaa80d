"""The distributed modes on torch.distributed (port of nerf_tpu/parallel):
the (replica, data) grid of process groups, the grads' mean over the data
group and the weighted parameter average over the replica group."""

from nerf_tpu_torch.parallel.dp import GradSync, rank_seed
from nerf_tpu_torch.parallel.mesh import (
    Grid, destroy_process_group, init_process_group, make_grid, rank_device,
)
from nerf_tpu_torch.parallel.model_average import (
    AVERAGE_STRATEGIES, average_flat, average_models_, check_strategy,
    normalized_weights,
)
