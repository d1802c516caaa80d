"""Process groups of the distributed modes (port of
nerf_tpu/parallel/mesh.py:29-100).

``nerf_tpu`` runs one SPMD program over a ('replica', 'data') mesh.  The port
runs one process per rank, and rank ``r`` sits at ``(replica, data) =
divmod(r, n_data)``: the row-major reshape of ``make_mesh``.  Each rank holds
its own replica's nets and Adam.  Its groups:

- its data group, the ranks of its replica row: the grads' mean each step;
- its replica group, the ranks of its data column: the weighted parameter
  average of the model-averaging mode;
- the grid group, every rank of the grid: the epoch's metrics, the eval
  render, the eval nets;
- the control group, the same ranks on gloo: host-side flags (the
  cooperative stop) and the checkpoint gather of host tensors, so that
  neither syncs the device's stream.

Ranks past ``n_replica * n_data`` are idle: they create every group (every
rank calls ``new_group`` for every group, in the same order) and train
nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from nerf_tpu_torch.device import resolve_device


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``None`` (torchrun sets
    ``LOCAL_RANK``; 0 without it), else ``device``.  A CUDA device becomes
    the current one.  Raises when CUDA is asked for and absent."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def init_process_group(device: torch.device, backend: Optional[str] = None,
                       coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> None:
    """Join the job's process group, unless this process is in one already.

    From ``coordinator`` (``host:port`` as ``nerf_tpu``'s ``--coordinator``
    takes it, reached as ``tcp://``, or an init URL such as ``file://...``)
    with ``num_processes`` and ``process_id``; else from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    else alone, world size 1.  The backend is NCCL on CUDA and gloo on the
    CPU unless ``backend`` names another.  A failed rendezvous raises."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class Grid:
    """This rank's place in the (replica, data) grid and its groups."""

    n_replica: int
    n_data: int
    rank: int
    device: torch.device
    data_group: Any = None
    replica_group: Any = None
    grid_group: Any = None
    control_group: Any = None

    @property
    def size(self) -> int:
        return self.n_replica * self.n_data

    @property
    def active(self) -> bool:
        return self.rank < self.size

    @property
    def replica(self) -> int:
        return self.rank // self.n_data

    @property
    def data(self) -> int:
        return self.rank % self.n_data

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_grid(n_replica: int, n_data: int, device: torch.device) -> Grid:
    """The grid of the initialized process group's first ``n_replica *
    n_data`` ranks and this rank's groups (a collective: every rank of the
    process group calls it)."""
    world = dist.get_world_size()
    if n_replica * n_data > world:
        raise ValueError(f"a {n_replica}x{n_data} grid needs "
                         f"{n_replica * n_data} ranks; the world has {world}")
    grid = Grid(n_replica, n_data, dist.get_rank(), device)
    for i in range(n_replica):
        group = dist.new_group([i * n_data + j for j in range(n_data)])
        if grid.active and grid.replica == i:
            grid.data_group = group
    for j in range(n_data):
        group = dist.new_group([i * n_data + j for i in range(n_replica)])
        if grid.active and grid.data == j:
            grid.replica_group = group
    ranks = list(range(grid.size))
    grid.grid_group = dist.new_group(ranks)
    grid.control_group = dist.new_group(ranks, backend="gloo")
    return grid
