"""Data parallelism over the data group (port of
nerf_tpu/parallel/dp.py:83-147).

Each rank samples its rays from its own image with its own generator and
computes its grads; ``GradSync`` takes their mean over the data group after
the backward and before clipping and Adam (``nerf_tpu`` clips the pmean'd
grads).  The proposal net's grads stay unsynced under ``sync_prop=False``,
the reference's quirk (``:130-137``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def rank_seed(seed: int, index: int) -> int:
    """The generator seed of grid position ``index`` (``replica * n_data +
    data``): position 0 keeps ``seed``, so a world-1 run is the
    single-device run; every other position seeds from (seed, index), as
    ``nerf_tpu`` folds the device index into its key (``:112-118``)."""
    if index == 0:
        return int(seed)
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class GradSync:
    """The grads' mean over ``group`` (``n_data`` ranks): per synced net one
    flat all_reduce SUM, then a division by ``n_data`` (pmean's own
    arithmetic; ``ReduceOp.AVG`` does not exist on gloo).  Each ``.grad``
    becomes a view of its net's buffer, so nothing is copied back."""

    def __init__(self, models, group, n_data: int, sync_prop: bool = True):
        nerf, prop = models
        nets = [nerf] + ([prop] if prop is not None and sync_prop else [])
        self.nets = [list(m.parameters()) for m in nets]
        self.group, self.n_data = group, n_data

    @torch.no_grad()
    def __call__(self) -> None:
        for params in self.nets:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.n_data)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad = g.view_as(p)
