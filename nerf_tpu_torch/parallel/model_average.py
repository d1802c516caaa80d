"""Weighted parameter averaging over the replica group (port of
nerf_tpu/parallel/model_average.py:31-74).

Every replica ends up with ``sum_i w_i * x_i`` over the replicas ``i``, the
weights normalized to sum 1, one collective schedule per net on one flat
buffer of its parameters:

- ``all_reduce``: a SUM of ``x * w`` (``:47-48``);
- ``broadcast``: an all_gather of ``x * w``, then a local sum in replica
  order (``:49-52``);
- ``p2p``: a ring (``:53-64``): each replica sends its buffer to ``i + 1``,
  receives from ``i - 1``, forwards what it received and adds it, so each
  replica sums in ``nerf_tpu``'s order.

The reference's ``delicate`` strategy is an unimplemented stub upstream and
is rejected, as ``nerf_tpu`` rejects it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AVERAGE_STRATEGIES = ("all_reduce", "broadcast", "p2p")


def check_strategy(strategy: str) -> None:
    if strategy not in AVERAGE_STRATEGIES:
        raise ValueError(
            f"unknown averaging strategy {strategy!r}; the reference's "
            f"'delicate' mode is an unimplemented stub upstream "
            f"(model_average.py:253-255). Choose from {AVERAGE_STRATEGIES}.")


def normalized_weights(weights: Optional[Sequence[float]],
                       n_replica: int) -> np.ndarray:
    """The division weights (uniform without them) as f32, over their sum,
    as nerf_tpu/cli/trainer.py:172-183 computes them."""
    if weights is not None and len(weights) != n_replica:
        raise ValueError(f"dataset has {len(weights)} division weights for "
                         f"{n_replica} replicas")
    w = (np.asarray(weights, np.float32) if weights is not None
         else np.full(n_replica, 1.0 / n_replica, np.float32))
    return w / w.sum()


def average_flat(x: torch.Tensor, weights: np.ndarray, replica: int, group,
                 strategy: str = "all_reduce") -> torch.Tensor:
    """The weighted sum over ``group`` (the replica group, group rank =
    replica) of every replica's ``x``; ``weights`` (n_replica,) f32."""
    check_strategy(strategy)
    n = len(weights)
    w = torch.tensor(weights[replica], dtype=x.dtype, device=x.device)
    mine = x * w
    if strategy == "all_reduce":
        dist.all_reduce(mine, group=group)
        return mine
    if strategy == "broadcast":
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=group)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc
    nxt = dist.get_global_rank(group, (replica + 1) % n)
    prv = dist.get_global_rank(group, (replica - 1) % n)
    acc = buf = mine
    for _ in range(n - 1):
        recv = torch.empty_like(buf)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
        buf = recv
        acc = acc + buf
    return acc


@torch.no_grad()
def average_models_(models, weights: np.ndarray, replica: int, group,
                    strategy: str = "all_reduce") -> None:
    """Replace each net's parameters by their weighted average over the
    replica group, one flat buffer and one collective schedule per net."""
    for m in models:
        if m is None:
            continue
        params = list(m.parameters())
        flat = torch.cat([p.reshape(-1) for p in params])
        avg = average_flat(flat, weights, replica, group, strategy)
        for p, v in zip(params, avg.split([p.numel() for p in params])):
            p.copy_(v.view_as(p))
