"""CLI main()s: ``python -m nerf_tpu_torch [-r [-e]] [-s] [-w] ...`` and the
distributed modes' ``python -m nerf_tpu_torch.ddp_train`` and ``python -m
nerf_tpu_torch.model_average`` (port of nerf_tpu/cli/entry.py:9-78).

With ``-r`` they render with a trained model (cli/render.py); without it
they train (cli/trainer.py).  ``main`` runs on one device.  ``ddp_main`` and
``ma_main`` take ``nerf_tpu``'s extra flags of each mode and run one process
per rank, launched by ``python -m torch.distributed.run --nproc_per_node=N``
(torchrun) or with ``--coordinator``/``--num_processes``/``--process_id``;
each rank on ``cuda:LOCAL_RANK`` with NCCL (gloo on the CPU, or where
``backend`` says).  Everything runs on the CUDA device unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import os

from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only
from nerf_tpu_torch.cli.trainer import train
from nerf_tpu_torch.parallel import AVERAGE_STRATEGIES, destroy_process_group


def main(argv=None, device=None) -> int:
    args = get_parser().parse_args(argv)
    if args.do_render:
        render_only(args, device)
    else:
        train(args, device)
    return 0


def _add_rendezvous_flags(parser) -> None:
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host coordinator address (host:port)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def ddp_parser():
    """nerf_tpu's ddp flags (nerf_tpu/cli/entry.py:20-31)."""
    parser = get_parser()
    _add_rendezvous_flags(parser)
    parser.add_argument("--no_sync_prop", default=False, action="store_true",
                        help="reference parity: don't sync proposal-net grads "
                             "(ddp_train.py:4,98)")
    return parser


def ma_parser():
    """nerf_tpu's ma flags (nerf_tpu/cli/entry.py:45-67)."""
    parser = get_parser()
    parser.add_argument("--ma_epoch", required=True, type=int,
                        help="Model average will be used each <ma_epoch> epoch")
    parser.add_argument("--ma_method", type=str, default="all_reduce",
                        choices=AVERAGE_STRATEGIES,
                        help="Model average strategies")
    parser.add_argument("-div", "--div", default=False, action="store_true",
                        help="Whether to use divided dataset (_div.json)")
    parser.add_argument("--allow_imbalanced", default=False,
                        action="store_true",
                        help="Whether to allow imbalanced dataset")
    parser.add_argument("--num_replicas", type=int, default=None,
                        help="model-averaging replicas (default: all local "
                             "devices; must match the dataset division count "
                             "under -div)")
    _add_rendezvous_flags(parser)
    return parser


def _distributed_main(mode: str, parser, argv, device, backend) -> int:
    args = parser.parse_args(argv)
    if args.do_render:
        # one render, by the first process of the job
        rank = (args.process_id if args.process_id is not None
                else int(os.environ.get("RANK", 0)))
        if rank == 0:
            render_only(args, device)
        return 0
    try:
        train(args, device, mode=mode, backend=backend)
    finally:
        destroy_process_group()
    return 0


def ddp_main(argv=None, device=None, backend=None) -> int:
    """Data-parallel training (reference: ddp_train.py)."""
    return _distributed_main("ddp", ddp_parser(), argv, device, backend)


def ma_main(argv=None, device=None, backend=None) -> int:
    """Model-averaging training (reference: model_average.py)."""
    return _distributed_main("ma", ma_parser(), argv, device, backend)
