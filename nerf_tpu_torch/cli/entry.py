"""CLI main(): ``python -m nerf_tpu_torch [-r [-e]] [-s] [-w] ...``.

With ``-r`` it renders with a trained model (cli/render.py); without it it
trains (cli/trainer.py), single device.  Both run on the CUDA device.
"""

from __future__ import annotations

from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only
from nerf_tpu_torch.cli.trainer import train


def main(argv=None, device=None) -> int:
    args = get_parser().parse_args(argv)
    if args.do_render:
        render_only(args, device)
    else:
        train(args, device)
    return 0
