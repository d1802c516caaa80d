"""CLI main(): ``python -m nerf_tpu_torch -r [-e] [-s] [-w] ...``.

Only render-only mode (-r) is ported; without it the entry exits non-zero
and says that training is a later slice of the port.
"""

from __future__ import annotations

import sys

from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if not args.do_render:
        print("nerf_tpu_torch: training is a later slice of the port "
              "(ROADMAP.md); only render-only mode (-r) runs so far. "
              "Train with the JAX package (train.py) and export the model "
              "with tools/export_torch_checkpoint.py.", file=sys.stderr)
        return 2
    render_only(args)
    return 0
