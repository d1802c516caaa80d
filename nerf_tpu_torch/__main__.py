"""``python -m nerf_tpu_torch``: the port's CLI (see cli/entry.py)."""

import sys

from nerf_tpu_torch.cli.entry import main

if __name__ == "__main__":
    sys.exit(main())
