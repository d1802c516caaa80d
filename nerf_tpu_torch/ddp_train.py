"""``python -m nerf_tpu_torch.ddp_train``: data-parallel training, one
process per rank (see cli/entry.py ``ddp_main``), e.g.

    python -m torch.distributed.run --nproc_per_node=N \\
        -m nerf_tpu_torch.ddp_train -s -w --epochs E ...
"""

import sys

from nerf_tpu_torch.cli.entry import ddp_main

if __name__ == "__main__":
    sys.exit(ddp_main())
