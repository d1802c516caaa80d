"""``python -m nerf_tpu_torch.model_average``: model-averaging training, one
process per rank (see cli/entry.py ``ma_main``), e.g.

    python -m torch.distributed.run --nproc_per_node=N \\
        -m nerf_tpu_torch.model_average --ma_epoch 2 -s -w --epochs E ...
"""

import sys

from nerf_tpu_torch.cli.entry import ma_main

if __name__ == "__main__":
    sys.exit(ma_main())
