"""Learning-rate schedule: linear warmup, exponential decay and a floor
(port of nerf_tpu/train/schedule.py).

The schedule is a host function of the step: the trainer keeps the step on
the host and sets the optimizer's rate before each update, so evaluating it
reads nothing from the device.  The values are the JAX package's f32 ones.
"""

from __future__ import annotations

import numpy as np


def scaled_base_lr(lr: float, sample_ray_num: int) -> float:
    """The reference scales the base rate with the ray batch (rays / 512)."""
    return lr * sample_ray_num / 512.0


def decay_schedule(lr: float, min_ratio: float = 0.01, decay_rate: float = 0.1,
                   decay_step: int = 100000, warmup_step: int = 500):
    """step -> learning rate: from lr * min_ratio up to lr over
    ``warmup_step`` steps, then lr * max(decay_rate^((step - warmup) /
    decay_step), min_ratio)."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if step < warmup_step:
            ratio = step / f32(warmup_step)
            return float(f32(lr) * (f32(min_ratio) * (f32(1.0) - ratio)
                                    + ratio))
        decay = np.maximum(
            f32(decay_rate) ** ((step - f32(warmup_step)) / f32(decay_step)),
            f32(min_ratio))
        return float(f32(lr) * decay)

    return schedule
