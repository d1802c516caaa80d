"""Epoch-level image order (port of nerf_tpu/data/sampler.py:23).

Every epoch visits each training image once, in a fresh order seeded by
(seed, epoch): the same permutation as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def epoch_image_order(n_images: int, epoch: int, seed: int = 0) -> np.ndarray:
    """Deterministic per-epoch permutation of image indices."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n_images).astype(np.int32)
