"""Epoch-level image order and the model-averaging mode's division sampler
(port of nerf_tpu/data/sampler.py:23-97).

Every epoch visits each training image once, in a fresh order seeded by
(seed, epoch): the same permutation as the JAX package's.  Under model
averaging each replica samples only its own division of the images, shuffled
by (seed, epoch) and cut to the smallest division unless imbalance is
allowed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


def epoch_image_order(n_images: int, epoch: int, seed: int = 0) -> np.ndarray:
    """Deterministic per-epoch permutation of image indices."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n_images).astype(np.int32)


class LocalShuffleSampler:
    """One replica's division sampler.

    ``indices`` is the division id of each image (len == dataset size) or a
    number of replicas (an equal contiguous split, the last division taking
    the remainder).  ``epoch_indices(epoch)`` is this replica's image order
    for the epoch: its division shuffled with (seed, epoch), cut to the
    smallest division unless ``allow_imbalance``.
    """

    def __init__(self, n_images: int, indices: Union[Sequence[int], int],
                 rank: int, shuffle: bool = True, seed: int = 0,
                 allow_imbalance: bool = False):
        if isinstance(indices, (int, np.integer)):
            num_replicas = int(indices)
            division_len = n_images // num_replicas
            div = np.zeros(n_images, np.int32)
            for i in range(num_replicas - 1):
                div[i * division_len:(i + 1) * division_len] = i
            div[(num_replicas - 1) * division_len:] = num_replicas - 1
            indices = div
        else:
            indices = np.asarray(indices, np.int32)
            num_replicas = int(indices.max()) + 1
        if not (0 <= rank < num_replicas):
            raise ValueError(f"invalid rank {rank} for {num_replicas} "
                             f"replicas")
        self.num_replicas = num_replicas
        self.rank = rank
        self.samples: List[np.ndarray] = [
            np.nonzero(indices == i)[0].astype(np.int32)
            for i in range(num_replicas)]
        self.min_sample: Optional[int] = (
            None if allow_imbalance else min(len(s) for s in self.samples))
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self):
        own = len(self.samples[self.rank])
        return own if self.min_sample is None else self.min_sample

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This replica's (possibly truncated) image order for ``epoch``."""
        idx = self.samples[self.rank].copy()
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(idx)
        if self.min_sample is not None:
            idx = idx[:self.min_sample]
        return idx.astype(np.int32)

    @staticmethod
    def stacked_epoch_indices(samplers: Sequence["LocalShuffleSampler"],
                              epoch: int) -> np.ndarray:
        """(n_replicas, steps) int32, one row per replica, cut to the
        shortest row."""
        rows = [s.epoch_indices(epoch) for s in samplers]
        steps = min(len(r) for r in rows)
        return np.stack([r[:steps] for r in rows]).astype(np.int32)
