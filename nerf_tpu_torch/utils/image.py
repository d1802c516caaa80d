"""Image output: float -> uint8 and the horizontal grid writer (port of
nerf_tpu/utils/image.py).  PNGs are encoded by ``utils/png.py``, so writing
an image needs no Pillow.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from nerf_tpu_torch.utils.png import write_png


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float (H, W[, 1|3]) -> uint8 RGB."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: Sequence[np.ndarray], nrow: int = 1,
              pad: int = 2, pad_value: int = 255) -> np.ndarray:
    """Tile images (same H, W) into a grid with ``nrow`` images per row."""
    tiles = [to_uint8(im) for im in images]
    h, w, _ = tiles[0].shape
    nrow = max(1, int(nrow))
    ncol = (len(tiles) + nrow - 1) // nrow
    grid = np.full((ncol * (h + pad) - pad, nrow * (w + pad) - pad, 3),
                   pad_value, np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, nrow)
        grid[r * (h + pad):r * (h + pad) + h,
             c * (w + pad):c * (w + pad) + w] = t
    return grid


def save_image_grid(path: str, images: Sequence[np.ndarray],
                    nrow: int = 1) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_png(path, make_grid(images, nrow=nrow))
