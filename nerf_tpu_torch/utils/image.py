"""Image output: float -> uint8 and the horizontal grid writer (port of
nerf_tpu/utils/image.py).  PNGs are encoded by ``utils/png.py``, so writing
an image needs no Pillow.  Also the resampling taps that the dataset loader
resizes with, in numpy and in the native loader, Pillow's bit for bit.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np

from nerf_tpu_torch.utils.png import write_png


PRECISION_BITS = 22        # Pillow's fixed point for 8-bit resampling


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int):
    """Pillow's bilinear (triangle) resampling of ``n_in`` samples to
    ``n_out`` (``Image.resize(..., BILINEAR)``, Resample.c): the support
    widened by the scale when shrinking, each output's taps renormalized,
    the weights in fixed point of PRECISION_BITS bits, every step in
    Pillow's own floating-point order.  (lo (n_out,) int32, weights
    (n_out, K) int32): output ``i`` is ``sum_k weights[i, k] *
    x[min(lo[i] + k, n_in - 1)]``, rows past a tap count padded with
    zeros."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support, ss = filterscale, 1.0 / filterscale
    los, rows = [], []
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        taps = min(int(center + support + 0.5), n_in) - lo
        ws, total = [], 0.0
        for k in range(taps):
            t = abs((k + lo - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            ws.append(w)
            total += w
        if total != 0.0:
            ws = [w / total for w in ws]
        los.append(lo)
        rows.append([int(0.5 + w * (1 << PRECISION_BITS)) for w in ws])
    weights = np.zeros((n_out, max(map(len, rows))), np.int32)
    for i, w in enumerate(rows):
        weights[i, :len(w)] = w
    lo = np.asarray(los, np.int32)
    lo.flags.writeable = weights.flags.writeable = False
    return lo, weights


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
