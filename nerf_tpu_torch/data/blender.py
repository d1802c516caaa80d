"""Blender-synthetic dataset loader, train and test splits (port of
nerf_tpu/data/blender.py).

``transforms_<split>.json`` gives ``camera_angle_x`` (optionally ``_y``) and
a 4x4 ``transform_matrix`` per frame; the PNGs of ``<split>/`` are listed in
natural order without the ``*normal*``/``*alpha*`` files.  Images are
resized by ``img_scale`` (Pillow's bilinear resampling, RGBA premultiplied,
bit for bit), composited onto white under ``white_bkg``, and
``scene_scale`` scales the translation.  Under ``use_div`` (the
model-averaging mode's ``-div``) the split comes from
``transforms_<split>_div.json``, which tools/pose_division.py writes, with
its ``division`` (a replica per image) and ``weights`` (one per division).

By default (``use_native=True``, as in the JAX package) the native loader
(nerf_tpu_torch/native) decodes, resizes and composites the whole split on
a thread pool.  ``use_native=False`` takes the plain path, the native
loader's oracle: Pillow when it imports, else ``utils/png.py`` and the
numpy resize below, which the native loader equals bit for bit.
``BlenderDataset.decoder`` says which path ran.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from nerf_tpu_torch import native
from nerf_tpu_torch.core.rays import fov_to_focal
from nerf_tpu_torch.utils.image import PRECISION_BITS, resize_taps
from nerf_tpu_torch.utils.png import read_png


def pillow():
    """Pillow's ``Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def natural_sorted(names):
    """Natural sort ('r_2.png' < 'r_10.png')."""
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]
    return sorted(names, key=key)


def _resample(x: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    """uint8 ``x`` resampled to ``n_out`` along ``axis`` (0 or 1) by
    ``resize_taps``: integer sums from half a unit up, shifted down and
    clamped to 8 bits, as Pillow's 8-bit passes (exact in any order)."""
    lo, weights = resize_taps(x.shape[axis], n_out)
    shape = (-1,) + (1,) * (x.ndim - 1 - axis)
    acc = 1 << (PRECISION_BITS - 1)
    for k in range(weights.shape[1]):
        idx = np.minimum(lo + k, x.shape[axis] - 1)
        acc = acc + weights[:, k].astype(np.int64).reshape(shape) * np.take(
            x, idx, axis=axis)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_numpy(img: np.ndarray, ratio: float) -> np.ndarray:
    """uint8 (H, W, C) resize by ``ratio`` as Pillow's ``Image.resize(...,
    BILINEAR)`` computes it, bit for bit: RGBA premultiplied to 8 bits
    first (``(t + (t >> 8)) >> 8`` of ``t = c a + 128``), the horizontal
    pass then the vertical one, each to 8 bits and skipped where the size
    is unchanged, then divided back by alpha (truncating); an unchanged
    size returns the image as it is."""
    h, w = img.shape[:2]
    new_h, new_w = int(h * ratio), int(w * ratio)
    if (new_h, new_w) == (h, w):
        return img
    x = img.astype(np.int64)
    rgba = x.shape[-1] == 4
    if rgba:
        t = x[..., :3] * x[..., 3:] + 128
        x[..., :3] = ((t >> 8) + t) >> 8
    x = x.astype(np.uint8)
    if new_w != w:
        x = _resample(x, 1, new_w)
    if new_h != h:
        x = _resample(x, 0, new_h)
    if rgba:
        y = x.astype(np.int64)
        a = y[..., 3:]
        keep = (a == 0) | (a == 255)
        y[..., :3] = np.where(keep, y[..., :3], np.minimum(
            255 * y[..., :3] // np.maximum(a, 1), 255))
        x = y.astype(np.uint8)
    return x


def _load_pillow(path: str, mode: str, ratio: float, image_mod) -> np.ndarray:
    img = image_mod.open(path).convert(mode)
    if ratio != 1.0:
        img = img.resize((int(img.width * ratio), int(img.height * ratio)),
                         image_mod.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _load_builtin(path: str, mode: str, ratio: float) -> np.ndarray:
    img = read_png(path)
    if mode == "RGB":
        img = img[..., :3]
    elif img.shape[-1] == 3:
        img = np.concatenate([img, np.full_like(img[..., :1], 255)], -1)
    if ratio != 1.0:
        img = _resize_numpy(img, ratio)
    return img.astype(np.float32) / 255.0


def _load_plain(paths, ratio: float, white_bkg: bool):
    """(images (N, H, W, 3) float32, decoder) of the plain path: Pillow, or
    the built-in decoder without it."""
    mode = "RGBA" if white_bkg else "RGB"
    pil = pillow()
    images = []
    for path in paths:
        arr = (_load_pillow(path, mode, ratio, pil) if pil is not None
               else _load_builtin(path, mode, ratio))
        if white_bkg:
            arr = arr[..., :3] * arr[..., 3:] + (1.0 - arr[..., 3:])
        images.append(arr[..., :3])
    decoder = ("Pillow" if pil is not None
               else "built-in zlib PNG decoder (Pillow not installed)")
    return np.stack(images).astype(np.float32), decoder


@dataclass
class BlenderDataset:
    """In-memory split: images (N, H, W, 3) f32 in [0, 1], poses (N, 3, 4)
    f32 with ``scene_scale`` applied to the translation."""

    images: np.ndarray
    poses: np.ndarray
    fov: object  # float or (fov_x, fov_y)
    decoder: str = ""
    division: Optional[list] = None
    weights: Optional[list] = None

    @property
    def image_hw(self):
        return self.images.shape[1], self.images.shape[2]

    def __len__(self):
        return self.images.shape[0]

    def focal(self, legacy_square: bool = False):
        return fov_to_focal(self.fov, self.image_hw, legacy_square=legacy_square)

    def pixel_pool(self) -> np.ndarray:
        """(N, H*W, 3) flattened pixels: the trainer keeps them on the device
        and samples its rays from them."""
        n, h, w, _ = self.images.shape
        return self.images.reshape(n, h * w, 3)

    @classmethod
    def load(cls, root: str, split: str = "test", img_scale: float = 1.0,
             scene_scale: float = 1.0, white_bkg: bool = False,
             use_div: bool = False,
             use_native: bool = True) -> "BlenderDataset":
        json_name = (f"transforms_{split}_div.json" if use_div
                     else f"transforms_{split}.json")
        json_path = os.path.join(root, json_name)
        if not os.path.exists(json_path):
            hint = (" (run tools/pose_division.py to create the _div "
                    "variant)" if use_div else "")
            raise FileNotFoundError(
                f"dataset not found: {json_path} - expected a Blender-"
                f"synthetic layout <dataset_root>/<dataset_name>/"
                f"transforms_{split}.json; check --dataset_root/--dataset_name"
                f"{hint}")
        with open(json_path) as f:
            meta = json.load(f)
        fov = meta["camera_angle_x"]
        if "camera_angle_y" in meta:
            fov = (fov, meta["camera_angle_y"])
        division = meta.get("division") if use_div else None
        weights = meta.get("weights") if use_div else None

        img_dir = os.path.join(root, split)
        names = natural_sorted(
            n for n in os.listdir(img_dir)
            if n.endswith("png") and "normal" not in n and "alpha" not in n)
        frames = meta["frames"]
        # pair images and poses even when the listing and the frames differ
        n = min(len(names), len(frames))
        names, frames = names[:n], frames[:n]
        if division is not None and len(division) != n:
            # a division that does not line up with the images would give
            # each replica other images than its own
            raise ValueError(
                f"{json_name} has {len(division)} division entries but the "
                f"dataset resolves to {n} image/pose pairs; re-run "
                f"tools/pose_division.py on the current dataset")

        paths = [os.path.join(img_dir, name) for name in names]
        if use_native:
            images = native.decode_images(paths, img_scale, white_bkg)
            decoder = "native"
        else:
            images, decoder = _load_plain(paths, img_scale, white_bkg)

        poses = []
        for frame in frames:
            tf = np.asarray(frame["transform_matrix"], np.float32)[:3, :]
            tf[:, 3] *= scene_scale
            poses.append(tf)
        return cls(images=images, poses=np.stack(poses).astype(np.float32),
                   fov=fov, decoder=decoder, division=division,
                   weights=weights)
