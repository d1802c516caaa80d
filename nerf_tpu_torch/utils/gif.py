"""Animated GIF writer without Pillow, for render-only's orbit
(nerf_tpu/cli/render.py:121-130 writes it with Pillow).

``write_gif`` writes a GIF89a: the NETSCAPE2.0 loop block, then for each
frame a graphic-control block with its delay, an image descriptor with a
256-colour local palette from ``quantize`` (median cut over the frame's
colours, deterministic) and the frame's indices LZW-coded with a clear code
whenever the code table fills.  The coder runs in the native library
(``native.lzw_encode``); ``lzw_encode_plain`` is its plain version, equal
byte for byte.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from nerf_tpu_torch import native

CLEAR, END, FIRST, MAX_CODES = 256, 257, 258, 4096


def lzw_encode_plain(indices: np.ndarray) -> bytes:
    """GIF LZW of uint8 ``indices`` at minimum code size 8: a clear code
    first, each code as wide as the decoder's table then needs, a clear code
    when the table holds 4096 codes, the end code last, packed least
    significant bit first."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1).tobytes()
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width, nxt, table = 9, FIRST, {}
    emit(CLEAR, width)
    if idx:
        prefix = idx[0]
        for c in idx[1:]:
            code = table.get(prefix << 8 | c)
            if code is not None:
                prefix = code
                continue
            emit(prefix, width)
            table[prefix << 8 | c] = nxt
            nxt += 1
            if nxt - 1 == 1 << width:
                width += 1
            if nxt == MAX_CODES:
                emit(CLEAR, width)
                table.clear()
                nxt, width = FIRST, 9
            prefix = c
        emit(prefix, width)
    emit(END, min(12, max(9, nxt.bit_length())))
    if nbits:
        emit(0, 8 - nbits)
    return bytes(out)


def quantize(frame: np.ndarray, colors: int = 256):
    """(palette (colors, 3) uint8, indices (H, W) uint8) of uint8 (H, W, 3)
    ``frame`` by median cut: the box of colours with the largest
    pixel-weighted squared error is split at the pixel median of its widest
    channel until there are ``colors`` boxes (or every box holds one
    colour); each box's colour is its pixels' mean."""
    flat = frame.reshape(-1, 3).astype(np.int64)
    keys, inverse, counts = np.unique(
        flat[:, 0] << 16 | flat[:, 1] << 8 | flat[:, 2], return_inverse=True,
        return_counts=True)
    cols = np.stack([keys >> 16, keys >> 8 & 0xFF, keys & 0xFF], -1)

    def sse(box):
        c, w = cols[box], counts[box, None]
        mean = (c * w).sum(0) / w.sum()
        return float((w * (c - mean) ** 2).sum())

    boxes = [np.arange(len(keys))]
    scores = [sse(boxes[0])]
    while len(boxes) < colors:
        i = int(np.argmax(scores))
        if scores[i] <= 0.0:
            break
        box = boxes[i]
        c = cols[box]
        ch = int(np.argmax(c.max(0) - c.min(0)))
        box = box[np.argsort(c[:, ch], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2) + 1, 1,
                          len(box) - 1))
        boxes[i], new = box[:cut], box[cut:]
        boxes.append(new)
        scores[i] = sse(boxes[i])
        scores.append(sse(new))
    palette = np.zeros((colors, 3), np.uint8)
    box_of = np.empty(len(keys), np.int64)
    for j, box in enumerate(boxes):
        w = counts[box, None]
        palette[j] = np.rint((cols[box] * w).sum(0) / w.sum())
        box_of[box] = j
    return palette, box_of[inverse.reshape(-1)].astype(
        np.uint8).reshape(frame.shape[:2])


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], duration_ms: int = 50,
               loop: int = 0) -> bytes:
    """GIF89a bytes of uint8 (H, W, 3) ``frames`` (one size), each shown
    ``duration_ms`` (in hundredths of a second), looped ``loop`` times (0:
    forever)."""
    h, w = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
           + b"\x00"]
    delay = int(round(duration_ms / 10))
    for frame in frames:
        frame = np.asarray(frame, np.uint8)
        if frame.shape != (h, w, 3):
            raise ValueError(f"GIF frames must be uint8 ({h}, {w}, 3), got "
                             f"{frame.shape}")
        palette, indices = quantize(frame)
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                palette.tobytes(), b"\x08",
                _sub_blocks(native.lzw_encode(indices))]
    return b"".join(out) + b"\x3b"


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int = 50,
              loop: int = 0) -> str:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, duration_ms, loop))
    return path
