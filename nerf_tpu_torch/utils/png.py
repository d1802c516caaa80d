"""8-bit PNG encode and decode with ``zlib`` and ``struct`` alone.

The render path must not need Pillow, which the GPU machine may lack.  PNGs
are always written here.  The decoder reads non-interlaced 8-bit RGB and
RGBA files (the Blender-synthetic layout); the dataset loader uses it when
Pillow does not import.  Rows with the Average or Paeth filter are undone in
pure Python, so this decoder is slow on large images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}       # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3 or 4) -> PNG bytes (filter type 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"encode_png takes uint8 (H, W, 3 or 4), got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec section 9)."""
    if ftype == 0:
        return line
    if ftype == 1:    # Sub: running sum per channel
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:    # Up
        return ((line.astype(np.int32) + prev) % 256).astype(np.uint8)
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            pred = (a + b) >> 1
        else:           # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3 or 4)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color type "
                         f"{ctype}, interlace {interlace} (8-bit RGB or RGBA, "
                         f"non-interlaced only)")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, c)
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
