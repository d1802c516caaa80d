"""PNG encode and decode with ``zlib`` and ``struct`` alone.

The render path must not need Pillow, which the GPU machine may lack.  PNGs
are always written here, 8-bit RGB or RGBA with filter 0 unless the caller
asks for other filters, colour types or 16 bits.  The decoder is the plain
version of the native loader (nerf_tpu_torch/native): it reads
non-interlaced files of colour type 0 (grey), 2 (RGB), 3 (palette, with
``tRNS``), 4 (grey and alpha) and 6 (RGBA) at bit depth 8, and at 16 bits
keeps each sample's high byte, as libpng's ``png_set_strip_16`` does.  Rows
with the Average or Paeth filter are undone in pure Python, so it is slow
on large images; the dataset loader uses it only when asked
(``use_native=False``) and Pillow does not import.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}       # channels -> colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, filters=0) -> bytes:
    """The filtered scanlines of uint8 ``rows`` (h, row bytes): row y under
    filter ``filters`` (0-4), or ``filters[y % len(filters)]``."""
    x = rows.astype(np.int32)
    h = x.shape[0]
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    preds = (0, left, up, (left + up) // 2, _paeth(left, up, upleft))
    kinds = np.resize(np.asarray(filters, np.uint8).reshape(-1), h)
    out = np.empty((h, 1 + x.shape[1]), np.uint8)
    out[:, 0] = kinds
    for k in np.unique(kinds):
        sel = kinds == k
        out[sel, 1:] = (x[sel] - (preds[k][sel] if k else 0)) % 256
    return out.tobytes()


def encode_png(img: np.ndarray, filters=0,
               palette: Optional[np.ndarray] = None,
               trns: Optional[np.ndarray] = None) -> bytes:
    """PNG bytes of uint8 or uint16 (H, W, C), C = 1, 2, 3 or 4 (grey, grey
    and alpha, RGB, RGBA), with the rows under ``filters`` (``filter_rows``).
    With ``palette`` ((P, 3) uint8), ``img`` is uint8 (H, W) indices of a
    colour type 3 file and ``trns`` the alpha of the first entries; else
    ``trns`` is the transparent key's samples (1 or 3 values)."""
    img = np.asarray(img)
    if palette is not None:
        if img.dtype != np.uint8 or img.ndim != 2:
            raise ValueError(f"a palette image takes uint8 (H, W) indices, "
                             f"got {img.dtype} {img.shape}")
        img, ctype = img[..., None], 3
    elif (img.ndim != 3 or img.shape[-1] not in _COLOR_TYPES
          or img.dtype not in (np.uint8, np.uint16)):
        raise ValueError(f"encode_png takes uint8 or uint16 (H, W, 1-4), got "
                         f"{img.dtype} {img.shape}")
    else:
        ctype = _COLOR_TYPES[img.shape[-1]]
    h, w, c = img.shape
    depth = 8 * img.dtype.itemsize
    raw = img.astype(img.dtype.newbyteorder(">")).view(np.uint8)
    body = filter_rows(raw.reshape(h, w * c * img.dtype.itemsize),
                       c * img.dtype.itemsize, filters)
    out = _SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                   ctype, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        dt = np.uint8 if palette is not None else ">u2"
        out += _chunk(b"tRNS", np.asarray(trns).astype(dt).tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(body, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filters=0) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
    return path


@dataclass
class PngHeader:
    """A PNG's header and its ancillary chunks that decoding needs; ``idat``
    is the compressed image data."""

    width: int
    height: int
    depth: int
    color_type: int
    palette: bytes
    trns: bytes
    idat: bytes

    @property
    def bpp(self) -> int:
        """Bytes per pixel, the filters' stride."""
        return CHANNELS[self.color_type] * self.depth // 8

    @property
    def row_bytes(self) -> int:
        return self.width * self.bpp


def parse_png(data: bytes) -> PngHeader:
    """The chunks of PNG bytes; raises ``ValueError`` for a file that is not
    a PNG, is cut short or that the decoders do not take."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, palette, trns = 8, [], None, b"", b""
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"truncated PNG: chunk {tag!r} cut short")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG (Adam7) is not supported")
    if ctype not in CHANNELS or depth not in (8, 16) or (ctype == 3
                                                          and depth != 8):
        raise ValueError(f"unsupported PNG: colour type {ctype} at bit depth "
                         f"{depth} (colour types 0, 2, 3, 4, 6 at 8 bits, "
                         f"0, 2, 4, 6 at 16)")
    if ctype == 3 and not palette:
        raise ValueError("palette PNG without PLTE")
    return PngHeader(w, h, depth, ctype, palette, trns, b"".join(idat))


def inflate(header: PngHeader) -> bytes:
    """The filtered scanlines of the image data; raises ``ValueError`` when
    they are cut short."""
    try:
        raw = zlib.decompress(header.idat)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data ({e})") from None
    if len(raw) < header.height * (1 + header.row_bytes):
        raise ValueError(f"truncated PNG image data: {len(raw)} bytes for "
                         f"{header.height} rows of {1 + header.row_bytes}")
    return raw


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec section 9)."""
    if ftype == 0:
        return line
    if ftype == 1:    # Sub: running sum per byte of the pixel
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


def _expand(rows: np.ndarray, header: PngHeader) -> np.ndarray:
    """Unfiltered scanlines -> uint8 (H, W, 3), or (H, W, 4) when the file
    has alpha or a ``tRNS`` chunk."""
    h, w, ctype = header.height, header.width, header.color_type
    c = CHANNELS[ctype]
    if header.depth == 16:
        full = rows.reshape(h, w, c, 2).astype(np.uint16)
        full = full[..., 0] << 8 | full[..., 1]
        samples = (full >> 8).astype(np.uint8)
    else:
        full = samples = rows.reshape(h, w, c)
    if ctype == 3:
        pal = np.frombuffer(header.palette, np.uint8).reshape(-1, 3)
        idx = samples[..., 0]
        if idx.max() >= len(pal):
            raise ValueError(f"palette index {int(idx.max())} beyond the "
                             f"{len(pal)} PLTE entries")
        rgb = pal[idx]
        if not header.trns:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        trns = np.frombuffer(header.trns, np.uint8)[:256]
        alpha[:len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    grey = ctype in (0, 4)
    rgb = np.repeat(samples[..., :1], 3, -1) if grey else samples[..., :3]
    if ctype in (4, 6):
        return np.concatenate([rgb, samples[..., -1:]], -1)
    if not header.trns:
        return np.ascontiguousarray(rgb)
    key = np.frombuffer(header.trns, ">u2")[:c]
    hit = np.all(full[..., :c] == key, -1)
    alpha = np.where(hit, 0, 255).astype(np.uint8)[..., None]
    return np.concatenate([rgb, alpha], -1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3), or (H, W, 4) with alpha."""
    header = parse_png(data)
    raw = np.frombuffer(inflate(header), np.uint8)
    n = header.row_bytes
    raw = raw[:header.height * (1 + n)].reshape(header.height, 1 + n)
    out = np.empty((header.height, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for y in range(header.height):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev,
                                  header.bpp)
    return _expand(out, header)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
