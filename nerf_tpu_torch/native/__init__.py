"""The port's native image loader and GIF LZW coder (native/dataio.cpp),
bound with ctypes.

``decode_images`` loads a split the way the plain loader does
(utils/png.py, then data/blender.py's ``_load_builtin`` and the white
composite), equal to it bit for bit: Python reads each file's chunks and
inflates its image data with ``zlib``; one C++ call per image undoes the
filters, expands the colour type, resizes as Pillow's BILINEAR resize does
(by ``utils.image.resize_taps``), composites and writes its slot of the
``(N, H, W, 3)`` float32 result.  A thread pool drives the images: ``zlib``
and the ctypes call release the GIL.  No libpng: the library needs only
the C++ compiler.

The library is built with ``g++`` at first use into
``build/nerf_tpu_torch/libdataio-<hash of source and flags>.so`` under the
repository root, written under a temporary name of its own and then renamed,
so that builds that race (test workers) each load a whole library.  A
failed build raises with the compiler's output and an undecodable file
raises naming the file: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from nerf_tpu_torch.utils.image import resize_taps
from nerf_tpu_torch.utils.png import inflate, parse_png

SOURCE = Path(__file__).resolve().parent / "dataio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
# dataio.cpp's Status codes
ERRORS = {1: "bad PNG filter type", 2: "palette index beyond the PLTE entries",
          3: "truncated PNG image data", 4: "unsupported PNG format"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_u8 = ctypes.POINTER(ctypes.c_uint8)
_i32 = ctypes.POINTER(ctypes.c_int32)
_f32 = ctypes.POINTER(ctypes.c_float)


def library_path(build_dir=None) -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir or BUILD_DIR) / f"libdataio-{digest}.so"


def build(build_dir=None) -> Path:
    """Compile the library unless it is there; returns its path.  Raises
    with the compiler's output when the build fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found (needed to build {SOURCE})")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{out.name}.", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` with its functions' signatures."""
    lib = ctypes.CDLL(str(path))
    lib.dataio_decode.argtypes = [
        _u8, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _u8, ctypes.c_int, _u8, ctypes.c_int, ctypes.c_int,
        _i32, _i32, ctypes.c_int, _i32, _i32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _f32]
    lib.dataio_decode.restype = ctypes.c_int
    lib.dataio_lzw_encode.argtypes = [_u8, ctypes.c_int64, _u8,
                                      ctypes.c_int64]
    lib.dataio_lzw_encode.restype = ctypes.c_int64
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _ptr(buf, kind):
    return ctypes.cast(ctypes.c_char_p(buf), kind) if isinstance(
        buf, bytes) else buf.ctypes.data_as(kind)


def _output_size(path: str, ratio: float) -> tuple:
    """(height, width) of the file's pixels after the resize by ``ratio``,
    from its header alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n" \
            or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                             "big")
    return (h, w) if ratio == 1.0 else (int(h * ratio), int(w * ratio))


def _decode_into(lib, path: str, out: np.ndarray, ratio: float,
                white_bkg: bool) -> None:
    """Decode the PNG at ``path`` into ``out`` (H, W, 3) float32."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        header = parse_png(data)
        raw = inflate(header)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    h, w = header.height, header.width
    size = (h, w) if ratio == 1.0 else (int(h * ratio), int(w * ratio))
    if size != out.shape[:2]:
        raise ValueError(f"{path}: {size[0]}x{size[1]} after the resize, "
                         f"the split's first image {out.shape[0]}x"
                         f"{out.shape[1]}")
    args = []             # each axis's taps, none where it keeps its size
    for n_in, n_out in ((h, size[0]), (w, size[1])):
        if n_in == n_out:
            args += [None, None, 0]
        else:
            lo, weights = resize_taps(n_in, n_out)
            args += [_ptr(lo, _i32), _ptr(weights, _i32), weights.shape[1]]
    rc = lib.dataio_decode(
        _ptr(raw, _u8), len(raw), w, h, header.depth, header.color_type,
        _ptr(header.palette, _u8), len(header.palette) // 3,
        _ptr(header.trns, _u8), len(header.trns), int(white_bkg), *args,
        size[0], size[1], out.ctypes.data_as(_f32))
    if rc != 0:
        raise ValueError(f"{path}: {ERRORS.get(rc, f'error {rc}')}")


def decode_images(paths: Sequence[str], ratio: float = 1.0,
                  white_bkg: bool = False,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """Decode PNGs to (N, H, W, 3) float32 in [0, 1]: resized by ``ratio``
    (all to the first one's size), alpha composited over white after the
    resize under ``white_bkg``, else dropped."""
    if not paths:
        raise ValueError("decode_images: no files")
    lib = load()
    out = np.empty((len(paths), *_output_size(paths[0], ratio), 3), np.float32)
    workers = min(len(paths), n_threads or os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for job in [pool.submit(_decode_into, lib, p, out[i], ratio, white_bkg)
                    for i, p in enumerate(paths)]:
            job.result()
    return out


def lzw_encode(indices: np.ndarray) -> bytes:
    """The GIF LZW code stream of uint8 ``indices`` (minimum code size 8),
    equal to ``utils.gif.lzw_encode_plain``'s bytes."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    cap = 2 * idx.size + 64       # 12-bit codes, one a pixel at the worst
    out = np.empty(cap, np.uint8)
    n = load().dataio_lzw_encode(idx.ctypes.data_as(_u8), idx.size,
                                 out.ctypes.data_as(_u8), cap)
    if n < 0:
        raise RuntimeError("dataio_lzw_encode: output buffer too small")
    return out[:n].tobytes()
