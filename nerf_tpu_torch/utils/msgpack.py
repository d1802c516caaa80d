"""A msgpack reader for ``nerf_tpu``'s checkpoints: the counterpart of
``flax.serialization.msgpack_restore`` (flax 0.12.3), on bytes, with numpy.

``nerf_tpu`` writes every checkpoint (``model/<name>.ckpt`` and the rotating
``<name>_chkpt_<slot>.ckpt``) with flax's msgpack codec: maps with str keys,
Python ints for the counters, and each array as msgpack ext type 1, whose
payload is itself msgpack: ``(shape, dtype name, C-order bytes)``.  A numpy
scalar is ext type 3 with the same payload.  This module decodes every format
byte that writer emits (nil, bool, ints, floats, str, bin, array and map in
their fix/8/16/32 forms; all lengths and ints big-endian) and gives the same
tree: dicts, lists, Python scalars, read-only numpy arrays and numpy
scalars.  Ext type 2 (a complex number) and flax's chunked form of an array
over 1 GiB are refused by name: no NeRF checkpoint holds them.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"

# format byte -> struct code of its fixed-size value
_SCALARS = {0xca: ">f", 0xcb: ">d",
            0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# format byte -> (kind, struct code of its length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
# fixext format byte -> payload size
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class MsgpackError(ValueError):
    """Bytes that are not a msgpack document this reader accepts."""


class _Reader:
    """One pass over ``data``; ``raw`` keeps str values as bytes (the inner
    payload of an array, as flax reads it)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, code: str):
        return struct.unpack(code, self.take(struct.calcsize(code)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.read_map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.read_str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.read_ext(self.unpack(">b"), _FIXEXT[b])
        if b not in _SIZED:
            raise MsgpackError(f"format byte 0x{b:02x} at offset "
                               f"{self.pos - 1} is not msgpack")
        kind, code = _SIZED[b]
        n = self.unpack(code)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.read_str(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.read_map(n)
        return self.read_ext(self.unpack(">b"), n)

    def read_str(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(f"map key {key!r} is not a str")
            out[key] = self.read()
        if CHUNKED_KEY in out:
            raise MsgpackError(
                "flax's chunked large-array form (__msgpack_chunked_array__) "
                "is not supported: a NeRF checkpoint holds no array over "
                "1 GiB")
        return out

    def read_ext(self, code: int, n: int):
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            raise MsgpackError("ext type 2 (a complex number) is not "
                               "supported: a NeRF checkpoint holds none")
        raise MsgpackError(f"unknown msgpack ext type {code}")


def _ndarray(payload) -> np.ndarray:
    """An ext type 1 or 3 payload -> a read-only numpy array."""
    inner = _Reader(payload, raw=True)
    tpl = inner.read()
    if inner.pos != len(inner.data) or not (
            isinstance(tpl, list) and len(tpl) == 3):
        raise MsgpackError("an array payload is not (shape, dtype, bytes)")
    shape, name, buf = tpl
    try:
        dtype = np.dtype(name.decode("ascii"))
    except TypeError as e:
        raise MsgpackError(f"array dtype {name!r} is not a numpy dtype") \
            from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def restore(data: bytes):
    """The tree of one msgpack document, as ``flax.serialization
    .msgpack_restore`` gives it."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after "
                           f"the document")
    return out
