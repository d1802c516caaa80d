"""The port's native image loader (nerf_tpu_torch/native) against its plain
version, against nerf_tpu's native loader and against nerf_tpu's Pillow
path.

- The plain version is ``BlenderDataset.load(use_native=False)`` with Pillow
  mocked away: utils/png.py and the numpy resize.  The native loader does
  every arithmetic step of it, so it must agree within 1e-6 (it does bit
  for bit) over the five filters, the colour types, 16 bits, ``img_scale``
  1, 0.5, 0.25 and 2 and ``white_bkg``.
- Both compute Pillow's BILINEAR resize (premultiplied RGBA, 8-bit passes
  in fixed point): where Pillow decodes a file as the port does (8 bits),
  the port's Pillow path equals the native loader bit for bit too.
- nerf_tpu's native loader (libpng) decodes the same files within 1e-6 at
  ``img_scale`` 1.  When it resizes, it resamples in float and keeps the
  floats: it stays within 3 / 255 of Pillow's passes, the JAX package's own
  limit between its native and Pillow paths (tests/test_native.py), and
  so does nerf_tpu's Pillow path.
"""

import json
import os
import re
import struct
import subprocess
import threading
import zlib

import numpy as np
import pytest

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu import native as jnative
from nerf_tpu.data.blender import BlenderDataset as JaxBlenderDataset
from nerf_tpu_torch import native
from nerf_tpu_torch.data import blender
from nerf_tpu_torch.utils.png import encode_png

HW = (23, 18)
FILTERS = ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0])
SCALES = (1.0, 0.5, 0.25, 2.0)


def _image(kind: str, rng: np.random.Generator):
    """(array, encode_png keywords) of one test image of ``kind``: smooth
    colours with noise, and where there is alpha a disc that is opaque,
    transparent outside and partly transparent at its rim."""
    h, w = HW
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    rgb = 0.5 + 0.5 * np.sin(7 * xx[..., None] + 5 * yy[..., None]
                             + rng.uniform(0, 6, 3))
    rgb = np.clip(rgb + rng.normal(0, 0.05, rgb.shape), 0, 1)
    alpha = np.clip(3.0 - 12.0 * np.hypot(xx - 0.45, yy - 0.55), 0, 1)
    depth16 = kind.endswith("16")
    scale = 65535 if depth16 else 255
    dtype = np.uint16 if depth16 else np.uint8
    grey = rgb.mean(-1, keepdims=True)
    planes = {"rgb": [rgb], "rgba": [rgb, alpha[..., None]], "grey": [grey],
              "greya": [grey, alpha[..., None]]}
    base = kind.removesuffix("16")
    if base == "palette" or base == "palette_trns":
        pal = (rng.uniform(size=(40, 3)) * 255).astype(np.uint8)
        idx = rng.integers(0, 40, (h, w)).astype(np.uint8)
        trns = (rng.uniform(size=30) * 255).astype(np.uint8)
        return idx, dict(palette=pal,
                         trns=trns if base == "palette_trns" else None)
    if base in ("rgb_key", "grey_key"):
        c = 3 if base == "rgb_key" else 1
        img = rng.integers(0, 3, (h, w, c)).astype(dtype) * (scale // 2)
        return img, dict(trns=np.full(c, scale // 2))
    img = np.concatenate(planes[base], -1) * scale + 0.5
    return img.astype(dtype), {}


KINDS = ("rgb", "rgba", "grey", "greya", "palette", "palette_trns", "rgb_key",
         "grey_key", "rgb16", "rgba16", "grey16", "greya16", "grey_key16")


def _write_split(root, kind: str, seed: int = 0, n=len(FILTERS)):
    """A Blender-layout test split of ``n`` images of ``kind``, image i's
    rows under FILTERS[i]."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    paths = []
    for i in range(n):
        img, kw = _image(kind, rng)
        path = os.path.join(root, "test", f"r_{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(img, FILTERS[i % len(FILTERS)], **kw))
        paths.append(path)
    frames = [{"transform_matrix": np.eye(4).tolist()}] * n
    with open(os.path.join(root, "transforms_test.json"), "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return paths


def _plain(root, scale, white_bkg, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(blender, "pillow", lambda: None)
        return blender.BlenderDataset.load(str(root), "test", scale,
                                           white_bkg=white_bkg,
                                           use_native=False)


@pytest.mark.parametrize("white_bkg", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("kind", KINDS)
def test_native_equals_plain_loader(tmp_path, monkeypatch, kind, scale,
                                   white_bkg):
    _write_split(tmp_path, kind)
    nat = blender.BlenderDataset.load(str(tmp_path), "test", scale,
                                      white_bkg=white_bkg)
    plain = _plain(tmp_path, scale, white_bkg, monkeypatch)
    assert nat.decoder == "native" and "built-in" in plain.decoder
    assert nat.images.dtype == np.float32
    assert nat.images.shape == plain.images.shape == (
        len(FILTERS), int(HW[0] * scale), int(HW[1] * scale), 3)
    np.testing.assert_allclose(nat.images, plain.images, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(nat.poses, plain.poses)


@pytest.mark.parametrize("white_bkg", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("kind", KINDS[:8])
def test_native_equals_pillow_path(tmp_path, kind, scale, white_bkg):
    _write_split(tmp_path, kind)
    nat = blender.BlenderDataset.load(str(tmp_path), "test", scale,
                                      white_bkg=white_bkg)
    pil = blender.BlenderDataset.load(str(tmp_path), "test", scale,
                                      white_bkg=white_bkg, use_native=False)
    assert pil.decoder == "Pillow"
    np.testing.assert_array_equal(nat.images, pil.images)


@pytest.fixture(scope="module")
def jax_native_build(tmp_path_factory):
    """nerf_tpu's native/dataio.cpp (read, not changed) built by this test
    process into a path of its own, as nerf_tpu.native builds it; None where
    it does not build (no g++ or libpng)."""
    out = tmp_path_factory.mktemp("jax_native") / "libdataio.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           os.path.abspath(jnative._SRC), "-o", str(out), "-lpng", "-lz",
           "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return None
    return str(out)


@pytest.fixture
def jax_native(jax_native_build, monkeypatch):
    """nerf_tpu's native loader on this process's own build of it, or a skip
    where it does not build.  The JAX package keeps one library path for
    every process, and a worker that lost a race to build it at collection
    keeps its failure for the rest of its run: the comparisons below load
    their own build instead, so that race cannot skip them."""
    if jax_native_build is None:
        pytest.skip("nerf_tpu's native loader (libpng) does not build here")
    monkeypatch.setattr(jnative, "_LIB", jax_native_build)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)
    if not jnative.available():
        pytest.skip("nerf_tpu's native loader does not load here")
    return jnative


@pytest.mark.parametrize("white_bkg", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_native_equals_jax_native_at_full_size(tmp_path, jax_native, kind,
                                              white_bkg):
    paths = _write_split(tmp_path, kind)
    want = jnative.decode_images(paths, 1.0, white_bkg)
    got = native.decode_images(paths, 1.0, white_bkg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", SCALES[1:])
@pytest.mark.parametrize("kind", ["rgb", "grey16"])
def test_native_resize_within_3_of_255_of_jax_native(tmp_path, jax_native,
                                                     kind, scale):
    paths = _write_split(tmp_path, kind)
    want = jnative.decode_images(paths, scale)
    got = native.decode_images(paths, scale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=3 / 255)


@pytest.mark.parametrize("white_bkg", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("kind", ["rgb", "rgba"])
def test_native_within_3_of_255_of_jax_pillow_path(tmp_path, kind, scale,
                                                   white_bkg):
    _write_split(tmp_path, kind)
    want = JaxBlenderDataset.load(str(tmp_path), "test", scale,
                                  white_bkg=white_bkg, use_native=False)
    got = blender.BlenderDataset.load(str(tmp_path), "test", scale,
                                      white_bkg=white_bkg)
    np.testing.assert_allclose(got.images, want.images, rtol=0,
                               atol=3 / 255)


def _raises_naming(path, fn):
    with pytest.raises((ValueError, OSError), match=re.escape(str(path))):
        fn()


def test_bad_files_raise_naming_the_file(tmp_path):
    paths = _write_split(tmp_path, "rgba", n=3)
    good = open(paths[1], "rb").read()
    load = lambda: native.decode_images(paths)  # noqa: E731
    os.remove(paths[2])
    _raises_naming(paths[2], load)
    with open(paths[2], "wb") as f:       # cut inside the image data
        f.write(good[:len(good) // 2])
    _raises_naming(paths[2], load)
    # interlaced: the header's last byte
    ihdr = bytearray(good[16:29])
    ihdr[12] = 1
    with open(paths[2], "wb") as f:
        f.write(good[:8] + _chunk(b"IHDR", bytes(ihdr)) + good[33:])
    with pytest.raises(ValueError, match=re.escape(paths[2]) + ".*interlaced"):
        load()
    # a filter type beyond 4 in the first row
    rows = np.zeros((HW[0], 1 + HW[1] * 4), np.uint8)
    rows[0, 0] = 7
    with open(paths[2], "wb") as f:
        f.write(good[:33] + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=re.escape(paths[2])
                       + ".*filter type"):
        load()
    # another size than the split's first image
    with open(paths[2], "wb") as f:
        f.write(encode_png(np.zeros((4, 4, 4), np.uint8)))
    with pytest.raises(ValueError, match=re.escape(paths[2]) + ".*4x4"):
        load()


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Two builds into one empty directory at once, as two test workers
    may be: each compiles under a name of its own and renames it into
    place, so both load a library that works."""
    build_dir = tmp_path / "build"
    barrier = threading.Barrier(2)
    results, errors = [], []

    def build_and_load():
        try:
            barrier.wait()
            lib = native.bind(native.build(build_dir))
            idx = np.arange(5000, dtype=np.uint8)
            out = np.empty(20000, np.uint8)
            n = lib.dataio_lzw_encode(idx.ctypes.data_as(native._u8),
                                      idx.size, out.ctypes.data_as(
                                          native._u8), out.size)
            results.append(out[:n].tobytes())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build_and_load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert len(results) == 2 and results[0] == results[1] == \
        native.lzw_encode(np.arange(5000, dtype=np.uint8))
    assert [p.name for p in build_dir.iterdir()] == [
        native.library_path(build_dir).name]


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "dataio.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.build(tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())
