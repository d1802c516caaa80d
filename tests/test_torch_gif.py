"""The orbit GIF without Pillow (nerf_tpu_torch/utils/gif.py): Pillow
decodes it to exactly the palette-mapped frames with their delay and loop;
the median-cut palette loses at most 1.25x what Pillow's own GIF of the same
frames loses; the native LZW coder equals the plain one byte for byte; and
``-r`` through the entry writes the 120-frame orbit with Pillow made
unimportable."""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu_torch import native
from nerf_tpu_torch.cli.entry import main
from nerf_tpu_torch.utils import gif
from nerf_tpu_torch.utils.png import read_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _frames(n: int, hw=(48, 40), seed: int = 0):
    """Render-like uint8 frames: smooth colour fields that move from frame
    to frame, a dark disc, and a little noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for i in range(n):
        phase = rng.uniform(0, 2 * np.pi, 3)
        rgb = 0.5 + 0.5 * np.sin(6 * xx[..., None] + 4 * yy[..., None]
                                 + phase + 0.3 * i)
        disc = np.hypot(xx - 0.3 - 0.02 * i, yy - 0.5) < 0.2
        rgb[disc] *= 0.3
        rgb += rng.normal(0, 0.02, rgb.shape)
        out.append((np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8))
    return out


def _decode(data: bytes):
    im = Image.open(io.BytesIO(data))
    frames, delays = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        delays.append(im.info["duration"])
    return frames, delays, im.info.get("loop")


@pytest.mark.parametrize("hw", [(48, 40), (1, 1), (7, 300)])
def test_pillow_decodes_the_palette_mapped_frames(hw):
    frames = _frames(5, hw)
    got, delays, loop = _decode(gif.encode_gif(frames, duration_ms=50,
                                               loop=0))
    assert len(got) == 5 and delays == [50] * 5 and loop == 0
    for frame, back in zip(frames, got):
        palette, indices = gif.quantize(frame)
        np.testing.assert_array_equal(back, palette[indices])


def test_palette_error_at_most_1_25x_pillows():
    frames = _frames(6)
    ours, _, _ = _decode(gif.encode_gif(frames))
    buf = io.BytesIO()
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(buf, format="GIF", save_all=True, append_images=imgs[1:],
                 duration=50, loop=0)
    theirs, _, _ = _decode(buf.getvalue())
    assert len(theirs) == len(frames)

    def err(decoded):
        return np.mean([np.abs(d.astype(np.int64) - f).mean()
                        for d, f in zip(decoded, frames)])

    assert err(ours) <= 1.25 * err(theirs)


def test_few_colours_are_exact():
    """A frame of at most 256 colours keeps every one."""
    rng = np.random.default_rng(1)
    colours = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    frame = colours[rng.integers(0, 200, (30, 30))]
    (back,), _, _ = _decode(gif.encode_gif([frame]))
    np.testing.assert_array_equal(back, frame)


@pytest.mark.parametrize("n,k", [(0, 256), (1, 256), (2, 2), (1000, 3),
                                 (60_000, 256), (200_000, 16),
                                 (300_000, 2)])
def test_native_lzw_equals_plain(n, k):
    """Random index streams; the long ones pass the clear code several
    times (a clear every 3,838 codes)."""
    idx = np.random.default_rng(n + k).integers(0, k, n).astype(np.uint8)
    plain = gif.lzw_encode_plain(idx)
    assert native.lzw_encode(idx) == plain
    if n >= 60_000 and k == 256:
        assert len(plain) * 8 > 3 * 3838 * 9


def test_render_orbit_writes_the_gif_without_pillow(tmp_path, monkeypatch,
                                                   capsys):
    """Train one epoch on the fixture, then ``-r``: 120 orbit frames into
    output/sphere/orbit.gif, 50 ms each, looped, with ``PIL`` unimportable
    while the port runs."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_root", FIXTURES, "--dataset_name", "lego_mini",
            "--img_scale", "1.0", "-w", "--sample_ray_num", "32",
            "--nerf_net_width", "32", "--prop_net_width", "32",
            "--coarse_sample_pnum", "8", "--fine_sample_pnum", "16",
            "--eval_chunk", "256", "--output_dir", str(tmp_path / "out"),
            "--log_dir", str(tmp_path / "logs"), "--no_tensorboard"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        m.setitem(sys.modules, "PIL.Image", None)
        with pytest.raises(ImportError):
            import PIL.Image  # noqa: F401
        assert main([*argv, "--epochs", "1"], device="cpu") == 0
        assert main([*argv, "-r"], device="cpu") == 0
    out = capsys.readouterr().out
    path = tmp_path / "out" / "sphere" / "orbit.gif"
    assert f"Orbit animation -> {path}" in out
    assert "test images with native" in out
    frames, delays, loop = _decode(path.read_bytes())
    assert len(frames) == 120 and delays == [50] * 120 and loop == 0
    assert frames[0].shape == (16, 16, 3)
    # each GIF frame is its PNG's rgb panel under the frame's palette
    for i in (0, 59, 119):
        png = read_png(str(path.parent / f"result_{i:03d}.png"))
        palette, indices = gif.quantize(png[:, :16, :3])
        np.testing.assert_array_equal(frames[i], palette[indices])
