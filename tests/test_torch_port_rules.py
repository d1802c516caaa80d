"""Rules of the nerf_tpu_torch package: no JAX inside, no quiet CPU runs,
no Pillow needed on the render and training paths."""

import os
import pkgutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one thread per worker)
import nerf_tpu_torch
from nerf_tpu_torch.cli.entry import ddp_main, ma_main, main
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.render import render_only
from nerf_tpu_torch.data import blender
from nerf_tpu_torch.train.pipeline import make_models, render_rays_eval
from nerf_tpu_torch.ops import build
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.step import compute_loss
from nerf_tpu_torch.utils.png import decode_png, encode_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Import every module of the package (native/ included) and
    chip_smoke.py in a fresh interpreter: neither jax, flax, msgpack,
    nerf_tpu nor Pillow may be loaded (the port reads nerf_tpu's checkpoints
    with its own reader, nerf_tpu_torch.utils.msgpack, and its images with
    its own decoders)."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        nerf_tpu_torch.__path__, "nerf_tpu_torch."))
    assert {"nerf_tpu_torch.ops.fused_mlp", "nerf_tpu_torch.ops.ref_fused",
            "nerf_tpu_torch.ops.launch",
            "nerf_tpu_torch.models.refnerf", "nerf_tpu_torch.native",
            "nerf_tpu_torch.utils.gif",
            "nerf_tpu_torch.utils.flops"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'nerf_tpu', 'PIL')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_every_cuda_source_is_built():
    """build() compiles every csrc/*.cu, and each library's kernels are
    registered under it."""
    from nerf_tpu_torch.ops.launch import SIGNATURES

    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))
    assert {lib for lib, _ in SIGNATURES.values()} == set(build.SOURCES)


def test_every_kernel_has_a_plain_version():
    """Each registered kernel's wrapper is exported by nerf_tpu_torch.ops
    beside its plain version (``<name>_plain``, or for a forward-only
    kernel ``<name without _fwd>_plain``), the yardstick the tests and
    chip_smoke.py hold it against."""
    from nerf_tpu_torch import ops
    from nerf_tpu_torch.ops.launch import SIGNATURES

    for name in SIGNATURES:
        assert callable(getattr(ops, name)), name
        assert any(hasattr(ops, p) for p in (
            f"{name}_plain", name.replace("_fwd", "") + "_plain")), name


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_never_run_quietly_on_cpu(no_card, tmp_path):
    cfg = PipelineConfig(n_coarse=8, n_fine=16, nerf_width=32, prop_width=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_models(cfg)
    models = make_models(cfg, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_rays_eval(models, torch.ones(4, 6), cfg)
    ref = cfg.replace(model="ref")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_rays_eval(make_models(ref, "cpu"), torch.ones(4, 6), ref)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_loss(make_models(ref, "cpu"), torch.ones(4, 6),
                     torch.ones(4, 3), ref)
    for flags in ([], ["-t", "--render_normal"]):
        args = get_parser().parse_args(["-r", "-e", "--dataset_root",
                                        str(tmp_path), *flags])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            render_only(args)
    # the distributed entries: training and -r, before any data or
    # process group
    for entry, argv in ((ddp_main, []), (ma_main, ["--ma_epoch", "1"])):
        for extra in ([], ["-r", "-e"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                entry(["--epochs", "1", "--dataset_root", str(tmp_path),
                       *argv, *extra])
    import torch.distributed as dist

    assert not dist.is_initialized()


@pytest.mark.parametrize("argv", [
    [], ["-r", "-e", "-s", "-w"], ["-r", "-b", "-s", "--opt_mode", "none"],
    ["-t", "--nerf_net_width", "64", "--pallas", "--use_ipe"],
    ["-m", "--eval_chunk", "512", "--legacy_focal", "--no_pallas"],
    ["-l", "--ckpt_dir", "ck", "--max_save", "5", "-b", "-s"]])
def test_flags_match_the_jax_package(argv):
    """Flag for flag: the same command line parses to the same arguments and
    the same pipeline configuration in both packages."""
    import dataclasses

    from nerf_tpu.cli import flags as jflags
    from nerf_tpu_torch.cli import flags

    args, jargs = flags.get_parser().parse_args(argv), \
        jflags.get_parser().parse_args(argv)
    assert vars(args) == vars(jargs)
    focal = (555.5, 555.5)
    cfg = flags.finalize_config(flags.config_from_args(args), focal)
    jcfg = jflags.finalize_config(jflags.config_from_args(jargs), focal)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("mode,argv", [
    ("ddp", []), ("ddp", ["--no_sync_prop", "-s", "--epochs", "3"]),
    ("ddp", ["--coordinator", "10.0.0.1:1234", "--num_processes", "4",
             "--process_id", "2", "-r", "-e"]),
    ("ma", ["--ma_epoch", "2"]),
    ("ma", ["--ma_epoch", "1", "--ma_method", "p2p", "-div",
            "--allow_imbalanced", "--num_replicas", "4", "-t"]),
    ("ma", ["--ma_epoch", "3", "--ma_method", "broadcast", "--coordinator",
            "h:1", "--num_processes", "2", "--process_id", "0"])])
def test_distributed_flags_match_the_jax_package(monkeypatch, mode, argv):
    """ddp_main's and ma_main's command lines parse to the same arguments in
    both packages (nerf_tpu's parsers are read through its entries, with
    its trainer, render and rendezvous stubbed)."""
    import nerf_tpu.cli as jcli
    import nerf_tpu.parallel as jparallel
    from nerf_tpu.cli import entry as jentry
    from nerf_tpu_torch.cli.entry import ddp_parser, ma_parser

    seen = {}

    class Captured(Exception):
        pass

    def capture(args, *a, **kw):
        seen["args"] = args
        raise Captured

    monkeypatch.setattr(jcli, "Trainer", capture)
    monkeypatch.setattr(jcli, "render_only", capture)
    monkeypatch.setattr(jparallel, "initialize_distributed",
                        lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    with pytest.raises(Captured):
        (jentry.ddp_main if mode == "ddp" else jentry.ma_main)()
    parser = ddp_parser() if mode == "ddp" else ma_parser()
    assert vars(parser.parse_args(argv)) == vars(seen["args"])


def test_entry_without_render_exits_nonzero(no_card, tmp_path):
    """Without -r the entry trains, on the card: with none it raises (the
    process exits non-zero) before it reads any data, rather than train on
    the CPU."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--epochs", "1", "--dataset_root", str(tmp_path)])


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """PNG bytes of uint8 (H, W, C) with every row under filter ``ftype``."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        cur = x[y]
        prev = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    ctype = {3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("channels", [3, 4])
def test_png_decoder_undoes_every_filter(ftype, channels):
    img = np.random.default_rng(ftype).integers(
        0, 256, (9, 7, channels), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftype)), img)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_builtin_loader_matches_pillow(tmp_path, monkeypatch, scale):
    import json

    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "test")
    for i in range(2):
        write_png(str(tmp_path / "test" / f"r_{i}.png"),
                  rng.integers(0, 256, (16, 20, 4), dtype=np.uint8))
    frames = [{"transform_matrix": np.eye(4).tolist()}] * 2
    (tmp_path / "transforms_test.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    with_pil = blender.BlenderDataset.load(str(tmp_path), "test", scale,
                                           white_bkg=True, use_native=False)
    monkeypatch.setattr(blender, "pillow", lambda: None)
    builtin = blender.BlenderDataset.load(str(tmp_path), "test", scale,
                                          white_bkg=True, use_native=False)
    assert with_pil.decoder == "Pillow" and "built-in" in builtin.decoder
    assert builtin.images.shape == with_pil.images.shape
    # Pillow resamples in fixed point with a uint8 round per pass
    tol = 0 if scale == 1.0 else 3.0 / 255
    np.testing.assert_allclose(builtin.images, with_pil.images, rtol=0,
                               atol=tol)
