#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  - a CUDA device must be present; the card's name and power limit
  2. build   - nvcc builds every kernel of nerf_tpu_torch/ops/csrc
  3. kernels - each kernel against its plain PyTorch version, bf16 and f32,
               at the shapes of one default 4096-ray chunk, with timings
  4. path    - `python -m nerf_tpu_torch -r -e -s -w` on a two-view 800x800
               Blender-layout test split with seeded random weights (full
               width vanilla model), counting kernel launches; then one f32
               frame through the kernels against the plain nn.Module path,
               and one warm bf16 frame timed and traced with torch.profiler
  5. the kernels line, then the last line {"ok": true, "device": {...}}

Imports nothing of JAX or nerf_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nerf_tpu_torch import ops
from nerf_tpu_torch.cli.entry import main as entry_main
from nerf_tpu_torch.core.rays import fov_to_focal, pose_spherical
from nerf_tpu_torch.ops import build
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.utils.checkpoint import save_models
from nerf_tpu_torch.utils.png import write_png

LEGO_FOV = 0.6911112070083618       # lego's camera_angle_x
CHUNK = 4096                        # --eval_chunk default
N_COARSE, N_FINE = 64, 128          # sample defaults
N_FRAMES = 2
HBM_BYTES_PER_S = 3.35e12           # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the card.  bf16: both round every layer to
# bf16, but the kernel sums in another order, so a value near a rounding
# boundary can land one bf16 ulp (2^-8 relative) apart and carry on.  f32:
# summation order alone over K <= 319 terms.
TOLS = {torch.bfloat16: dict(rtol=2e-2, atol=1e-2),
        torch.float32: dict(rtol=1e-4, atol=1e-5)}
# one f32 frame, kernels vs the nn.Module path: per-point outputs agree to
# ~1e-5 relative; the composite over 128 samples and the inverse-CDF depths
# pass it on without amplifying it by more than a few times.
FRAME_ATOL = 1e-3

KERNELS = {
    "prop_mlp_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:478"),
    "vanilla_mlp_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:128"),
}


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_weights(shapes, gen, dtype, bias_std=0.5):
    """(in, out) matrices N(0, 2 / in) in ``dtype`` and (1, W) f32 biases."""
    ws = []
    for shape, is_bias in shapes:
        t = torch.randn(shape, generator=gen, device="cuda")
        if is_bias:
            ws.append((t * bias_std).contiguous())
        else:
            ws.append((t * math.sqrt(2.0 / shape[0])).to(dtype).contiguous())
    return ws


def prop_shapes(dx=63, h=256):
    mats = [(dx, h), (h, h), (h, h), (h, h), (h, 1)]
    out = []
    for m in mats:
        out += [(m, False), ((1, m[1]), True)]
    return out


def vanilla_shapes(dx=63, dd=27, h=256, bn=256, r=128):
    m = [(dx, h), None, (h, h), None, (h, h), None, (h, h), None,
         (dx, h), (h, h), None, (h, h), None, (h, bn), None, (bn, 1), None,
         (bn, bn), None, (bn, r), (dd, r), None, (r, 3), None]
    out = []
    for i, s in enumerate(m):
        if s is None:   # a bias follows its (last) matrix
            prev = next(x for x in reversed(m[:i]) if x is not None)
            out.append(((1, prev[1]), True))
        else:
            out.append((s, False))
    return out


def macs_per_point(shapes):
    return sum(s[0] * s[1] for s, is_bias in shapes if not is_bias)


def check_kernel(name, dtype, gen):
    if name == "prop_mlp_fwd":
        shapes, n = prop_shapes(), CHUNK * N_COARSE
        ws = random_weights(shapes, gen, dtype)
        x = torch.rand((n, 63), generator=gen, device="cuda").mul_(2).sub_(1)
        args = (ws, x.to(dtype))
        kernel, plain = ops.prop_mlp_fwd, ops.prop_mlp_plain
        in_bytes = x.numel() * x.to(dtype).element_size()
        out_bytes = n * 4
    else:
        shapes, n = vanilla_shapes(), CHUNK * N_FINE
        ws = random_weights(shapes, gen, dtype)
        x = torch.rand((n, 63), generator=gen, device="cuda").mul_(2).sub_(1)
        d = torch.rand((n, 27), generator=gen, device="cuda").mul_(2).sub_(1)
        args = (ws, x.to(dtype), d.to(dtype))
        kernel, plain = ops.vanilla_mlp_fwd, ops.vanilla_mlp_plain
        elem = torch.empty((), dtype=dtype).element_size()
        in_bytes = n * (63 + 27) * elem
        out_bytes = n * 4 * 4
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            fail(f"{name} {dtype}: non-finite output")
        if not torch.allclose(g, w, **TOLS[dtype]):
            fail(f"{name} {dtype}: max abs err {err} beyond {TOLS[dtype]}")
    # share of points whose density/sigma passes the ReLU downstream
    active = float((want[-1] > 0).float().mean())
    if not 0.0 < active < 1.0:
        fail(f"{name} {dtype}: degenerate test inputs (positive share "
             f"{active})")
    w_bytes = sum(w.numel() * w.element_size() for w in ws)
    flops = 2.0 * macs_per_point(shapes) * n
    bytes_moved = in_bytes + w_bytes + out_bytes
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
    ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 20)
    return dict(name=name, dtype=str(dtype).replace("torch.", ""), n=n,
                max_abs_err=err, tol=TOLS[dtype], positive_share=active,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S
                > flops / PEAK_FLOPS[dtype] else "operations",
                tflops=flops / (ms * 1e-3) / 1e12)


# ---------------------------------------------------------------------------
# phase 4: the render path
# ---------------------------------------------------------------------------

def write_test_split(root: str, gen: np.random.Generator):
    """Two 800x800 RGBA views in the Blender layout, lego's field of view."""
    scene = os.path.join(root, "data", "lego")
    os.makedirs(os.path.join(scene, "test"))
    yy, xx = np.mgrid[0:800, 0:800] / 800.0
    frames = []
    for i in range(N_FRAMES):
        pose = pose_spherical(-180.0 + 90.0 * i, -30.0, 4.0)
        frames.append({"file_path": f"./test/r_{i}",
                       "transform_matrix": pose.tolist()})
        phase = gen.uniform(0, 2 * np.pi, 3)
        rgb = 0.5 + 0.5 * np.sin(6 * xx[..., None] + 4 * yy[..., None] + phase)
        alpha = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.1)[..., None]
        img = np.concatenate([rgb, alpha], -1) * 255.0 + 0.5
        write_png(os.path.join(scene, "test", f"r_{i}.png"),
                  img.astype(np.uint8))
    with open(os.path.join(scene, "transforms_test.json"), "w") as f:
        json.dump({"camera_angle_x": LEGO_FOV, "frames": frames}, f)


def seeded_models(cfg: PipelineConfig, seed: int):
    """Models with N(0, 1/fan_in) weights and N(0, 0.5^2) biases drawn
    from ``seed``: density is far from zero and the frame has structure
    (flax's init, std 0.02, renders an almost empty frame)."""
    gen = torch.Generator().manual_seed(seed)
    models = make_models(cfg, "cuda", gen)
    with torch.no_grad():
        for m in models:
            for name, p in m.named_parameters():
                std = 0.5 if name.endswith("bias") else p.shape[1] ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return models


@contextlib.contextmanager
def cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_path(tmp: str):
    write_test_split(tmp, np.random.default_rng(0))
    cfg = PipelineConfig()
    save_models(os.path.join(tmp, "model"), "model_1", seeded_models(cfg, 0))
    argv = ["-r", "-e", "-s", "-w", "--dataset_root", os.path.join(tmp, "data"),
            "--dataset_name", "lego", "--output_dir",
            os.path.join(tmp, "output")]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cwd(tmp):
        rc = entry_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        fail(f"entry returned {rc}")
    n_chunks = math.ceil(400 * 400 / CHUNK)
    for k, v in launches.items():
        if v != n_chunks * N_FRAMES:
            fail(f"{k} launched {v} times, expected {n_chunks} per frame "
                 f"over {N_FRAMES} frames")
    for i in range(N_FRAMES):
        if not os.path.getsize(os.path.join(tmp, "output", "given",
                                            f"result_{i:03d}.png")):
            fail(f"no output image {i}")
    return launches, wall / N_FRAMES


def frame_inputs():
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    pose = pose_spherical(30.0, -30.0, 4.0)
    g = torch.Generator(device="cuda").manual_seed(1)
    n = 400 * 400
    jitter = torch.rand((n, N_COARSE), generator=g, device="cuda")
    u = torch.sort(torch.rand((n, N_FINE + 1), generator=g, device="cuda"),
                   dim=-1).values
    return pose, focal, (jitter, u)


def frame_check():
    """One f32 frame through the kernels and through the nn.Module path,
    same weights, same injected noise."""
    cfg = PipelineConfig(white_bkg=True)
    models = seeded_models(cfg, 0)
    pose, focal, noise = frame_inputs()
    frames = {}
    for use_kernels in (True, False):
        frames[use_kernels] = render_image(
            models, pose, (400, 400), focal,
            cfg.replace(eval_use_pallas=use_kernels), noise=noise,
            render_depth=True, device="cuda")
    rgb_k, rgb_p = frames[True]["rgb"], frames[False]["rgb"]
    if not (np.isfinite(rgb_k).all()
            and np.isfinite(frames[True]["depth"]).all()):
        fail("non-finite f32 frame")
    diff = float(np.abs(rgb_k - rgb_p).max())
    if diff > FRAME_ATOL:
        fail(f"f32 frame: kernels vs plain path max abs diff {diff}")
    depth_std = float(frames[True]["depth"].std())
    if depth_std == 0.0:
        fail("blank frame: depth is constant")
    return diff, depth_std


def profile_frame():
    """Where one warm 400x400 bf16 frame (-s -w) spends its time: the host
    wall clock, and the device time of each kernel from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = PipelineConfig(white_bkg=True, use_bf16=True)
    models = seeded_models(cfg, 0)
    pose, focal, noise = frame_inputs()

    def frame():
        render_image(models, pose, (400, 400), focal, cfg, noise=noise,
                     device="cuda")
        torch.cuda.synchronize()

    frame()
    t0 = time.perf_counter()
    frame()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        wall_profiled = time.perf_counter() - t0
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        frame_s=wall, profiled_frame_s=wall_profiled,
        device_ms=device_ms if by_name else None,
        device_busy_share=(device_ms / 1e3 / wall_profiled
                           if by_name else None),
        top_device_ms=[[name[:90], ms] for name, ms in top])


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # phase 2: build
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in reports.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, sources=list(build.SOURCES), ptxas=ptxas)

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {}
    for name in KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            res = check_kernel(name, dtype, gen)
            checks[(name, dtype)] = res
            emit("kernel", **res)

    # phase 4: the render path
    with tempfile.TemporaryDirectory() as tmp:
        launches, s_per_frame = run_path(tmp)
        emit("path", command="python -m nerf_tpu_torch -r -e -s -w",
             frames=N_FRAMES, hw=[400, 400], launches=launches,
             s_per_frame_entry=s_per_frame)
    diff, depth_std = frame_check()
    emit("frame", f32_kernels_vs_plain_max_abs=diff, atol=FRAME_ATOL,
         depth_std=depth_std)
    emit("profile", **profile_frame())

    # phase 5: the kernels line, then the last line
    kernels = []
    for name, meta in KERNELS.items():
        res = checks[(name, torch.bfloat16)]   # -s renders in bf16
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=res["max_abs_err"], tol=res["tol"], ms=res["ms"],
            plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None,
            f32=dict(max_abs_err=checks[(name, torch.float32)]["max_abs_err"],
                     ms=checks[(name, torch.float32)]["ms"],
                     plain_ms=checks[(name, torch.float32)]["plain_ms"],
                     bound_ms=checks[(name, torch.float32)]["bound_ms"])))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
