#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  - a CUDA device must be present; the card's name and power limit
  2. build   - nvcc builds every kernel of nerf_tpu_torch/ops/csrc, one nvcc
               per source, all started together
  3. kernels - each kernel against its plain PyTorch version, bf16 and f32,
               with timings and bounds: the eval forwards at the shapes of
               one default 4096-ray chunk, the training kernels at those of
               one default step (1024 rays: 131,072 fine and 65,536 coarse
               points); for the bf16 backwards, planted cast faults must
               read beyond the limit that the kernels meet.  The Ref-NeRF
               forwards (ref_kernels) at one default chunk's 786,432 merged
               points, the directional one also with sRGB on and at IDE
               level 2; the Ref-NeRF training kernels at one default step's
               196,608 merged points, the directional backward also with
               sRGB on and at IDE level 2
  4. path    - `python -m nerf_tpu_torch -r -e -s -w` on a two-view 800x800
               Blender-layout test split with seeded random weights (full
               width vanilla model), counting kernel launches; then one f32
               frame through the kernels against the plain nn.Module path,
               and one warm bf16 frame timed and traced with torch.profiler
  5. ref     - the Ref-NeRF render path: `python -m nerf_tpu_torch -t -r -e
               -s -w --render_normal` on the same split with seeded random
               full-width Ref-NeRF weights, counting kernel launches and
               reading the normal panel (ref_path); one f32 frame through
               the kernels against the nn.Module path, rgb and normal map
               (ref_frame_check); one warm bf16 frame timed and traced
               (ref_profile)
  6. step    - one f32 training step at full width through the kernels and
               through the nn.Module path (use_pallas=False): same weights,
               rays and noise; loss and all 32 parameter grads compared, and
               each kernel call of the step held against its plain version
               on the call's own operands; the same for one f32 Ref-NeRF
               step (ref_step, bottleneck noise off, 1024 rays of 192 merged
               samples)
  7. train   - `python -m nerf_tpu_torch --epochs 5 -s -w` on a 20-view
               800x800 train split (rendered at 400x400, 100 steps),
               counting kernel launches per step, and the same 100 seeded
               steps with `--no_pallas`: the kernel route's loss curve must
               follow the nn.Module route's and the loss must fall; then
               `-r -e -s -w` renders the written checkpoint
  8. profile - the trainer's own epoch loop (cli.trainer.Trainer, bf16,
               steps issued back to back) timed (ms per step, rays/s) and
               one epoch traced with torch.profiler (device busy share, top
               ops)
  9. ref_train - phases 7 and 8 for Ref-NeRF: `python -m nerf_tpu_torch -t
               --epochs 5 -s -w` on the same split and the same steps with
               `--no_pallas`, launches per step, the two routes' curves and
               the normal and back-face losses; `-t -r -e -s -w
               --render_normal` of its checkpoint; its trainer loop timed and
               profiled (ref_train_profile)
 10. recompute - the recompute form of the training step
               (store_residuals=False): the four kernels of phase 3 that
               carry it (recompute_kernels, default step shapes); one f32
               step of each model, kernels vs nn.Module, with its launch set
               (step_recompute, ref_step_recompute); one bf16 step in the
               recompute form against the same step in the residual form
               (recompute_vs_res); the peak device memory and the ms per
               step of a default bf16 step in each form and model, 20
               `train_step` calls back to back (step_memory)
 11. hybrid  - `python -m nerf_tpu_torch -t --ref_kernels hybrid --epochs 5
               -s -w` against the same run with `--no_pallas`, one launch
               per step of the spatial recompute pair; `-t -r -e -s -w
               --ref_kernels hybrid --render_normal` of its checkpoint; its
               trainer loop timed and profiled (hybrid_train_profile)
 12. prop_res - the proposal net's residual pair
               (prop_store_residuals=True): its two kernels at one default
               step's 65,536 coarse points, bf16 and f32, with a planted
               bf16 fault, the density equal to prop_mlp_fwd's and the
               grads to prop_mlp_bwd's bit for bit, and prop_mlp_bwd's
               chunked grads equal to one chunk's (prop_res_kernels); one
               f32 step of each model with it, kernels vs nn.Module
               (step_prop_res, ref_step_prop_res); one bf16 step against
               the same step with the proposal recompute pair
               (prop_res_vs_recompute); step_memory (phase 10) measures
               its peak memory as a third form
 13. batch_scaling - nerf_tpu_torch.tools.batch_scaling's measure with 10
               steps a run: vanilla at 1024, 4096 and 16384 rays in three
               backward forms, Ref-NeRF at 1024 and 4096 in two; rays/s
               and peak device memory per row
 14. dissect - `python -m nerf_tpu_torch.tools.bench_ref_kernels --dissect
               --dissect_fwd` (N = 197,632, bf16 and f32): the directional
               forward's five stages and the backward's four modes timed
               and held against their plain versions, stage and mode
               "full" against the shipped kernels bit for bit, and the
               glue's derived costs
 15. the kernels line, then the last line {"ok": true, "device": {...}}

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
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.trainer import Trainer
from nerf_tpu_torch.core.encoding import cat_pos_pe, ide_tables
from nerf_tpu_torch.core.rays import fov_to_focal, pose_spherical
from nerf_tpu_torch.ops import build, ref_fused
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.train.step import (
    compute_loss, make_optimizer, sample_train_rays, train_parameters,
    train_step,
)
from nerf_tpu_torch.utils.checkpoint import save_models
from nerf_tpu_torch.utils.metrics import read_scalars
from nerf_tpu_torch.utils.png import read_png, write_png

LEGO_FOV = 0.6911112070083618       # lego's camera_angle_x
CHUNK = 4096                        # --eval_chunk default
N_COARSE, N_FINE = 64, 128          # sample defaults
N_MERGED = N_COARSE + N_FINE        # Ref-NeRF's merged samples per ray
RAYS = 1024                         # --sample_ray_num default
N_FRAMES = 2
TRAIN_VIEWS, TRAIN_EPOCHS = 20, 5   # 100 steps of the train phase
HBM_BYTES_PER_S = 3.35e12           # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the card.  bf16: both round every layer to
# bf16, but the kernel sums in another order, so a value near a rounding
# boundary can land one bf16 ulp (2^-8 relative) apart and carry on.  f32:
# summation order alone over K <= 319 terms.
TOLS = {torch.bfloat16: dict(rtol=2e-2, atol=1e-2),
        torch.float32: dict(rtol=1e-4, atol=1e-5)}
# The Ref-NeRF kernels' check draws its matrices N(0, 1 / fan_in), the scale
# of ``seeded_models`` (the weights its render path runs), not He's 2 /
# fan_in.  At He's scale the spatial net's nine bf16 layers amplify a
# one-ulp rounding difference from layer to layer: its function itself, in
# plain PyTorch on a CPU with the sums taken in f32 and then in f64, parts
# by up to 0.032 on 299 of 5.56 M heads, beyond TOLS, and at this scale by
# 0.007 on none.  The directional check takes its ray directions as a
# camera casts them: a |d| of 3 raises the level-4 IDE's z^8 terms to 1e5.
REF_GAIN = 1.0
# backward grads against the plain version, as the relative Frobenius error
# of each grad tensor, on the same stored activations.  Both round the same
# deltas to bf16 per layer; they part only where an f32 sum taken in another
# order lands on the other side of a rounding edge.  Measured on an H100
# 80GB HBM3 at these shapes: bf16 1.5e-6 (vanilla) and 8.8e-7 (proposal),
# f32 1.7e-6 and 7.6e-6.  A bf16 backward with a cast left out or added reads
# 2.2e-3 or more (``cast_controls``), so the limit sits between the two.
GRAD_REL = {torch.bfloat16: 1e-4, torch.float32: 1e-4}
# The Ref-NeRF backwards also round each TILE_ROWS rows' weight grad to
# bf16, as the TPU kernels do per grid step: a delta rounded one ulp apart
# moves a tile's partial by about 1e-4 of itself, and some rounded partials
# then land one bf16 ulp (2^-8) apart (7.9e-4 at N = 70 with 64-row tiles,
# tests/test_torch_cuda.py); d(heads) rounds the same way.  Measured on an
# H100 80GB HBM3 at these shapes: at most 2.4e-4 (d(heads) of the sRGB case);
# the planted faults, f32 throughout and each weight grad rounded once
# instead of per tile, read 5.4e-3 and 2.4e-3 or more.
REF_GRAD_REL = {torch.bfloat16: 8e-4, torch.float32: 1e-4}
# the 9 stored activations of vanilla_mlp_fwd_res, as the relative Frobenius
# error of each: a bf16 value that rounds one ulp apart in an early layer
# carries on through up to 8 layers, so single values deep in the net can
# sit several ulps apart (0.0625 on one value of 131,072 x 2,176 on an H100
# 80GB HBM3) while the tensors agree closely.
ACT_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# one f32 frame, kernels vs the nn.Module path: per-point outputs agree to
# ~1e-5 relative; the composite over 128 samples and the inverse-CDF depths
# pass it on without amplifying it by more than a few times.
FRAME_ATOL = 1e-3
# one f32 training step, kernels vs the nn.Module path.  Each kernel call of
# the step meets its plain version on the call's own operands (forwards
# within TOLS, backwards within GRAD_REL), so the kernels are not what parts
# the two routes: their forwards sum in another order, the fine sample
# depths that the inverse CDF draws from the proposal's density differ by
# f32 ulps, and the positional encoding's top frequency (2^9) amplifies
# that in the fine net's first layers (tests/test_torch_cuda.py shows it).
# Measured: 1.8e-4 on the worst grad of this step on an H100 80GB HBM3.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 2e-3
# the 100-step bf16 train run, kernels vs the nn.Module route (--no_pallas)
# from the same seed: the routes round differently (the kernels add each
# bias in f32, the nn.Modules in bf16), so their trajectories part step by
# step; each epoch's mean loss and mean image MSE must agree within these
# relative bands.  Measured on an H100 80GB HBM3: 6.9e-2 (loss, mostly the
# proposal loss, on its epoch of lowest mean) and 6.3e-3 (image MSE).  A
# trainer that stops learning reads above 1 on both.
TRAIN_BAND = {"loss": 0.25, "img_mse": 0.05}
# the Ref-NeRF training kernels round each TILE_ROWS rows' weight grad to
# the compute dtype (cfg.pallas_tile, the TPU kernels' grid tile)
TILE_ROWS = 2048
# The normal target -g / max(1e-5, |g|) is held against the plain version's
# target on the kernel's own stored activations (g is a pullback through
# their ReLU masks, and a pre-activation within rounding of 0 that the plain
# forward masks the other way moves g by a whole unit's term: 7.7e-4 on the
# measure below in f32, on an H100 80GB HBM3), weighted by |g|: the relative
# Frobenius error ||(t_kernel - t_plain) |g||| / ||g||.  g passes nine
# layers and the encoding's 2^9 frequency, so where |g| is small next to its
# own rounding noise its direction is that noise (3 of 12,291 components
# 0.5 apart in bf16 on the plain forward's masks, tests/test_torch_cuda.py);
# the weighting holds every point to its share of g.  Measured on the
# kernel's masks: 3.9e-8 (bf16) and 5.6e-8 (f32).  In f32 the targets are
# also held elementwise, within TOLS, where |g| exceeds DGRAD_MIN_NORM, a
# thousand times the clamp.
DGRAD_REL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
DGRAD_MIN_NORM = 1e-2
# one f32 Ref-NeRF step, kernels vs the nn.Module path: the same sources of
# difference as STEP_*, through 192 merged samples and two nets.  Measured
# on an H100 80GB HBM3: loss equal, worst grad 2.8e-5.
REF_STEP_LOSS_RTOL = 1e-4
REF_STEP_GRAD_REL = 1e-3
# the 100-step bf16 Ref-NeRF train run, kernels vs --no_pallas, epoch means
# of loss and image MSE: measured 1.8e-3 and 1.3e-3 on an H100 80GB HBM3
# (the routes round differently, as for TRAIN_BAND, but the Ref-NeRF loss is
# dominated by terms that the two routes compute alike)
REF_TRAIN_BAND = {"loss": 0.02, "img_mse": 0.02}

KERNELS = {
    "prop_mlp_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:478"),
    "vanilla_mlp_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:128"),
    "vanilla_mlp_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:150"),
    "vanilla_mlp_bwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:163"),
    "prop_mlp_bwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:493"),
    "ref_spa_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused.cu",
        replaces="nerf_tpu/ops/ref_fused.py:643"),
    "ref_dir_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused.cu",
        replaces="nerf_tpu/ops/ref_fused.py:841"),
    "ref_spa_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused.cu",
        replaces="nerf_tpu/ops/ref_fused.py:643"),
    "ref_dir_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused.cu",
        replaces="nerf_tpu/ops/ref_fused.py:841"),
    "ref_spa_bwd": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused_bwd.cu",
        replaces="nerf_tpu/ops/ref_fused.py:729"),
    "ref_dir_bwd": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused_bwd.cu",
        replaces="nerf_tpu/ops/ref_fused.py:901"),
    "vanilla_mlp_bwd_recompute": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp_recompute.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:136"),
    "ref_spa_fwd_grad": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused.cu",
        replaces="nerf_tpu/ops/ref_fused.py:643"),
    "ref_spa_bwd_recompute": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused_recompute.cu",
        replaces="nerf_tpu/ops/ref_fused.py:701"),
    "ref_dir_bwd_recompute": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused_recompute.cu",
        replaces="nerf_tpu/ops/ref_fused.py:867"),
    "prop_mlp_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:483"),
    "prop_mlp_bwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:499"),
    "ref_dir_fwd_dissect": dict(
        source="nerf_tpu_torch/ops/csrc/ref_dissect.cu",
        replaces="tools/bench_ref_kernels.py:145"),
    "ref_dir_bwd_dissect": dict(
        source="nerf_tpu_torch/ops/csrc/ref_dissect.cu",
        replaces="tools/bench_ref_kernels.py:45"),
}
RECOMPUTE_KERNELS = ("vanilla_mlp_bwd_recompute", "ref_spa_fwd_grad",
                     "ref_spa_bwd_recompute", "ref_dir_bwd_recompute")
PROP_RES_KERNELS = ("prop_mlp_fwd_res", "prop_mlp_bwd_res")
DISSECT_KERNELS = ("ref_dir_fwd_dissect", "ref_dir_bwd_dissect")
REF_KERNELS = ("prop_mlp_fwd", "ref_spa_fwd", "ref_dir_fwd")
# the other (ide_level, use_srgb) cases of the directional kernels' checks;
# the timed one is the default (4, False)
REF_DIR_VARIANTS = ((4, True), (2, False))
TRAIN_KERNELS = ("prop_mlp_fwd", "vanilla_mlp_fwd_res", "vanilla_mlp_bwd",
                 "prop_mlp_bwd")
REF_TRAIN_KERNELS = ("prop_mlp_fwd", "ref_spa_fwd_res", "ref_dir_fwd_res",
                     "ref_spa_bwd", "ref_dir_bwd", "prop_mlp_bwd")
# the launch sets of a recompute-form step and of a hybrid step
STEP_KERNELS = {
    ("vanilla", True): TRAIN_KERNELS,
    ("ref", True): REF_TRAIN_KERNELS,
    ("vanilla", False): ("prop_mlp_fwd", "vanilla_mlp_fwd",
                         "vanilla_mlp_bwd_recompute", "prop_mlp_bwd"),
    ("ref", False): ("prop_mlp_fwd", "ref_spa_fwd_grad", "ref_dir_fwd",
                     "ref_dir_bwd_recompute", "ref_spa_bwd_recompute",
                     "prop_mlp_bwd"),
    ("hybrid", True): ("prop_mlp_fwd", "ref_spa_fwd_grad",
                       "ref_spa_bwd_recompute", "prop_mlp_bwd"),
    # prop_store_residuals=True, the fine net residual
    ("vanilla", "prop_res"): ("prop_mlp_fwd_res", "vanilla_mlp_fwd_res",
                              "vanilla_mlp_bwd", "prop_mlp_bwd_res"),
    ("ref", "prop_res"): ("prop_mlp_fwd_res", "ref_spa_fwd_res",
                          "ref_dir_fwd_res", "ref_spa_bwd", "ref_dir_bwd",
                          "prop_mlp_bwd_res")}
# steps of the memory and time phase: 20 back to back, median of 3 runs
MEMORY_STEPS, MEMORY_RUNS = 20, 3


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


def bound(moved, flops, dtype):
    """The least time of the work on the card, and what bounds it."""
    bytes_s, ops_s = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=max(bytes_s, ops_s) * 1e3,
                bound_by="bytes" if bytes_s > ops_s else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_weights(shapes, gen, dtype, bias_std=0.5, gain=2.0):
    """(in, out) matrices N(0, gain / in) in ``dtype`` and (1, W) f32
    biases."""
    ws = []
    for shape, is_bias in shapes:
        t = torch.randn(shape, generator=gen, device="cuda")
        if is_bias:
            ws.append((t * bias_std).contiguous())
        else:
            ws.append((t * math.sqrt(gain / shape[0])).to(dtype).contiguous())
    return ws


def camera_dirs(gen, n):
    """n raw ray directions as a lego camera casts them: |d| from 1 (the
    optical axis) to 1.12 (a corner of the 0.69 rad field of view), in all
    orientations."""
    d = torch.randn((n, 3), generator=gen, device="cuda")
    scale = 1.0 + 0.12 * torch.rand((n, 1), generator=gen, device="cuda")
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) * scale


def prop_shapes(dx=63, h=256):
    mats = [(dx, h), (h, h), (h, h), (h, h), (h, 1)]
    out = []
    for m in mats:
        out += [(m, False), ((1, m[1]), True)]
    return out


def vanilla_shapes(dx=63, dd=27, h=256, bn=256, r=128):
    return tuple_shapes([
        (dx, h), None, (h, h), None, (h, h), None, (h, h), None,
        (dx, h), (h, h), None, (h, h), None, (h, bn), None, (bn, 1), None,
        (bn, bn), None, (bn, r), (dd, r), None, (r, 3), None])


def ref_spa_shapes(dx=63, h=256, o=256, nb=128):
    return tuple_shapes([
        (dx, h), None, (h, h), None, (h, h), None, (h, h), None,
        (dx, h), (h, h), None, (h, h), None, (h, h), None, (h, o), None,
        (o, 2), None, (o, 9), None, (o, nb), None])


def ref_dir_shapes(n_ch, h=256, o=256, nb=128):
    dd = nb + 2 * n_ch + 1
    return tuple_shapes([
        (dd, h), None, (h, h), None, (h, h), None, (h, h), None,
        (dd, h), (h, h), None, (h, h), None, (h, o), None, (o, o), None,
        (o, 3), None])


def tuple_shapes(m):
    """(shape, is_bias) of a weight tuple given as its matrices' shapes with
    None where a bias follows its (last) matrix."""
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


def ref_density_grad_macs(dx=63, h=256, o=256):
    """The normal target in ref_spa_fwd_res: the density column's pullback
    ([0, 1] @ wrt^T, w7^T, w6^T, w5^T, w4b^T, w3^T .. w1^T), the two
    pullbacks into the encoding and its transpose (3 x (dx - 3) each way)."""
    return 2 * o + h * o + 6 * h * h + 2 * dx * h + 6 * (dx - 3)


def ref_spa_delta_macs(h=256, o=256, nb=128):
    """ref_spa_bwd's deltas: the three heads' pullbacks, w7^T, then six
    H x H pullbacks (none into the encoding)."""
    return o * (11 + nb) + h * o + 6 * h * h


def ref_dir_delta_macs(n_ch, h=256, o=256, nb=128):
    """ref_dir_bwd's deltas: wh^T, w7^T, w6^T, five H x H pullbacks and the
    two pullbacks into the trunk input (Dd = nb + 2 C + 1 wide)."""
    dd = nb + 2 * n_ch + 1
    return 3 * o + o * o + h * o + 5 * h * h + 2 * dd * h


def ref_points(gen, dtype, n):
    """n points in the scene's box and their encoding [pos, PE(pos)]."""
    pos = torch.rand((n, 3), generator=gen, device="cuda").mul_(3).sub_(1.5)
    return pos, cat_pos_pe(pos, 10, dtype)


def _rel_err(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _encodings(gen, dtype, n, dd=True):
    x = torch.rand((n, 63), generator=gen, device="cuda").mul_(2).sub_(1)
    d = torch.rand((n, 27), generator=gen, device="cuda").mul_(2).sub_(1)
    return x.to(dtype), (d.to(dtype) if dd else None)


def kernel_case(name, dtype, gen, ide_level=4, use_srgb=False):
    """(arguments, kernel call, plain call, held call, bytes moved, FLOPs,
    points) of ``name`` at its main-path shapes; ``ide_level`` and
    ``use_srgb`` pick the case of ref_dir_fwd.  The held call is what the
    kernel's output is held against: the plain version, except for the
    recompute backwards, whose plain version runs on the forward kernel's
    activations there (the kernel rebuilds them bit for bit; a plain
    forward rounds elsewhere in bf16 and may set a ReLU mask the other way,
    which moves a grad by a unit's whole term)."""
    held = None
    if name == "prop_mlp_fwd":
        shapes, n = prop_shapes(), CHUNK * N_COARSE
        ws = random_weights(shapes, gen, dtype)
        x, _ = _encodings(gen, dtype, n, dd=False)
        args, kernel, plain = (ws, x), ops.prop_mlp_fwd, ops.prop_mlp_plain
        moved = _nbytes(x, *ws) + n * 4
        macs = macs_per_point(shapes)
    elif name == "vanilla_mlp_fwd":
        shapes, n = vanilla_shapes(), CHUNK * N_FINE
        ws = random_weights(shapes, gen, dtype)
        x, d = _encodings(gen, dtype, n)
        args = (ws, x, d)
        kernel, plain = ops.vanilla_mlp_fwd, ops.vanilla_mlp_plain
        moved = _nbytes(x, d, *ws) + n * 4 * 4
        macs = macs_per_point(shapes)
    elif name == "vanilla_mlp_fwd_res":
        shapes, n = vanilla_shapes(), RAYS * N_FINE
        ws = random_weights(shapes, gen, dtype)
        x, d = _encodings(gen, dtype, n)
        args = (ws, x, d)
        kernel, plain = ops.vanilla_mlp_fwd_res, ops.vanilla_mlp_fwd_res_plain
        elem = torch.empty((), dtype=dtype).element_size()
        moved = _nbytes(x, d, *ws) + n * 4 * 4 + n * 2176 * elem
        macs = macs_per_point(shapes)
    elif name == "vanilla_mlp_bwd":
        shapes, n = vanilla_shapes(), RAYS * N_FINE
        ws = random_weights(shapes, gen, dtype)
        x, d = _encodings(gen, dtype, n)
        rgb3, _, acts = ops.vanilla_mlp_fwd_res(ws, x, d)
        g_rgb = torch.randn((3, n), generator=gen, device="cuda")
        g_sig = torch.randn((n,), generator=gen, device="cuda")
        args = (ws, x, d, g_rgb, g_sig, rgb3, acts)
        kernel, plain = ops.vanilla_mlp_bwd, ops.vanilla_mlp_bwd_plain
        moved = _nbytes(x, d, g_rgb, g_sig, rgb3, *acts, *ws) \
            + 4 * sum(w.numel() for w in ws)
        # weight grads plus the deltas (none to the encodings)
        macs = macs_per_point(shapes) + 492_160
    elif name == "vanilla_mlp_bwd_recompute":
        shapes, n = vanilla_shapes(), RAYS * N_FINE
        ws = random_weights(shapes, gen, dtype)
        x, d = _encodings(gen, dtype, n)
        g_rgb = torch.randn((3, n), generator=gen, device="cuda")
        g_sig = torch.randn((n,), generator=gen, device="cuda")
        args = (ws, x, d, g_rgb, g_sig)
        kernel = ops.vanilla_mlp_bwd_recompute
        plain = ops.vanilla_mlp_bwd_recompute_plain
        rgb3, _, acts = ops.vanilla_mlp_fwd_res(ws, x, d)
        held = lambda *a: plain(*a, fwd=(rgb3, acts))   # noqa: E731
        moved = _nbytes(x, d, g_rgb, g_sig, *ws) + 4 * sum(w.numel()
                                                          for w in ws)
        # the rebuilt forward, the deltas and the weight grads
        macs = 2 * macs_per_point(shapes) + 492_160
    elif name == "ref_spa_fwd":
        shapes, n = ref_spa_shapes(), CHUNK * N_MERGED
        ws = random_weights(shapes, gen, dtype, gain=REF_GAIN)
        x, _ = _encodings(gen, dtype, n, dd=False)
        args, kernel, plain = (ws, x), ops.ref_spa_fwd, ops.ref_spa_plain
        moved = _nbytes(x, *ws) + n * (ref_fused.HEAD_FIXED + 128) * 4
        macs = macs_per_point(shapes)
    elif name == "ref_dir_fwd":
        tables = ide_tables(ide_level)
        shapes, n = ref_dir_shapes(tables["n_ch"]), CHUNK * N_MERGED
        ws = random_weights(shapes, gen, dtype, gain=REF_GAIN)
        # heads as the spatial kernel writes them: f32, the bottleneck last
        heads = torch.randn((n, ref_fused.HEAD_FIXED + 128), generator=gen,
                            device="cuda")
        dirs = camera_dirs(gen, CHUNK)
        args = (ws, heads, dirs, N_MERGED, None, ide_level, use_srgb)
        kernel, plain = ops.ref_dir_fwd, ops.ref_dir_plain
        moved = _nbytes(heads, dirs, *ws) + n * 7 * 4 \
            + (tables["mat"].size + tables["sigma"].size) * 4
        # the trunk, and the IDE's z-powers @ mat
        macs = macs_per_point(shapes) + tables["mat"].size
    elif name in ("ref_spa_fwd_res", "ref_spa_bwd", "ref_spa_fwd_grad",
                  "ref_spa_bwd_recompute"):
        shapes, n = ref_spa_shapes(), RAYS * N_MERGED
        ws = random_weights(shapes, gen, dtype, gain=REF_GAIN)
        pos, x = ref_points(gen, dtype, n)
        elem = x.element_size()
        if name in ("ref_spa_fwd_res", "ref_spa_fwd_grad"):
            args = (ws, x, pos)
            kernel, plain = (
                (ops.ref_spa_fwd_res, ops.ref_spa_fwd_res_plain)
                if name == "ref_spa_fwd_res" else
                (ops.ref_spa_fwd_grad, ops.ref_spa_fwd_grad_plain))
            moved = _nbytes(x, pos, *ws) + n * (ref_fused.HEAD_FIXED + 128
                                                + 3) * 4 + (
                n * 8 * 256 * elem if name == "ref_spa_fwd_res" else 0)
            macs = macs_per_point(shapes) + ref_density_grad_macs()
        elif name == "ref_spa_bwd_recompute":
            acts = ops.ref_spa_fwd_res(ws, x, pos)[2]
            g = torch.randn((n, ref_fused.HEAD_FIXED + 128), generator=gen,
                            device="cuda")
            args, kernel = (ws, x, g, TILE_ROWS), ops.ref_spa_bwd_recompute
            plain = ops.ref_spa_bwd_recompute_plain
            held = lambda *a: plain(*a, acts=acts)   # noqa: E731
            moved = _nbytes(x, g, *ws) + 4 * sum(w.numel() for w in ws)
            macs = 2 * macs_per_point(shapes) + ref_spa_delta_macs()
        else:
            _, _, acts = ops.ref_spa_fwd_res(ws, x, pos)
            g = torch.randn((n, ref_fused.HEAD_FIXED + 128), generator=gen,
                            device="cuda")
            args, kernel = (ws, x, g, acts, TILE_ROWS), ops.ref_spa_bwd
            plain = ops.ref_spa_bwd_plain
            moved = _nbytes(x, g, *acts, *ws) + 4 * sum(w.numel() for w in ws)
            macs = macs_per_point(shapes) + ref_spa_delta_macs()
    elif name in ("ref_dir_fwd_res", "ref_dir_bwd", "ref_dir_bwd_recompute"):
        tables = ide_tables(ide_level)
        shapes, n = ref_dir_shapes(tables["n_ch"]), RAYS * N_MERGED
        ws = random_weights(shapes, gen, dtype, gain=REF_GAIN)
        heads = torch.randn((n, ref_fused.HEAD_FIXED + 128), generator=gen,
                            device="cuda")
        dirs = camera_dirs(gen, RAYS)
        noise = (0.02 * torch.randn((n, 128), generator=gen,
                                    device="cuda")).to(dtype)
        fwd = (ws, heads, dirs, N_MERGED, noise, ide_level, use_srgb)
        glue = tables["mat"].size + tables["sigma"].size
        if name == "ref_dir_fwd_res":
            args, kernel = fwd, ops.ref_dir_fwd_res
            plain = ops.ref_dir_fwd_res_plain
            moved = _nbytes(heads, dirs, noise, *ws) + n * 7 * 4 \
                + glue * 4 + n * 8 * 256 * noise.element_size()
            macs = macs_per_point(shapes) + tables["mat"].size
        else:
            acts = ops.ref_dir_fwd_res(*fwd)[3]
            g_rgb, g_nrm = torch.randn((2, n, 3), generator=gen,
                                       device="cuda")
            g_den = torch.randn((n,), generator=gen, device="cuda")
            grads_out = n * heads.shape[1] * 4 + 4 * sum(w.numel()
                                                         for w in ws)
            if name == "ref_dir_bwd":
                args = (*fwd[:5], g_rgb, g_nrm, g_den, acts, ide_level,
                        use_srgb, TILE_ROWS)
                kernel, plain = ops.ref_dir_bwd, ops.ref_dir_bwd_plain
                moved = _nbytes(heads, dirs, noise, g_rgb, g_nrm, g_den,
                                *acts, *ws) + glue * 4 + grads_out
                macs = macs_per_point(shapes) + ref_dir_delta_macs(
                    tables["n_ch"]) + 2 * tables["mat"].size
            else:
                args = (*fwd[:5], g_rgb, g_nrm, g_den, ide_level, use_srgb,
                        TILE_ROWS)
                kernel = ops.ref_dir_bwd_recompute
                plain = ops.ref_dir_bwd_recompute_plain
                held = lambda *a: plain(*a, acts=acts)   # noqa: E731
                moved = _nbytes(heads, dirs, noise, g_rgb, g_nrm, g_den,
                                *ws) + glue * 4 + grads_out
                # the rebuilt glue and trunk, the deltas, the weight grads
                macs = 2 * macs_per_point(shapes) + ref_dir_delta_macs(
                    tables["n_ch"]) + 3 * tables["mat"].size
    elif name == "prop_mlp_fwd_res":
        shapes, n = prop_shapes(), RAYS * N_COARSE
        ws = random_weights(shapes, gen, dtype)
        x, _ = _encodings(gen, dtype, n, dd=False)
        args, kernel = (ws, x), ops.prop_mlp_fwd_res
        plain = ops.prop_mlp_fwd_res_plain
        moved = _nbytes(x, *ws) + n * 4 + n * 4 * 256 * x.element_size()
        macs = macs_per_point(shapes)
    elif name == "prop_mlp_bwd_res":
        shapes, n = prop_shapes(), RAYS * N_COARSE
        ws = random_weights(shapes, gen, dtype)
        x, _ = _encodings(gen, dtype, n, dd=False)
        acts = ops.prop_mlp_fwd_res(ws, x)[1]
        g = torch.randn((n,), generator=gen, device="cuda")
        args, kernel = (ws, x, g, acts), ops.prop_mlp_bwd_res
        plain = ops.prop_mlp_bwd_res_plain
        moved = _nbytes(x, g, *acts, *ws) + 4 * sum(w.numel() for w in ws)
        # the deltas and the weight grads
        macs = macs_per_point(shapes) + 256 + 3 * 256 * 256
    else:   # prop_mlp_bwd
        shapes, n = prop_shapes(), RAYS * N_COARSE
        ws = random_weights(shapes, gen, dtype)
        x, _ = _encodings(gen, dtype, n, dd=False)
        g = torch.randn((n,), generator=gen, device="cuda")
        args, kernel, plain = (ws, x, g), ops.prop_mlp_bwd, \
            ops.prop_mlp_bwd_plain
        moved = _nbytes(x, g, *ws) + 4 * sum(w.numel() for w in ws)
        # the recomputed forward, the deltas and the weight grads
        macs = 2 * macs_per_point(shapes) + 256 + 3 * 256 * 256
    return args, kernel, plain, held or plain, moved, 2.0 * macs * n, n


def is_bwd(name: str) -> bool:
    return "_bwd" in name


HEAD_GROUPS = ((0, 1), (1, 2), (2, 5), (5, 8), (8, 11), (11, None))


def dheads_rel(got, want):
    """The worst relative Frobenius error over the column groups of
    d(heads): rho, density, normal, diffuse, tint, bottleneck."""
    return max(_rel_err(got[:, a:b], want[:, a:b]) for a, b in HEAD_GROUPS)


def grad_rel(name, dtype):
    return (REF_GRAD_REL if name.startswith("ref") else GRAD_REL)[dtype]


def compare_grads(name, dtype, got, want):
    rels, lim = [], grad_rel(name, dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.isfinite(g).all():
            fail(f"{name} {dtype}: non-finite grad {i}")
        rels.append(_rel_err(g, w))
        if rels[-1] > lim:
            fail(f"{name} {dtype}: grad {i} relative error {rels[-1]} "
                 f"beyond {lim}")
    return max(float((g - w).abs().max()) for g, w in zip(got, want)), \
        max(rels)


def target_check(dtype, got, ws, enc, pos, acts):
    """Hold the kernel's normal target ``got`` against the plain one on the
    kernel's activations ``acts`` (DGRAD_REL): its |g|-weighted relative
    error, and where |g| > DGRAD_MIN_NORM the f32 targets' largest allclose
    ratio (at most 1 within TOLS); both are returned."""
    g = ref_fused.density_grad_plain(ws, enc, pos, acts)
    want = ref_fused.normal_target(g)
    g = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    rel = _rel_err(got * g, want * g)
    live = g[:, 0] > DGRAD_MIN_NORM
    tol = TOLS[torch.float32]
    ratio = float(((got[live] - want[live]).abs()
                   / (tol["atol"] + tol["rtol"] * want[live].abs())).max())
    if not (float(live.float().mean()) > 0.99
            and rel <= DGRAD_REL[dtype]
            and (dtype != torch.float32 or ratio <= 1.0)):
        fail(f"normal target {dtype}: |g|-weighted relative error {rel} "
             f"(limit {DGRAD_REL[dtype]}), f32 allclose ratio {ratio}, "
             f"live share {float(live.float().mean())}")
    return rel, ratio


def compare(name, dtype, got, want, args=()):
    """Hold a kernel's outputs against the plain version's; returns (max
    abs err of the outputs, worst relative Frobenius error of the grads or
    the stored activations, or None, and a dict of further readings)."""
    if name in ("ref_dir_bwd", "ref_dir_bwd_recompute"):
        rel = dheads_rel(got[0], want[0])
        if not (torch.isfinite(got[0]).all() and rel <= grad_rel(name,
                                                                  dtype)):
            fail(f"{name} {dtype}: d(heads) relative error {rel} beyond "
                 f"{grad_rel(name, dtype)}")
        err, worst = compare_grads(name, dtype, got[1], want[1])
        return max(err, float((got[0] - want[0]).abs().max())), \
            max(rel, worst), {"dheads_rel_err": rel}
    if name in ("prop_mlp_bwd", "prop_mlp_bwd_res"):
        return (*compare_grads(name, dtype, got, want),
                prop_bwd_identities(name, dtype, got, args))
    if is_bwd(name):
        return (*compare_grads(name, dtype, got, want), {})
    act_rel, extra = None, {}
    if name == "prop_mlp_fwd_res":
        if not torch.equal(got[0], ops.prop_mlp_fwd(*args)):
            fail(f"prop_mlp_fwd_res {dtype}: the density differs from "
                 f"prop_mlp_fwd's on the same operands")
        extra = {"density_equals_prop_mlp_fwd": True}
    if name == "ref_spa_fwd_grad":
        # the target on the residual form's activations, which this form
        # computes but keeps as bit masks in shared memory
        res = ops.ref_spa_fwd_res(*args)
        rel, ratio = target_check(dtype, got[1], *args, res[2])
        extra = {"normal_target_rel": rel, "normal_target_tol":
                 DGRAD_REL[dtype], "normal_target_f32_ratio": ratio,
                 "equals_res_form": bool(torch.equal(got[0], res[0])
                                         and torch.equal(got[1], res[1]))}
        got, want = (got[0],), (want[0],)
    if name.endswith("_res"):
        act_rels = [_rel_err(g.float(), w.float())
                    for g, w in zip(got[-1], want[-1])]
        act_rel = max(act_rels)
        if not all(math.isfinite(r) for r in act_rels) \
                or act_rel > ACT_REL[dtype]:
            fail(f"{name} {dtype}: activation relative errors {act_rels} "
                 f"beyond {ACT_REL[dtype]}")
        if name == "ref_spa_fwd_res":
            # the normal target, then the heads (whose last column decides
            # the positive share below)
            rel, ratio = target_check(dtype, got[1], *args, got[-1])
            extra = {"normal_target_rel": rel, "normal_target_tol":
                     DGRAD_REL[dtype], "normal_target_f32_ratio": ratio}
            got, want = (got[0],), (want[0],)
        else:
            got, want = got[:-1], want[:-1]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            fail(f"{name} {dtype}: non-finite output")
        if not torch.allclose(g.float(), w.float(), **TOLS[dtype]):
            fail(f"{name} {dtype}: max abs err {err} beyond {TOLS[dtype]}")
    # share of points whose density/sigma passes the ReLU downstream
    active = float((want[-1] > 0).float().mean())
    if not 0.0 < active < 1.0:
        fail(f"{name} {dtype}: degenerate test inputs (positive share "
             f"{active})")
    return err, act_rel, extra


def prop_bwd_identities(name, dtype, got, args):
    """What the proposal backwards must equal bit for bit on the same
    operands: prop_mlp_bwd_res the recompute form's grads (the same delta
    pass without the rebuild); prop_mlp_bwd, walked in chunks of whole
    K-splits, the grads of one chunk over all the points (the unchunked
    pass, whose ms is timed too)."""
    if name == "prop_mlp_bwd_res":
        same = ops.prop_mlp_bwd(*args[:3])
        readings = {"equals_prop_mlp_bwd": True}
    else:
        ops.fused_mlp.CHUNK_ROWS, chunk = 1 << 40, ops.fused_mlp.CHUNK_ROWS
        try:
            same = ops.prop_mlp_bwd(*args)
            readings = {"equals_one_chunk": True, "one_chunk_ms": cuda_ms(
                lambda: ops.prop_mlp_bwd(*args), 20)}
        finally:
            ops.fused_mlp.CHUNK_ROWS = chunk
    if not all(map(torch.equal, got, same)):
        fail(f"{name} {dtype}: grads differ from {list(readings)[0]}: "
             f"{[_rel_err(a, b) for a, b in zip(got, same)]}")
    return readings


def cast_controls(name, args, want):
    """Readings of planted faults of a bf16 backward against the plain
    version's grads ``want``, each the worst relative Frobenius error over
    the grads it changes: the vanilla backward with every delta left in f32
    (the plain backward on operands upcast to f32) and with dbb summed from
    dbvec rounded to bf16 (fused_mlp.py:240 sums it in f32); the proposal
    backward run in f32 throughout; the Ref-NeRF backwards in f32
    throughout, and with each weight grad rounded to bf16 once instead of
    per TILE_ROWS rows."""
    up = lambda ts: [t.float() for t in ts]   # noqa: E731

    def worst(got, ref):
        return max(_rel_err(a, b) for a, b in zip(got, ref))

    if name == "ref_spa_bwd":
        ws, x, g, acts, tile = args
        return {"f32_throughout": worst(ops.ref_spa_bwd_plain(
                    up(ws), x.float(), g, up(acts), tile), want),
                "rounded_once": worst(ops.ref_spa_bwd_plain(
                    ws, x, g, acts, x.shape[0]), want)}
    if name == "ref_spa_bwd_recompute":
        ws, x, g, tile = args
        acts = ops.ref_spa_fwd_res(ws, x, x[:, :3].float().contiguous())[2]
        plain = ops.ref_spa_bwd_recompute_plain
        return {"f32_throughout": worst(plain(up(ws), x.float(), g, tile,
                                              up(acts)), want),
                "rounded_once": worst(plain(ws, x, g, x.shape[0], acts),
                                      want)}
    if name == "ref_dir_bwd_recompute":
        (ws, heads, dirs, per_ray, noise, g_rgb, g_nrm, g_den, level, srgb,
         tile) = args
        acts = ops.ref_dir_fwd_res(ws, heads, dirs, per_ray, noise, level,
                                   srgb)[3]
        name, args = "ref_dir_bwd", (*args[:8], acts, level, srgb, tile)
    if name == "vanilla_mlp_bwd_recompute":
        rgb3, _, acts = ops.vanilla_mlp_fwd_res(*args[:3])
        args = (*args, rgb3, acts)
    if name == "ref_dir_bwd":
        (ws, heads, dirs, per_ray, noise, g_rgb, g_nrm, g_den, acts, level,
         srgb, tile) = args
        f32 = ops.ref_dir_bwd_plain(up(ws), heads, dirs, per_ray,
                                    noise.float(), g_rgb, g_nrm, g_den,
                                    up(acts), level, srgb, tile)[1]
        once = ops.ref_dir_bwd_plain(*args[:11], heads.shape[0])[1]
        return {"f32_throughout": worst(f32, want[1]),
                "rounded_once": worst(once, want[1])}
    if name == "prop_mlp_bwd":
        ws, x, g = args
        f32 = ops.prop_mlp_bwd_plain(up(ws), x.float(), g)
        return {"f32_throughout": max(_rel_err(a, b)
                                      for a, b in zip(f32, want))}
    if name == "prop_mlp_bwd_res":
        ws, x, g, acts = args
        f32 = ops.prop_mlp_bwd_res_plain(up(ws), x.float(), g, up(acts))
        return {"f32_throughout": max(_rel_err(a, b)
                                      for a, b in zip(f32, want))}
    ws, x, d, g_rgb, g_sig, rgb3, acts = args
    f32 = ops.vanilla_mlp_bwd_plain(up(ws), x.float(), d.float(), g_rgb,
                                    g_sig, rgb3, up(acts))
    cd = x.dtype
    dlogit3 = (g_rgb * rgb3 * (1.0 - rgb3)).to(cd).float()
    dr1 = torch.where(acts[8].float() > 0, dlogit3.T @ ws[22].float().T,
                      0.0).to(cd).float()
    dbvec = dr1 @ ws[19].float().T
    dbb = dbvec.to(cd).float().sum(0, keepdim=True)
    return {"deltas_f32": max(_rel_err(a, b) for a, b in zip(f32, want)),
            "dbb_from_rounded_dbvec": _rel_err(dbb, want[18])}


def check_kernel(name, dtype, gen, timed=True, **case):
    """Hold ``name`` against its plain version at its main-path shapes (the
    ``case`` of ref_dir_fwd); with ``timed`` also time both."""
    args, kernel, plain, held, moved, flops, n = kernel_case(name, dtype,
                                                             gen, **case)
    got = kernel(*args)
    want = held(*args)
    torch.cuda.synchronize()
    err, rel, readings = compare(name, dtype, got, want, args)
    if held is not plain:
        # a reading: against the plain version with its own forward
        full = plain(*args)
        pairs = (list(zip(got[1], full[1])) + [(got[0], full[0])]
                 if name == "ref_dir_bwd_recompute" else zip(got, full))
        readings["plain_forward_rel_err"] = max(_rel_err(a, b)
                                                for a, b in pairs)
        del full
    controls = None
    if is_bwd(name) and dtype == torch.bfloat16:
        controls = cast_controls(name, args, want)
        if min(controls.values()) <= grad_rel(name, dtype):
            fail(f"{name}: a planted cast fault reads {controls}, within "
                 f"the limit {grad_rel(name, dtype)}: the limit cannot tell "
                 f"it")
    del got, want
    rel_key = "act_rel_err" if name.endswith("_res") else "grad_rel_err"
    tol = (grad_rel(name, dtype) if is_bwd(name) else
           dict(TOLS[dtype], act_rel=ACT_REL[dtype]) if rel is not None
           else TOLS[dtype])
    extra = {} if controls is None else {"planted_faults_rel": controls}
    res = dict(name=name, dtype=str(dtype).replace("torch.", ""), n=n,
               **case, max_abs_err=err, **{rel_key: rel}, tol=tol,
               **readings, **extra)
    if not timed:
        return res
    ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 20)
    return dict(res, ms=ms, plain_ms=plain_ms, **bound(moved, flops, dtype),
                bytes=moved, flops=flops, tflops=flops / (ms * 1e-3) / 1e12)


# ---------------------------------------------------------------------------
# phase 4: the render path
# ---------------------------------------------------------------------------

def write_split(root: str, split: str, n_views: int,
                gen: np.random.Generator):
    """``n_views`` 800x800 RGBA views of ``split`` in the Blender layout
    under root/data/lego, lego's field of view, poses on the orbit."""
    scene = os.path.join(root, "data", "lego")
    os.makedirs(os.path.join(scene, split))
    yy, xx = np.mgrid[0:800, 0:800] / 800.0
    frames = []
    for i in range(n_views):
        pose = pose_spherical(-180.0 + 360.0 * i / max(n_views, 4), -30.0,
                              4.0)
        frames.append({"file_path": f"./{split}/r_{i}",
                       "transform_matrix": pose.tolist()})
        phase = gen.uniform(0, 2 * np.pi, 3)
        rgb = 0.5 + 0.5 * np.sin(6 * xx[..., None] + 4 * yy[..., None] + phase)
        alpha = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.1)[..., None]
        img = np.concatenate([rgb, alpha], -1) * 255.0 + 0.5
        write_png(os.path.join(scene, split, f"r_{i}.png"),
                  img.astype(np.uint8))
    with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
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


def run_path(tmp: str, model: str = "vanilla"):
    """``python -m nerf_tpu_torch -r -e -s -w`` (``model="ref"``: with ``-t
    --render_normal``) on a two-view test split with seeded random weights:
    (launches, s per frame).  Each eval forward of the path launches once per
    chunk, every other kernel never; the Ref-NeRF grids carry the normal
    panel, which must not be blank."""
    write_split(tmp, "test", N_FRAMES, np.random.default_rng(0))
    cfg = PipelineConfig(model=model)
    save_models(os.path.join(tmp, "model"), "model_1",
                seeded_models(cfg, 0 if model == "vanilla" else 3))
    ref = model == "ref"
    argv = ((["-t"] if ref else []) + ["-r", "-e", "-s", "-w"]
            + (["--render_normal"] if ref else [])
            + ["--img_scale", "0.5", "--dataset_root",
               os.path.join(tmp, "data"), "--dataset_name", "lego",
               "--output_dir", os.path.join(tmp, "output")])
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
    path_kernels = REF_KERNELS if ref else ("prop_mlp_fwd", "vanilla_mlp_fwd")
    for k, v in launches.items():
        want = n_chunks * N_FRAMES if k in path_kernels else 0
        if v != want:
            fail(f"{k} launched {v} times, expected {want} ({n_chunks} per "
                 f"frame of the eval forwards over {N_FRAMES} frames)")
    normal_std = []
    for i in range(N_FRAMES):
        grid = read_png(os.path.join(tmp, "output", "given",
                                     f"result_{i:03d}.png"))
        # panels of 400 columns, 2 apart: rgb[, normal], ground truth
        if grid.shape[1] != (3 if ref else 2) * 402 - 2:
            fail(f"output image {i} has shape {grid.shape}")
        if ref:
            normal_std.append(float(grid[:, 402:802].std()))
            if normal_std[-1] == 0.0:
                fail(f"the normal panel of image {i} is blank")
    return launches, wall / N_FRAMES, normal_std


def frame_inputs():
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    pose = pose_spherical(30.0, -30.0, 4.0)
    g = torch.Generator(device="cuda").manual_seed(1)
    n = 400 * 400
    jitter = torch.rand((n, N_COARSE), generator=g, device="cuda")
    u = torch.sort(torch.rand((n, N_FINE + 1), generator=g, device="cuda"),
                   dim=-1).values
    return pose, focal, (jitter, u)


def frame_check(model: str = "vanilla"):
    """One f32 frame through the kernels and through the nn.Module path,
    same weights, same injected noise: max abs diff of rgb (and of the
    Ref-NeRF normal map), and the depth's spread."""
    ref = model == "ref"
    cfg = PipelineConfig(model=model, white_bkg=True)
    models = seeded_models(cfg, 3 if ref else 0)
    pose, focal, noise = frame_inputs()
    frames = {}
    for use_kernels in (True, False):
        ops.reset_launches()
        frames[use_kernels] = render_image(
            models, pose, (400, 400), focal,
            cfg.replace(eval_use_pallas=use_kernels), noise=noise,
            render_depth=True, render_normal=ref, device="cuda")
        launched = sum(ops.LAUNCHES.values())
        if (launched > 0) != use_kernels:
            fail(f"f32 {model} frame (kernels: {use_kernels}) launched "
                 f"{dict(ops.LAUNCHES)}")
    diffs = {}
    for key in ("rgb", "normal") if ref else ("rgb",):
        got, want = frames[True][key], frames[False][key]
        if not np.isfinite(got).all():
            fail(f"non-finite f32 {model} frame ({key})")
        diffs[key] = float(np.abs(got - want).max())
        if diffs[key] > FRAME_ATOL:
            fail(f"f32 {model} frame: kernels vs plain path {key} max abs "
                 f"diff {diffs[key]}")
    depth_std = float(frames[True]["depth"].std())
    if not (np.isfinite(frames[True]["depth"]).all() and depth_std > 0.0):
        fail(f"blank or non-finite f32 {model} frame: depth std {depth_std}")
    return diffs, depth_std


def profile_frame(model: str = "vanilla"):
    """Where one warm 400x400 bf16 frame (-s -w; Ref-NeRF with the normal
    map) spends its time: the host wall clock, and the device time of each
    kernel from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    ref = model == "ref"
    cfg = PipelineConfig(model=model, white_bkg=True, use_bf16=True)
    models = seeded_models(cfg, 3 if ref else 0)
    pose, focal, noise = frame_inputs()

    def frame():
        render_image(models, pose, (400, 400), focal, cfg, noise=noise,
                     render_normal=ref, device="cuda")
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
    device_ms, top = device_times(prof)
    return dict(
        frame_s=wall, profiled_frame_s=wall_profiled, device_ms=device_ms,
        device_busy_share=(device_ms / 1e3 / wall_profiled
                           if device_ms is not None else None),
        top_device_ms=top)


def device_times(prof, n_top: int = 8):
    """(total device ms, [[kernel name, ms], ...] of the top ``n_top``) of a
    torch.profiler run; (None, []) when it saw no device activity."""
    from torch.autograd import DeviceType

    by_name = {}
    for evt in prof.events():
        # user annotations (Optimizer.step#...) are ranges, not device work
        if evt.device_type == DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return ((sum(by_name.values()) if by_name else None),
            [[name[:90], ms] for name, ms in top])


# ---------------------------------------------------------------------------
# phase 5: one f32 training step, kernels against the nn.Module path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def calls_held_against_plain(record: dict):
    """While open, every call of a training kernel's wrapper made by the
    autograd Functions also runs the plain version on the call's own
    operands.  ``record`` gets, per kernel, the worst error: for a forward
    max |got - want| / (atol + rtol |want|) over its outputs, with TOLS'
    f32 terms (allclose holds where it is at most 1; the Ref-NeRF normal
    target by ``target_check``); for a backward the relative
    Frobenius error of each grad (and of d(heads)).  Under
    "relu_mask_flips" it counts the stored activations whose ReLU mask
    differs from the plain forward's."""
    fm, rf = ops.fused_mlp, ops.ref_fused
    tol = TOLS[torch.float32]

    def quiet(name, *args, **kw):
        """A kernel call made only to hold another kernel against its plain
        version (the residual forwards give the activations that the
        recompute kernels rebuild bit for bit): its launch is not counted."""
        before = dict(ops.LAUNCHES)
        out = orig[name](*args, **kw)
        ops.LAUNCHES.update(before)
        return out

    def note(key, value):
        record[key] = max(record.get(key, 0.0), value)

    def close(got, want):
        return max(float(((a - b).abs() / (tol["atol"] + tol["rtol"]
                                           * b.abs())).max())
                   for a, b in zip(got, want) if a.numel())

    def flips(got, want):
        record["relu_mask_flips"] = record.get("relu_mask_flips", 0) + sum(
            int(((a > 0) != (b > 0)).sum()) for a, b in zip(got, want))

    def fwd(name, got, want, args):
        if name == "ref_spa_fwd_grad":
            acts = quiet("ref_spa_fwd_res", *args)[2]
            note("normal_target_rel", target_check(torch.float32, got[1],
                                                   *args, acts)[0])
            got, want = (got[0],), (want[0],)
        if name.endswith("_res"):
            flips(got[-1], want[-1])
            if name == "ref_spa_fwd_res":
                note("normal_target_rel", target_check(
                    torch.float32, got[1], *args, got[-1])[0])
                got, want = (got[0],), (want[0],)
            else:
                got, want = got[:-1], want[:-1]
        note(name, close(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)))

    def bwd(name, got, want, args):
        if name in ("ref_dir_bwd", "ref_dir_bwd_recompute"):
            note(name, dheads_rel(got[0], want[0]))
            got, want = got[1], want[1]
        note(name, max(_rel_err(a, b) for a, b in zip(got, want)))

    def vanilla_rc(ws, x, d, g_rgb, g_sig, **kw):
        rgb3, _, acts = quiet("vanilla_mlp_fwd_res", ws, x, d)
        return fm.vanilla_mlp_bwd_recompute_plain(ws, x, d, g_rgb, g_sig,
                                                  fwd=(rgb3, acts))

    def spa_rc(ws, enc, g, tile=ref_fused.TILE, **kw):
        acts = quiet("ref_spa_fwd_res", ws, enc,
                     enc[:, :3].float().contiguous())[2]
        return rf.ref_spa_bwd_recompute_plain(ws, enc, g, tile, acts=acts)

    def dir_rc(ws, heads, dirs, per_ray, noise, g_rgb, g_nrm, g_den,
               ide_level=4, use_srgb=False, tile=ref_fused.TILE, **kw):
        acts = quiet("ref_dir_fwd_res", ws, heads, dirs, per_ray, noise,
                     ide_level, use_srgb)[3]
        return rf.ref_dir_bwd_recompute_plain(
            ws, heads, dirs, per_ray, noise, g_rgb, g_nrm, g_den, ide_level,
            use_srgb, tile, acts=acts)

    held = {"prop_mlp_fwd": (fm, fm.prop_mlp_plain),
            "prop_mlp_fwd_res": (fm, fm.prop_mlp_fwd_res_plain),
            "prop_mlp_bwd_res": (fm, fm.prop_mlp_bwd_res_plain),
            "vanilla_mlp_fwd": (fm, fm.vanilla_mlp_plain),
            "vanilla_mlp_fwd_res": (fm, fm.vanilla_mlp_fwd_res_plain),
            "vanilla_mlp_bwd": (fm, fm.vanilla_mlp_bwd_plain),
            "vanilla_mlp_bwd_recompute": (fm, vanilla_rc),
            "prop_mlp_bwd": (fm, fm.prop_mlp_bwd_plain),
            "ref_spa_fwd_res": (rf, rf.ref_spa_fwd_res_plain),
            "ref_spa_fwd_grad": (rf, rf.ref_spa_fwd_grad_plain),
            "ref_dir_fwd": (rf, rf.ref_dir_plain),
            "ref_dir_fwd_res": (rf, rf.ref_dir_fwd_res_plain),
            "ref_spa_bwd": (rf, rf.ref_spa_bwd_plain),
            "ref_spa_bwd_recompute": (rf, spa_rc),
            "ref_dir_bwd": (rf, rf.ref_dir_bwd_plain),
            "ref_dir_bwd_recompute": (rf, dir_rc)}
    orig = {k: getattr(mod, k) for k, (mod, _) in held.items()}

    def wrap(name, plain):
        check = bwd if is_bwd(name) else fwd

        def call(*args, device=None, **kw):
            out = orig[name](*args, device=device, **kw)
            check(name, out, plain(*args, **kw), args)
            return out
        return call

    for k, (mod, plain) in held.items():
        setattr(mod, k, wrap(k, plain))
    try:
        yield record
    finally:
        for k, (mod, _) in held.items():
            setattr(mod, k, orig[k])


def step_batch(seed: int = 2):
    """One default step's rays (1024 of a 400x400 view), ground truth and
    injected noise (jitter, sorted uniforms), from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    pose = torch.tensor(pose_spherical(30.0, -30.0, 4.0)[:3],
                        device="cuda")
    pool = torch.rand((1, 400 * 400, 3), generator=g, device="cuda")
    rays, gt = sample_train_rays(pool, pose[None], 0, (400, 400), focal,
                                 RAYS, generator=g)
    jitter = torch.rand((RAYS, N_COARSE), generator=g, device="cuda")
    u = torch.sort(torch.rand((RAYS, N_FINE + 1), generator=g,
                              device="cuda"), dim=-1).values
    return rays, gt, jitter, u


def step_check(model: str = "vanilla", store_residuals: bool = True,
               prop_res: bool = False):
    """Loss and grads of one f32 step at full width (1024 rays, 64 + 128
    samples, 256-wide nets; Ref-NeRF with its bottleneck noise off) through
    the kernels' autograd (the residual or the recompute form; with
    ``prop_res`` the proposal net's residual pair) and through the
    nn.Module path, same weights, rays and injected noise; each kernel call
    of the step held against its plain version on its own operands (a
    recompute backward on its forward kernel's activations, which it
    rebuilds bit for bit), and the step's launch set checked."""
    ref = model == "ref"
    cfg = PipelineConfig(model=model, bottleneck_noise=0.0,
                         store_residuals=store_residuals,
                         prop_store_residuals=prop_res)
    kernels = STEP_KERNELS[(model, "prop_res" if prop_res
                            else store_residuals)]
    loss_rtol, grad_rel = ((REF_STEP_LOSS_RTOL, REF_STEP_GRAD_REL) if ref
                           else (STEP_LOSS_RTOL, STEP_GRAD_REL))
    models = seeded_models(cfg, 4 if ref else 1)
    rays, gt, jitter, u = step_batch()
    params = train_parameters(models)
    out, per_call = {}, {}
    for use_kernels in (True, False):
        ops.reset_launches()
        with calls_held_against_plain(per_call):
            loss, metrics = compute_loss(models, rays, gt,
                                         cfg.replace(use_pallas=use_kernels),
                                         noise=(jitter, u))
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[use_kernels] = (loss, metrics, grads, dict(ops.LAUNCHES))
    launches = out[True][3]
    if any(launches[k] != (k in kernels) for k in launches) or any(
            out[False][3].values()):
        fail(f"{model} step check: unexpected launches {launches} / "
             f"{out[False][3]}")
    f32 = torch.float32
    for k in kernels:
        lim = GRAD_REL[f32] if is_bwd(k) else 1.0
        if k not in per_call or not per_call[k] <= lim:
            fail(f"{model} step check: {k} against its plain version on the "
                 f"step's own operands reads {per_call.get(k)}, limit {lim}")
    loss_k, loss_p = out[True][0].item(), out[False][0].item()
    if not (math.isfinite(loss_k)
            and abs(loss_k - loss_p) <= loss_rtol * abs(loss_p)):
        fail(f"{model} step check: loss {loss_k} (kernels) vs {loss_p} "
             f"(plain)")
    rels = [_rel_err(a, b) for a, b in zip(out[True][2], out[False][2])]
    if not all(math.isfinite(r) for r in rels) or max(rels) > grad_rel:
        fail(f"{model} step check: grad relative errors {rels} beyond "
             f"{grad_rel}")
    metrics = {k: float(v.detach()) for k, v in out[False][1].items()}
    if metrics["prop_loss"] <= 0.0 or (ref and metrics["normal_loss"] <= 0.0):
        fail(f"{model} step check: a loss term is zero (degenerate "
             f"weights): {metrics}")
    return dict(loss_kernels=loss_k, loss_plain=loss_p, loss_rtol=loss_rtol,
                metrics_plain=metrics, grad_rel_err_max=max(rels),
                grad_rel_err_median=statistics.median(rels),
                grad_rel_tol=grad_rel, n_grads=len(rels),
                per_call_vs_plain=per_call, launches=launches)


def recompute_vs_res(model: str):
    """One default bf16 step (1024 rays, 64 + 128 samples, 256-wide nets,
    bottleneck noise off) in the recompute form against the same step in
    the residual form: same weights, rays and noise.  Both forms rebuild or
    store the same forward bits; the vanilla and directional backwards sum
    alike, the spatial recompute backward as jax.vjp does (d(inter) in
    another order, the heads' bias grads from the f32 cotangent).  The
    loss, each grad's relative error (limit: the backward's bf16 grad
    limit) and how many grads are equal bit for bit."""
    cfg = PipelineConfig(model=model, bottleneck_noise=0.0, use_bf16=True)
    models = seeded_models(cfg, 6)
    rays, gt, jitter, u = step_batch(7)
    params = train_parameters(models)
    out = {}
    for res in (True, False):
        loss, _ = compute_loss(models, rays, gt,
                               cfg.replace(store_residuals=res),
                               noise=(jitter, u))
        out[res] = (loss.item(), torch.autograd.grad(loss, params))
    rels = [_rel_err(a, b) for a, b in zip(out[False][1], out[True][1])]
    lim = (REF_GRAD_REL if model == "ref" else GRAD_REL)[torch.bfloat16]
    names = [n for m in models for n, _ in m.named_parameters()]
    worst = max(range(len(rels)), key=rels.__getitem__)
    loss_rel = abs(out[False][0] / out[True][0] - 1.0)
    if not (math.isfinite(out[False][0]) and max(rels) <= lim
            and loss_rel <= STEP_LOSS_RTOL):
        fail(f"{model} bf16 recompute vs residual step: loss {out[False][0]}"
             f" vs {out[True][0]}, grad relative errors {rels} (limit {lim})")
    return dict(loss_res=out[True][0], loss_recompute=out[False][0],
                loss_rel=loss_rel, grad_rel_err_max=max(rels),
                worst_grad=names[worst],
                grad_rel_err_median=statistics.median(rels), grad_rel_tol=lim,
                n_grads=len(rels),
                grads_equal=sum(int(torch.equal(a, b)) for a, b in
                                zip(out[False][1], out[True][1])))


def prop_res_vs_recompute(model: str):
    """One default bf16 step (as ``recompute_vs_res``) with the proposal
    net's residual pair against the same step with its recompute pair, the
    fine net residual in both: the residual forward gives the recompute
    form's density bit for bit and its backward the same grads, so the loss
    and every grad are expected equal; each grad is held to the bf16 grad
    limit and the equal ones counted."""
    cfg = PipelineConfig(model=model, bottleneck_noise=0.0, use_bf16=True)
    models = seeded_models(cfg, 6)
    rays, gt, jitter, u = step_batch(7)
    params = train_parameters(models)
    out = {}
    for res in (True, False):
        ops.reset_launches()
        loss, _ = compute_loss(models, rays, gt,
                               cfg.replace(prop_store_residuals=res),
                               noise=(jitter, u))
        out[res] = (loss.item(), torch.autograd.grad(loss, params),
                    dict(ops.LAUNCHES))
    if out[True][2]["prop_mlp_bwd_res"] != 1 or out[False][2][
            "prop_mlp_bwd"] != 1:
        fail(f"{model} bf16 prop residual vs recompute step: launches "
             f"{out[True][2]} / {out[False][2]}")
    rels = [_rel_err(a, b) for a, b in zip(out[True][1], out[False][1])]
    lim = (REF_GRAD_REL if model == "ref" else GRAD_REL)[torch.bfloat16]
    loss_rel = abs(out[True][0] / out[False][0] - 1.0)
    if not (math.isfinite(out[True][0]) and max(rels) <= lim
            and loss_rel <= STEP_LOSS_RTOL):
        fail(f"{model} bf16 prop residual vs recompute step: loss "
             f"{out[True][0]} vs {out[False][0]}, grad relative errors "
             f"{rels} (limit {lim})")
    return dict(loss_prop_res=out[True][0], loss_prop_recompute=out[False][0],
                loss_rel=loss_rel, grad_rel_err_max=max(rels),
                grad_rel_tol=lim, n_grads=len(rels),
                grads_equal=sum(int(torch.equal(a, b)) for a, b in
                                zip(out[True][1], out[False][1])))


# the least peak-memory saving of the recompute form over the residual form
# at one default bf16 step: the residual Ref-NeRF step holds 16 activations
# of 196,608 x 256 in bf16 (1.6 GB) from the forward to the backward, the
# vanilla step 9 of 131,072 x (256, 128) (0.57 GB)
MEMORY_SAVING = {"vanilla": 0.4e9, "ref": 1.2e9}


def step_memory(model: str):
    """The peak device memory and the time of one default bf16 step (1024
    rays, -s, bottleneck noise 0.02) through ``train_step`` in the residual
    and the recompute form, and in the residual form with the proposal
    net's residual pair (``prop_res``), same seeded weights and rays.  Memory:
    ``max_memory_allocated`` after ``reset_peak_memory_stats`` around one
    warm step (forward, backward, Adam), and its excess over what was
    allocated before the step.  Time: ms per step over MEMORY_STEPS
    back-to-back calls then a synchronize, median of MEMORY_RUNS; the
    launches of those steps, one per step of each kernel of the form and
    none of the other form's."""
    out = {}
    for form in ("res", "recompute", "prop_res"):
        res = form != "recompute"
        cfg = PipelineConfig(model=model, use_bf16=True, store_residuals=res,
                             prop_store_residuals=form == "prop_res")
        models = seeded_models(cfg, 8)
        opt = make_optimizer(models)
        rays, gt, _, _ = step_batch(9)
        gen = torch.Generator(device="cuda").manual_seed(10)

        def step():
            train_step(models, opt, rays, gt, cfg, 1e-4, generator=gen)

        step()                      # Adam's state, the kernels loaded
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ops.reset_launches()
        times = []
        for _ in range(MEMORY_RUNS):
            t0 = time.perf_counter()
            for _ in range(MEMORY_STEPS):
                step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / MEMORY_STEPS)
        launches = dict(ops.LAUNCHES)
        steps = MEMORY_STEPS * MEMORY_RUNS
        want = dict(dict.fromkeys(launches, 0),
                    **dict.fromkeys(STEP_KERNELS[
                        (model, "prop_res" if form == "prop_res" else res)],
                        steps))
        if launches != want:
            fail(f"{model} {form} steps launched {launches}, expected {want}")
        ms = statistics.median(times) * 1e3
        out[form] = dict(peak_bytes=peak, step_bytes=peak - base,
                         ms_per_step=ms, ms_per_step_runs=[t * 1e3
                                                           for t in times],
                         rays_per_s=RAYS / (ms * 1e-3), steps=steps,
                         launches=launches)
        del models, opt
        torch.cuda.empty_cache()
    saving = out["res"]["peak_bytes"] - out["recompute"]["peak_bytes"]
    if saving < MEMORY_SAVING[model]:
        fail(f"{model}: the recompute form saves {saving} bytes of peak "
             f"memory, less than {MEMORY_SAVING[model]}: {out}")
    return dict(out, peak_saving_bytes=saving,
                peak_saving_min=MEMORY_SAVING[model])


# ---------------------------------------------------------------------------
# the ray-batch sweep and the directional kernels' dissection
# ---------------------------------------------------------------------------

# the backward forms of the sweep: the distinct configurations of
# batch_scaling's prop_res and residuals axes (the fine net's form, the
# proposal net's form)
SCALING_FORMS = {
    "fine_res_prop_res": dict(store_residuals=True,
                              prop_store_residuals=True),
    "fine_res_prop_recompute": dict(store_residuals=True,
                                    prop_store_residuals=False),
    "fine_recompute_prop_recompute": dict(store_residuals=False,
                                          prop_store_residuals=False),
}
# vanilla at three ray batches in all three forms; Ref-NeRF, whose residual
# step holds about 3 GB at 1024 rays, at two, on the prop_res axis
SCALING_ROWS = (
    [("vanilla", r, f) for r in (1024, 4096, 16384) for f in SCALING_FORMS]
    + [("ref", r, f) for r in (1024, 4096)
       for f in ("fine_res_prop_res", "fine_res_prop_recompute")])
SCALING_STEPS = 10


def batch_scaling_rows():
    """``nerf_tpu_torch.tools.batch_scaling.measure(cfg, n_scan=10)`` on each
    row of SCALING_ROWS, on the tool's default scene: rays/s (the best of 3
    runs of 10 steps after a warm one) and the peak device memory of the
    measurement.  Running out of memory fails the phase."""
    from nerf_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_tpu_torch.tools import batch_scaling

    scene = make_synthetic_scene(n_train=8, n_test=1, hw=(400, 400), seed=0,
                                 n_samples=64, device="cuda")[0]
    rows = []
    for model, r, form in SCALING_ROWS:
        cfg = batch_scaling.config(model, r, use_pallas=True,
                                   **SCALING_FORMS[form])
        t0 = time.perf_counter()
        m = batch_scaling.measure(cfg, SCALING_STEPS, "cuda", scene)
        rows.append(dict(model=model, R=r, form=form, **m,
                         seconds=time.perf_counter() - t0))
        emit("batch_scaling", **rows[-1])
        torch.cuda.empty_cache()
    return rows


def dissect_macs(n_ch, stage_or_mode):
    """MACs per point of a dissection stage or mode: the trunk (and the
    IDE's z-powers @ mat from "vander" on); the backward modes add the
    delta pass (without the two pullbacks into the trunk input in
    "wgrads"), the weight grads and a rebuild."""
    mats = ref_dir_shapes(n_ch)
    fwd, mat = macs_per_point(mats), ide_tables(4)["mat"].size
    dd = 128 + 2 * n_ch + 1
    return {"trunk": fwd, "reflect": fwd, "vander": fwd + mat,
            "polar": fwd + mat, "full": fwd + mat,
            "recompute": fwd + mat,
            "dheads": fwd + ref_dir_delta_macs(n_ch) + 2 * mat,
            "wgrads": 2 * fwd + ref_dir_delta_macs(n_ch) - 2 * dd * 256 + mat,
            "bwd_full": 2 * fwd + ref_dir_delta_macs(n_ch) + 3 * mat,
            }[stage_or_mode]


def dissect_phase():
    """``python -m nerf_tpu_torch.tools.bench_ref_kernels --dissect
    --dissect_fwd`` at its defaults (N = 197,632, width 256, IDE level 4,
    seeded operands), bf16 then f32, its launches counted in the bf16 run;
    then every stage and mode against its plain version on the same
    operands (the backward modes on the forward kernel's activations, as
    for ref_dir_bwd_recompute), stage "full" against ref_dir_fwd and mode
    "full" against ref_dir_bwd_recompute, bit for bit, and the plain
    versions timed.  The derived costs: each forward stage less the one
    before it, and the backward's glue pullback (full less wgrads)."""
    from nerf_tpu_torch.ops.ref_dissect import BWD_MODES
    from nerf_tpu_torch.ops.ref_fused import DIR_STAGES
    from nerf_tpu_torch.tools import bench_ref_kernels as bench

    argv = ["--dissect", "--dissect_fwd"]
    ops.reset_launches()
    timed = {torch.bfloat16: bench.main(argv)}
    launches = dict(ops.LAUNCHES)
    timed[torch.float32] = bench.main(argv + ["--dtype", "f32"])
    for k in DISSECT_KERNELS:
        if launches[k] == 0:
            fail(f"the dissection run launched {k} no time: {launches}")
    n_ch = ide_tables(4)["n_ch"]
    per = {}
    for dtype in (torch.bfloat16, torch.float32):
        case = bench.make_case(dtype=dtype)
        n = case["n"]
        dargs = (case["dir_ws"], case["heads"], case["dirs"], 1)
        inputs = _nbytes(case["heads"], case["noise"], case["dirs"],
                         *case["dir_ws"])
        for stage in DIR_STAGES:
            got = bench.dissect_fwd_call(case, stage)()

            def plain(stage=stage):
                return ops.ref_dir_fwd_dissect_plain(
                    *dargs, stage, case["noise"], case["rows"],
                    case["ide_level"])
            want = plain()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            for a, b in zip(got, want):
                if not torch.allclose(a, b, **TOLS[dtype]):
                    fail(f"ref_dir_fwd_dissect[{stage}] {dtype}: max abs err "
                         f"{err} beyond {TOLS[dtype]}")
            if stage == "full" and not all(map(torch.equal, got, (
                    ops.ref_dir_fwd(*dargs, case["noise"],
                                    case["ide_level"])))):
                fail(f"ref_dir_fwd_dissect[full] {dtype} differs from "
                     f"ref_dir_fwd")
            moved = inputs + n * 7 * 4 + (
                _nbytes(case["rows"]) if stage in ("trunk", "reflect") else 0)
            per[("fwd", stage, dtype)] = dict(
                max_abs_err=err, tol=TOLS[dtype],
                ms=timed[dtype]["fwd_stages"][stage],
                plain_ms=cuda_ms(plain, 20),
                **bound(moved, 2.0 * n * dissect_macs(n_ch, stage), dtype))
            del got, want
        acts = ops.ref_dir_fwd_res(*dargs, case["noise"], case["ide_level"])[3]
        gs = (case["g_rgb"], case["g_normal"], case["g_density"])
        for mode in BWD_MODES:
            dh, grads = bench.dissect_bwd_call(case, mode)()

            def plain(mode=mode, acts=None):
                return ops.ref_dir_bwd_dissect_plain(
                    *dargs, case["noise"], *gs, mode, case["ide_level"],
                    acts=acts)
            pdh, pgrads = plain(acts=acts)
            if mode == "recompute":
                rel = None
                if not torch.allclose(dh, pdh, **TOLS[dtype]):
                    fail(f"ref_dir_bwd_dissect[recompute] {dtype}: rgb, "
                         f"normal, density beyond {TOLS[dtype]}")
            else:
                rel = dheads_rel(dh, pdh) if mode != "wgrads" else 0.0
                if not rel <= REF_GRAD_REL[dtype]:
                    fail(f"ref_dir_bwd_dissect[{mode}] {dtype}: d(heads) "
                         f"relative error {rel}")
            gerr, grel = compare_grads("ref_dir_bwd_dissect", dtype, grads,
                                       pgrads)
            if mode == "full":
                full = ops.ref_dir_bwd_recompute(*dargs, case["noise"], *gs,
                                                 case["ide_level"])
                if not (torch.equal(dh, full[0])
                        and all(map(torch.equal, grads, full[1]))):
                    fail(f"ref_dir_bwd_dissect[full] {dtype} differs from "
                         f"ref_dir_bwd_recompute")
                del full
            moved = inputs + _nbytes(*gs) + n * case["heads"].shape[1] * 4 \
                + 4 * sum(w.numel() for w in case["dir_ws"])
            macs = dissect_macs(n_ch, "bwd_full" if mode == "full" else mode)
            per[("bwd", mode, dtype)] = dict(
                max_abs_err=max(gerr, float((dh - pdh).abs().max())),
                dheads_rel_err=rel, grad_rel_err=grel,
                tol=REF_GRAD_REL[dtype], ms=timed[dtype]["bwd_modes"][mode],
                plain_ms=cuda_ms(plain, 20),
                **bound(moved, 2.0 * n * macs, dtype))
            del dh, grads, pdh, pgrads
        del case, acts
        torch.cuda.empty_cache()
    fw = {k: v["ms"] for (d, k, dt), v in per.items()
          if d == "fwd" and dt == torch.bfloat16}
    bw = {k: v["ms"] for (d, k, dt), v in per.items()
          if d == "bwd" and dt == torch.bfloat16}
    return dict(
        n=bench.N_DEFAULT,
        launches={k: launches[k] for k in DISSECT_KERNELS},
        per={f"{d} {k} {str(dt).replace('torch.', '')}": v
             for (d, k, dt), v in per.items()},
        fwd_stage_cost_ms_bf16={f"{b} - {a}": fw[b] - fw[a] for a, b in
                                zip(DIR_STAGES, DIR_STAGES[1:])},
        fwd_glue_ms_bf16=fw["full"] - fw["trunk"],
        fwd_glue_share_bf16=(fw["full"] - fw["trunk"]) / fw["full"],
        bwd_glue_pullback_ms_bf16=bw["full"] - bw["wgrads"],
        bwd_glue_pullback_share_bf16=(bw["full"] - bw["wgrads"]) / bw["full"],
        bwd_rebuild_share_bf16=bw["recompute"] / bw["full"]), per


# ---------------------------------------------------------------------------
# phase 6: the train path, then render-only on its checkpoint
# ---------------------------------------------------------------------------

def train_argv(tmp: str, *extra: str):
    """The train phase's command line (after ``python -m nerf_tpu_torch``)."""
    return ["--epochs", str(TRAIN_EPOCHS), "-s", "-w", "--dataset_root",
            os.path.join(tmp, "data"), "--dataset_name", "lego",
            "--warmup_step", "20", "--eval_time", "1", "--no_tensorboard",
            "--output_dir", os.path.join(tmp, "output"), *extra]


def train_once(tmp: str, route: str, *extra: str):
    """One run of the entry with the train phase's flags and ``extra``:
    (launches, per-step losses, per-step image MSEs, seconds); under ``-t``
    the normal and back-face losses must be logged and finite too."""
    log_dir = os.path.join(tmp, "logs", route)
    argv = train_argv(tmp, "--log_dir", log_dir, *extra)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cwd(tmp):
        rc = entry_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        fail(f"train entry ({route}) returned {rc}")
    log = [os.path.join(d, f) for d, _, fs in os.walk(log_dir)
           for f in fs if f == "metrics.jsonl"][0]
    losses = [v for _, v in read_scalars(log, "Train Loss")]
    mses = [10.0 ** (-v / 10.0) for _, v in read_scalars(log, "PSNR")]
    steps = TRAIN_VIEWS * TRAIN_EPOCHS
    if "-t" in extra:
        for tag in ("Normal Loss", "Backface Loss"):
            vals = [v for _, v in read_scalars(log, tag)]
            if len(vals) != steps or not all(map(math.isfinite, vals)):
                fail(f"train path ({route}): {len(vals)} logged {tag} "
                     f"values, expected {steps} finite ones")
    if not (len(losses) == len(mses) == steps
            and all(math.isfinite(v) for v in losses + mses)):
        fail(f"train path ({route}): {len(losses)} logged losses, expected "
             f"{steps} finite ones")
    return launches, losses, mses, wall


def epoch_means(values):
    return [statistics.mean(values[i:i + TRAIN_VIEWS])
            for i in range(0, len(values), TRAIN_VIEWS)]


def write_train_split(tmp: str):
    rng = np.random.default_rng(1)
    write_split(tmp, "train", TRAIN_VIEWS, rng)
    write_split(tmp, "test", 1, rng)


# the train phases' routes: (flags, kernels of a step, band of the epoch
# means against --no_pallas, kernels of an eval render)
ROUTES = {
    "vanilla": ((), TRAIN_KERNELS, TRAIN_BAND,
                ("prop_mlp_fwd", "vanilla_mlp_fwd")),
    "ref": (("-t", "--name", "ref_1"), REF_TRAIN_KERNELS, REF_TRAIN_BAND,
            REF_KERNELS),
    "hybrid": (("-t", "--ref_kernels", "hybrid", "--name", "hybrid_1"),
               STEP_KERNELS[("hybrid", True)], REF_TRAIN_BAND,
               ("prop_mlp_fwd", "ref_spa_fwd"))}


def run_train(tmp: str, model: str = "vanilla"):
    """``python -m nerf_tpu_torch [-t [--ref_kernels hybrid]] --epochs 5 -s
    -w`` on the 20-view train split, through the kernels and through the
    nn.Module route (``--no_pallas``, its checkpoint under another name):
    launches per step of each training kernel, and the two routes' loss
    curves."""
    flags, kernels, band_lim, eval_kernels = ROUTES[model]
    steps = TRAIN_VIEWS * TRAIN_EPOCHS
    eval_chunks = math.ceil(400 * 400 / CHUNK)   # one test view, at the end
    runs = {"plain": train_once(tmp, f"{model}_plain", *flags, "--no_pallas",
                                "--name", f"{model}_plain_route"),
            "kernels": train_once(tmp, f"{model}_kernels", *flags)}
    want = dict(dict.fromkeys(ops.LAUNCHES, 0),
                **dict.fromkeys(eval_kernels, eval_chunks))
    if runs["plain"][0] != want:
        fail(f"{model} train path --no_pallas launches {runs['plain'][0]}, "
             f"expected {want}")
    want = dict(want, prop_mlp_fwd=steps + eval_chunks,
                **{k: steps for k in kernels[1:]})
    launches, losses, mses, wall = runs["kernels"]
    if launches != want:
        fail(f"{model} train path launches {launches}, expected {want}")
    curves = {route: {"loss": epoch_means(r[1]), "img_mse": epoch_means(r[2])}
              for route, r in runs.items()}
    for route, c in curves.items():
        c["other_loss"] = [a - b for a, b in zip(c["loss"], c["img_mse"])]
    band = {key: [abs(k / p - 1.0) for k, p in zip(curves["kernels"][key],
                                                   curves["plain"][key])]
            for key in ("loss", "img_mse")}
    if any(max(band[k]) > band_lim[k] for k in band):
        fail(f"{model} train path: the kernel route's epoch means part from "
             f"the nn.Module route's by {band}, beyond {band_lim}: {curves}")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if not last < first:
        fail(f"{model} train path: loss did not fall ({first} -> {last})")
    for route, c in curves.items():
        if not c["img_mse"][-1] < c["img_mse"][0]:
            fail(f"{model} train path: the image MSE of the {route} route "
                 f"did not fall: {curves}")
    return dict(command="python -m nerf_tpu_torch " + " ".join(
        a if "/" not in a else "<tmp>" for a in train_argv(tmp, *flags)),
        steps=steps, launches=launches,
        launches_per_step={k: launches[k] / steps for k in kernels},
        loss_first10=first, loss_last10=last, epoch_means=curves,
        kernels_vs_plain_rel=band, band=band_lim, s_entry=wall,
        s_entry_plain=runs["plain"][3])


def render_trained(tmp: str, model: str = "vanilla"):
    """``-r -e -s -w`` (Ref-NeRF: ``-t ... --render_normal``, the hybrid
    route with ``--ref_kernels hybrid``) on the checkpoint the train phase
    wrote: each eval kernel of the route launches once per chunk, no other
    kernel."""
    ref = model != "vanilla"
    flags, _, _, eval_kernels = ROUTES[model]
    argv = list(flags) + ["-r", "-e", "-s", "-w", "--dataset_root",
                    os.path.join(tmp, "data"), "--dataset_name", "lego",
                    "--output_dir", os.path.join(tmp, "output")] \
        + (["--render_normal"] if ref else [])
    ops.reset_launches()
    with cwd(tmp):
        rc = entry_main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_chunks = math.ceil(400 * 400 / CHUNK)
    want = dict(dict.fromkeys(launches, 0),
                **dict.fromkeys(eval_kernels, n_chunks))
    if rc != 0 or launches != want:
        fail(f"render of the trained {model} checkpoint: rc {rc}, launches "
             f"{launches}, expected {want}")
    grid = read_png(os.path.join(tmp, "output", "given", "result_000.png"))
    # panels of 400 columns, 2 apart: rgb[, normal], ground truth
    if grid.shape[1] != (3 if ref else 2) * 402 - 2:
        fail(f"render of the trained {model} checkpoint: image shape "
             f"{grid.shape}")
    normal_std = float(grid[:, 402:802].std()) if ref else None
    if ref and not normal_std > 0.0:
        fail("render of the trained ref checkpoint: blank normal panel")
    return dict(command="python -m nerf_tpu_torch " + " ".join(
        a if "/" not in a else "<tmp>" for a in argv), launches=launches,
        normal_panel_std=normal_std)


# ---------------------------------------------------------------------------
# phase 7: the trainer's epoch loop, timed and profiled
# ---------------------------------------------------------------------------

def profile_trainer(tmp: str, epochs: int = 5, *extra: str):
    """ms per default bf16 step (1024 rays, -s) of the trainer's own epoch
    loop on the train split of phase 6: ``Trainer.run_epoch`` issues its
    steps back to back and the epoch ends in a synchronize, as the trainer's
    one read-back per epoch does.  The median over ``epochs`` epochs after
    a warm one, with the host's share (the time until ``run_epoch``
    returns); then one epoch traced with torch.profiler (device time and
    device operations per step)."""
    from torch.profiler import ProfilerActivity, profile

    args = get_parser().parse_args(train_argv(tmp, *extra))
    with cwd(tmp):
        trainer = Trainer(args, "cuda")
    steps = len(trainer.train_set)
    trainer.run_epoch(0)
    torch.cuda.synchronize()
    times, issue = [], []
    for ep in range(1, epochs + 1):
        t0 = time.perf_counter()
        trainer.run_epoch(ep)
        issue.append((time.perf_counter() - t0) / steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_epoch(epochs + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ms, top = device_times(prof, 10)
    from torch.autograd import DeviceType
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    ms = statistics.median(times) * 1e3
    return dict(step_ms_median=ms, step_ms_min=min(times) * 1e3,
                rays_per_s=RAYS / (ms * 1e-3), epochs_timed=epochs,
                host_issue_ms_per_step=statistics.median(issue) * 1e3,
                device_ops_per_step=kernels / steps,
                steps_per_epoch=steps, profiled_steps=steps,
                profiled_wall_ms_per_step=wall * 1e3 / steps,
                device_ms_per_step=(device_ms / steps
                                    if device_ms is not None else None),
                device_busy_share=(device_ms / (wall * 1e3)
                                   if device_ms is not None else None),
                top_device_ms_per_step=[[k, v / steps] for k, v in top])


def dissect_entry(name, meta, launches, per, n):
    """The kernels line's entry of a dissection kernel: its "full" stage or
    mode (the shipped kernel's work) at the top, every stage or mode's
    readings beside it."""
    kind = "fwd" if name == "ref_dir_fwd_dissect" else "bwd"
    parts = {k: v for (d, k, dt), v in per.items()
             if d == kind and dt == torch.bfloat16}
    f32 = {k: v for (d, k, dt), v in per.items()
           if d == kind and dt == torch.float32}
    full = parts["full"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=launches,
        max_abs_err=max(v["max_abs_err"] for v in parts.values()),
        rel_err=full.get("grad_rel_err"), tol=full["tol"],
        n=n, ms=full["ms"], plain_ms=full["plain_ms"],
        bound_ms=full["bound_ms"], bound_by=full["bound_by"],
        library_ms=None,
        f32={k: f32["full"][k] for k in keys},
        stages={k: {**{x: v[x] for x in keys}, "f32_ms": f32[k]["ms"],
                    "f32_max_abs_err": f32[k]["max_abs_err"]}
                for k, v in parts.items()})


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
        # the recompute kernels in phase 10, the rest in phases 12 and 14
        if name in RECOMPUTE_KERNELS + PROP_RES_KERNELS + DISSECT_KERNELS:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            res = check_kernel(name, dtype, gen)
            checks[(name, dtype)] = res
            emit("ref_kernels" if name.startswith("ref") else "kernel", **res)
            torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("ref_dir_fwd", "ref_dir_bwd"):
            for level, srgb in REF_DIR_VARIANTS:
                emit("ref_kernels", **check_kernel(
                    name, dtype, gen, timed=False, ide_level=level,
                    use_srgb=srgb))
                torch.cuda.empty_cache()

    # phase 4: the render path
    with tempfile.TemporaryDirectory() as tmp:
        render_launches, s_per_frame, _ = run_path(tmp)
        emit("path", command="python -m nerf_tpu_torch -r -e -s -w",
             frames=N_FRAMES, hw=[400, 400], launches=render_launches,
             s_per_frame_entry=s_per_frame)
    diffs, depth_std = frame_check()
    emit("frame", f32_kernels_vs_plain_max_abs=diffs["rgb"], atol=FRAME_ATOL,
         depth_std=depth_std)
    emit("profile", **profile_frame())

    # phase 5: the Ref-NeRF render path
    with tempfile.TemporaryDirectory() as tmp:
        ref_launches, ref_s_per_frame, normal_std = run_path(tmp, "ref")
        emit("ref_path", command="python -m nerf_tpu_torch -t -r -e -s -w "
             "--render_normal", frames=N_FRAMES, hw=[400, 400],
             launches=ref_launches,
             launches_per_frame={k: ref_launches[k] / N_FRAMES
                                 for k in REF_KERNELS},
             s_per_frame_entry=ref_s_per_frame,
             normal_panel_std=normal_std)
    diffs, depth_std = frame_check("ref")
    emit("ref_frame_check", f32_kernels_vs_plain_max_abs=diffs,
         atol=FRAME_ATOL, depth_std=depth_std)
    emit("ref_profile", **profile_frame("ref"))

    # phase 6: one f32 training step of each model, kernels against the
    # nn.Module path
    emit("step", **step_check())
    emit("ref_step", **step_check("ref"))

    # phases 7 to 9: the train paths, render-only on their checkpoints, and
    # their trainer loops timed and profiled
    with tempfile.TemporaryDirectory() as tmp:
        write_train_split(tmp)
        train = run_train(tmp)
        emit("train", **train)
        emit("render_trained", **render_trained(tmp))
        emit("train_profile", **profile_trainer(tmp))
        ref_train = run_train(tmp, "ref")
        emit("ref_train", **ref_train)
        emit("ref_render_trained", **render_trained(tmp, "ref"))
        emit("ref_train_profile", **profile_trainer(tmp, 3, "-t"))

        # phase 10: the recompute form of the training step
        for name in RECOMPUTE_KERNELS:
            for dtype in (torch.bfloat16, torch.float32):
                res = check_kernel(name, dtype, gen)
                checks[(name, dtype)] = res
                emit("recompute_kernels", **res)
                torch.cuda.empty_cache()
        emit("step_recompute", **step_check("vanilla", False))
        emit("ref_step_recompute", **step_check("ref", False))
        for model in ("vanilla", "ref"):
            emit("recompute_vs_res", model=model, **recompute_vs_res(model))
        memory = {}
        for model in ("vanilla", "ref"):
            memory[model] = step_memory(model)
            emit("step_memory", model=model, **memory[model])

        # phase 11: the hybrid route through the entry
        hybrid = run_train(tmp, "hybrid")
        emit("hybrid_train", **hybrid)
        emit("hybrid_render_trained", **render_trained(tmp, "hybrid"))
        emit("hybrid_train_profile", **profile_trainer(
            tmp, 3, "-t", "--ref_kernels", "hybrid"))

    # phase 12: the proposal net's residual pair
    for name in PROP_RES_KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            res = check_kernel(name, dtype, gen)
            checks[(name, dtype)] = res
            emit("prop_res_kernels", **res)
            torch.cuda.empty_cache()
    emit("step_prop_res", **step_check("vanilla", prop_res=True))
    emit("ref_step_prop_res", **step_check("ref", prop_res=True))
    for model in ("vanilla", "ref"):
        emit("prop_res_vs_recompute", model=model,
             **prop_res_vs_recompute(model))

    # phase 13: the training step across ray batches
    # (nerf_tpu_torch.tools.batch_scaling)
    ops.reset_launches()
    t0 = time.perf_counter()
    scaling = batch_scaling_rows()
    scaling_launches = dict(ops.LAUNCHES)
    emit("batch_scaling_done", seconds=time.perf_counter() - t0,
         launches=scaling_launches)
    for k in PROP_RES_KERNELS:
        if scaling_launches[k] == 0:
            fail(f"the batch-scaling sweep launched {k} no time")

    # phase 14: the directional kernels' dissection
    # (nerf_tpu_torch.tools.bench_ref_kernels --dissect --dissect_fwd)
    t0 = time.perf_counter()
    dissect, dissect_per = dissect_phase()
    emit("dissect", seconds=time.perf_counter() - t0, **dissect)

    # phase 15: the kernels line, then the last line.  ``launches`` is each
    # kernel's count in its path's run: the vanilla train path (training
    # steps and the final eval render) for the vanilla kernels, the Ref-NeRF
    # render path for the Ref-NeRF eval forwards, the Ref-NeRF train path
    # for its training kernels, the hybrid train path for the spatial
    # recompute pair, the recompute steps of phase 10 (60 train_step calls
    # of each model) for the other two recompute backwards, the
    # batch-scaling sweep of phase 13 for the proposal net's residual pair
    # and the dissection run of phase 14 (bf16) for the dissection kernels;
    # ``launches_render``, ``launches_ref``, ``launches_ref_train``,
    # ``launches_recompute_steps``, ``launches_hybrid_train`` and
    # ``launches_batch_scaling`` its count in each of those runs.
    recompute_steps = {k: memory["vanilla"]["recompute"]["launches"][k]
                       + memory["ref"]["recompute"]["launches"][k]
                       for k in ops.LAUNCHES}
    kernels = []
    for name, meta in KERNELS.items():
        if name in DISSECT_KERNELS:
            kernels.append(dissect_entry(name, meta, dissect["launches"][name],
                                         dissect_per, dissect["n"]))
            continue
        res = checks[(name, torch.bfloat16)]   # -s trains and renders in bf16
        f32 = checks[(name, torch.float32)]
        path = (scaling_launches if name in PROP_RES_KERNELS
                else hybrid["launches"] if name in ("ref_spa_fwd_grad",
                                                    "ref_spa_bwd_recompute")
                else recompute_steps if name in RECOMPUTE_KERNELS
                else ref_train["launches"] if name in REF_TRAIN_KERNELS[1:-1]
                else ref_launches if name.startswith("ref")
                else train["launches"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=path[name],
            launches_render=render_launches[name],
            launches_ref=ref_launches[name],
            launches_ref_train=ref_train["launches"][name],
            launches_recompute_steps=recompute_steps[name],
            launches_hybrid_train=hybrid["launches"][name],
            launches_batch_scaling=scaling_launches[name],
            max_abs_err=res["max_abs_err"],
            rel_err=res.get("grad_rel_err", res.get("act_rel_err")),
            tol=res["tol"], n=res["n"], ms=res["ms"],
            plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None,
            f32=dict(rel_err=f32.get("grad_rel_err", f32.get("act_rel_err")),
                     **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by")})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
