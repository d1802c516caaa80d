#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  - a CUDA device must be present; the card's name and power limit
  2. build   - nvcc builds every kernel of nerf_tpu_torch/ops/csrc, one nvcc
               per source, all started together; ptxas's registers, shared
               memory and spills of the weight-grad kernels and of every
               kernel that runs the layer tile (dense_tile) or the delta
               pass (delta_tile), and the tensor-core instructions (HGMMA
               for wgmma, HMMA for mma.sync) in each library's SASS and in
               each such kernel: wgrad_mma_kernel must hold HGMMA and no
               HMMA in every library that launches it, every bf16 tile and
               delta kernel HGMMA, every bf16 kernel that runs the delta
               pass also HMMA (its narrow heads), no kernel that runs the
               tile alone HMMA, and no f32 one either; for every bf16
               kernel that runs the delta pass (delta_build) and every
               library's wgrad_mma_kernel (wgrad_build) its registers,
               spills, HGMMA and HMMA on one line, failing on a spill; for
               the bf16 spatial, directional, vanilla and proposal
               forwards' persistent frame (frame_build: spa_frame_kernel's
               three forms, dir_frame_kernel's two, vanilla_frame_kernel's
               two, prop_frame_kernel's two)
               the same, and their ptxas remarks of serialized wgmma,
               failing on a spill, on HMMA or without HGMMA
  3. kernels - each kernel against its plain PyTorch version, bf16 and f32,
               with timings and bounds: the eval forwards at the shapes of
               one default 4096-ray chunk, the training kernels at those of
               one default step (1024 rays: 131,072 fine and 65,536 coarse
               points); for the bf16 backwards, planted cast faults must
               read beyond the limit that the kernels meet; the backwards
               that rebuild their forward are held on their forward
               kernel's activations, the bf16 backwards against their
               plain chains with the delta products summed in f64, within
               BWD_ORDER_FACTOR of the plain f32 chain's own distance
               (order_reference); the vanilla forwards' order sensitivity
               at He's scale and at the checks' scale
               (kernel_order_sensitivity), and the bf16 backwards' and the
               density gradient's held the same way on three more draws
               (backward_order_sensitivity).  The Ref-NeRF
               forwards (ref_kernels) at one default chunk's 786,432 merged
               points, the directional one also with sRGB on and at IDE
               level 2; the Ref-NeRF training kernels at one default step's
               196,608 merged points, the directional backward also with
               sRGB on and at IDE level 2; the bf16 spatial frame's
               identities (spa_frame: each of ref_spa_fwd_res's 8 stored
               activations equal to ops.dense_layer of its stored inputs,
               ref_spa_fwd's heads and ref_spa_fwd_grad's outputs equal to
               ref_spa_fwd_res's, all bit for bit, at 1, 127, 129, 50,689,
               196,608 and 786,432 points and the widths 256/256, 48/80,
               512/512 and 600/600, each launch's body; then the widest
               H = O that runs the frame and that runs at all in each form,
               failing on a hole or short of the 64-row tile's 776 / 712 /
               616);
               the bf16 directional frame's (dir_frame: ref_dir_fwd's
               outputs equal to ref_dir_fwd_dissect's "full" stage, the
               64-row tile, and to ref_dir_fwd_res's, the stored
               activations h2 h3 h4 z6 z7 z8 equal to ops.dense_layer of
               their stored inputs, all bit for bit, rgb within TOLS of the
               plain version, at the same points and 256/256, 48/80,
               512/512, IDE levels 2 and 5, sRGB on and off, with and
               without noise, and at 704/704, where the 64-row tile runs;
               then the widest H = O that runs the frame and that runs at
               all at IDE levels 2, 4 and 5, failing on a hole); the bf16
               vanilla frame's (vanilla_frame: vanilla_mlp_fwd's outputs
               equal to vanilla_mlp_fwd_res's, its 9 stored activations to
               ops.dense_layer of their stored inputs, all bit for bit,
               rgb3 and sigma within TOLS of the plain version, each
               launch's body, at 1, 127, 129, 50,689, 131,072 and 524,288
               points and 256/256/128, 48/40/24, 64/64/32 and 512/512/256;
               then the widest H = B that runs the frame and that runs at
               all, failing on a hole or short of the 64-row tile's 760);
               the bf16 proposal frame's (prop_frame, run before
               vanilla_frame: prop_mlp_fwd's density equal to
               prop_mlp_fwd_res's, its stored h1 .. h4 to ops.dense_layer
               of their stored inputs, all bit for bit, the density within
               TOLS of the plain version, each launch's body, at 1, 127,
               129, 50,689, 65,536 and 262,144 points and H = 256, 48, 64
               and 512; then the widest H that runs the frame and that
               runs at all, failing on a hole or short of the 64-row
               tile's PROP_TILE_WIDEST)
  4. path    - `python -m nerf_tpu_torch -r -e -s -w` on a two-view 800x800
               Blender-layout test split with seeded random weights (full
               width vanilla model), counting kernel launches and each
               frame kernel's launches by the body it ran; then one f32
               frame through the kernels against the plain nn.Module path,
               and one warm bf16 frame timed and traced with torch.profiler,
               beside the same frame through the nn.Module route
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
               the same step with the proposal recompute pair, each
               proposal launch on the frame's two consumer warpgroups
               (prop_res_vs_recompute); step_memory (phase 10) measures
               its peak memory as a third form
 13. batch_scaling - nerf_tpu_torch.tools.batch_scaling's measure with 10
               steps a run: vanilla at 1024, 4096 and 16384 rays in three
               backward forms, Ref-NeRF at 1024 and 4096 in two, Mip-NeRF
               (--model mip) at 1024, 4096 and 16384 in its two; rays/s
               and peak device memory per row; the sweep's launches by
               body, each frame kernel on its two consumer warpgroups
 14. dissect - `python -m nerf_tpu_torch.tools.bench_ref_kernels --dissect
               --dissect_fwd` (N = 197,632, bf16 and f32): the directional
               forward's five stages and the backward's four modes timed
               and held against their plain versions, stage and mode
               "full" against the shipped kernels bit for bit, and the
               glue's derived costs
 15. wgrad   - the split-K weight-grad pass alone (ops.wgrad_reduce, bf16)
               at the job lists of one default step's backwards (vanilla,
               proposal in two chunks, Ref-NeRF spatial, the same as the
               recompute form walks it, directional), with the plain delta
               chains' deltas: against the plain version, two walks equal
               bit for bit, its time, the plain version's, torch.mm's as a
               yardstick and the bound, each job's staging path (TMA or
               the threads); the pass's ms per default step; the rounding
               gate: at the 256 x 256 trunk job and the 63 x 256 first-layer
               job on 131,072 seeded points in splits of 4096, the weight
               grad's relative error against the splits summed in f64 may
               be at most WGRAD_GATE_FACTOR times the in-order f32 sum's
 16. dense   - the layer tile alone (ops.dense_layer) at every layer shape
               of the main paths (inputs 63, 27, 167, 128 and 256 wide to
               128 or 256, the three skip layers) at an eval chunk's
               786,432 and a vanilla step's 131,072 rows, bf16: against the
               plain version within TOLS, its stored rows and mask bits and
               a second launch bit for bit, its time, the plain version's,
               torch.addmm's as a yardstick and the bound; the same shapes in
               f32 (the CUDA-core body); the card tests' narrow widths and
               ragged row counts, untimed; the rounding gate: at 256 -> 256
               and 167 + 256 -> 256 on 131,072 seeded rows, the share of
               the tile's bf16 outputs off the layer summed in f64 may be
               at most DENSE_GATE_FACTOR times the in-order f32 sum's
 17. delta   - the delta pass alone (ops.delta_layer) at every delta shape
               and form of the main paths (k_dim 0, 2, 3, 9, 128 and 256
               into 63, 128, 167 or 256 columns; masked by stored
               activations or bits, with the K = 1 sigma term, the ADD
               sums, f32 rows) at a vanilla step's 131,072 and a Ref-NeRF
               step's 196,608 rows, bf16: against the plain version within
               TOLS, its stored rows and a second launch bit for bit, its
               device time, the plain version's, torch.mm(a, W^T)'s as the
               product's yardstick (no mask) and the bound; the same
               shapes in f32 at 131,072 rows (the CUDA-core body); the card
               tests' narrow widths at 1, 70 and 4099 rows, untimed; then
               the occupancy line: every delta-pass kernel's launches,
               each library's wgrad_mma_kernel and the spatial frame's
               three forms (one block an SM) through the runtime's
               occupancy query
 18. mip     - true Mip-NeRF (-m) and the IPE mode (--use_ipe), which run
               the vanilla kernels on IPE features: the vanilla training
               kernels and the plain forward (the recompute form's) at a
               default step's coarse and fine pass (65,536 and 131,072
               points) and the eval forward at a default chunk's two
               passes (262,144 and 524,288), on IPE operands
               of camera rays, bf16 and f32, held as in phase 3 with the
               planted faults (mip_kernels); one f32 -m step, kernels vs
               nn.Module, two launches a step of each training kernel
               (mip_step); `-m --epochs 5 -s -w` vs `--no_pallas`
               (mip_train); `-m -r -e -s -w` of its checkpoint, one f32
               frame kernels vs nn.Module, one warm bf16 frame timed and
               traced (mip_path); its trainer loop timed and profiled
               (mip_train_profile); a 40-step `--use_ipe` run and its
               render (ipe_train, ipe_render_trained); the peak memory and
               ms a step of both forms (step_memory)
 19. ops_shell - the trainer's operations shell at the default full width,
               bf16, through the kernels: for vanilla, Ref-NeRF and -m, 6
               steps straight (twice) against 3 steps, a save through
               CheckpointManager, a load into fresh modules, optimizer and
               generator and 3 more, equal bit for bit, with the slot's MB
               and its save and load ms (resume_step); `python -m
               nerf_tpu_torch -s -w --epochs 5 --ckpt_dir D --max_save 2` in
               a subprocess, SIGTERM after the first epoch's line: exit
               143, the index's step and epoch, the seconds from the signal
               to the exit, then `-l` runs the remaining epochs with each
               kernel's launches a step times the steps (sigterm); `-r -e -s
               -w` from the run's .pt and, with those moved away, from the
               newest slot: equal frames (render_fallback); a `-b` run with
               no kernel launched and a planted NaN named by its module
               (debug); loop_ab.py's readings of the trainer's loop: the
               device's idle ms at each of three epoch boundaries with the
               one-epoch-deep read-back, and rays/s (epoch_gap)
 20. distributed - the distributed modes (ddp, ma): at world size 1 through
               the CLI under torchrun with NCCL, `python -m
               torch.distributed.run --standalone --nproc_per_node=1 -m
               nerf_tpu_torch.ddp_train` with the train phase's flags, `-m
               nerf_tpu_torch.model_average --ma_epoch 2` under each
               --ma_method and `ddp_train -t`, all started together, their
               final nets equal to phases 7's and 9's bit for bit
               (ddp_world1); two gloo ranks on cuda:0 (`python3
               chip_smoke.py --rank SPEC`, the card has one GPU and NCCL
               takes one rank a GPU): ddp on a 6-view split with SIGTERM to
               rank 1 alone after epoch 0, both ranks exit 143 after it and
               rank 0 writes one slot, whose -l resume (3 + 3 steps a rank)
               equals 6 straight bit for bit (ddp_sigterm); a 400x400 bf16
               frame sharded over both ranks equal to the single frame bit
               for bit (sharded_render); one ddp epoch equal to a
               one-process oracle (both ranks' backwards, (a + b) / 2, clip,
               Adam) bit for bit, --no_sync_prop parting the ranks in the
               proposal net only, the rays/s of a rank and its grad sync
               alone, traced and timed (ddp_two_ranks); ma over two
               replicas, each equal to w0 p0 + w1 p1 after the averaging,
               p2p unless gloo's TCP pair refuses CUDA memory, the one
               failure recorded and let pass (ma_two_ranks); in this
               process at world size 1 (NCCL), where no grads are synced:
               single and ddp trainers' loops in turns (ms a step, host
               issue, rays/s), one ddp epoch traced, a one-rank NCCL grad
               sync alone traced and timed, the averaging ms of each
               method (dist_readings)
 21. data_observability - the native image decoder on 100 seeded 800x800
               RGBA views whose rows cycle through the five PNG filters,
               loaded at img_scale 0.5 with -w: the split's seconds, one
               view's, four views against the built-in decoder within 1e-6
               and its seconds (data_load); `python -m nerf_tpu_torch -s -w
               --epochs 3 --trace DIR` on 20 of them: one Chrome trace of
               the second epoch whose kernel events name the device
               functions of vanilla_mlp_fwd_res, vanilla_mlp_bwd,
               prop_mlp_fwd and prop_mlp_bwd once a step or more (trace);
               the MFU of every epoch line and of the metrics log of that
               run and of phases 7, 8, 11 and 18's kernel routes against
               the formula (mfu); `-r -s -w --img_scale 0.125` of its
               checkpoint: 120 orbit frames of 100x100 and orbit.gif read
               block by block, 120 frames of 5 hundredths of a second,
               looped, its write timed (orbit_gif)
 22. the kernels line, then the last line {"ok": true, "device": {...}}

Every line carries ``elapsed_s``, the seconds since the script started.
Imports nothing of JAX or nerf_tpu.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch import native, ops, parallel
from nerf_tpu_torch.cli import render as render_mod
from nerf_tpu_torch.cli.entry import ddp_parser, ma_parser
from nerf_tpu_torch.cli.entry import main as entry_main
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.trainer import Trainer, epoch_indices
from nerf_tpu_torch.cli.flags import config_from_args, finalize_config
from nerf_tpu_torch.core import sampling
from nerf_tpu_torch.core.encoding import cat_pos_pe, ide_tables, ipe_feature
from nerf_tpu_torch.core.rays import (
    fov_to_focal, full_image_rays, pose_spherical,
)
from nerf_tpu_torch.ops import build, fused_mlp, ref_fused
from nerf_tpu_torch.ops import delta as delta_lib
from nerf_tpu_torch.ops import dense as dense_lib
from nerf_tpu_torch.ops import wgrad as wgrad_lib
from nerf_tpu_torch.ops.wgrad import grad_shapes
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.data import blender
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.train.step import (
    clip_by_global_norm_, compute_loss, make_optimizer, sample_train_rays,
    train_parameters, train_step,
)
from nerf_tpu_torch.train import schedule as schedule_lib
from nerf_tpu_torch.utils.checkpoint import (
    NETS, CheckpointManager, checkpoint_paths, load_checkpoint, save_models,
)
from nerf_tpu_torch.utils.debug import nan_attribution
from nerf_tpu_torch.utils.flops import H100_BF16_PEAK, train_step_flops
from nerf_tpu_torch.utils.metrics import MetricsWriter, read_scalars
from nerf_tpu_torch.utils.png import read_png, write_png

import loop_ab

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

LEGO_FOV = 0.6911112070083618       # lego's camera_angle_x
CHUNK = 4096                        # --eval_chunk default
N_COARSE, N_FINE = 64, 128          # sample defaults
N_MERGED = N_COARSE + N_FINE        # Ref-NeRF's merged samples per ray
RAYS = 1024                         # --sample_ray_num default
VIEW_HW = 800                       # the seeded views' size, lego's
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
# The vanilla forwards' check draws its matrices N(0, 1 / fan_in) as well.
# At He's scale the vanilla net's eight bf16 layers do what the spatial
# net's nine do: a one-ulp rounding difference in an early layer grows from
# layer to layer: the function itself in plain PyTorch, its sums taken in
# f32 and then in f64, parts beyond TOLS on most draws, and the tensor-core
# kernel from either by as much; at this scale they stay within TOLS
# (``order_sensitivity`` measures both every run; PERF.md has the readings).
# A layer on the CUDA cores in f32 summed as cuBLAS does, bit for bit, and
# so never showed it.
VANILLA_GAIN = 1.0
# The proposal frame's check (prop_frame) draws N(0, 1 / fan_in) as well.
# At He's scale its density parted from the plain version by 1.024 x TOLS
# at H = 64 on 50,689 points on an H100 80GB HBM3, while h1 .. h4 equalled
# ops.dense_layer of their stored inputs bit for bit: the four bf16 layers
# carry a one-ulp rounding difference as the vanilla net's do.  (The main
# path's check of prop_mlp_fwd, phase 3, keeps He's scale at H = 256.)
PROP_GAIN = 1.0
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
# A bf16 backward whose delta products run on the tensor cores sums them in
# another order than cuBLAS, and its chain rounds every delta to bf16: a
# delta one ulp apart moves each value of the next layer's row by about
# 1 / sqrt(K) of an ulp, so a few dozen of them round the other way, and
# down eight or nine layers any change of sum order decorrelates a row at
# the ulp level.  The plain chain parts from itself that way, its delta
# products summed in f64 instead of f32, by 4e-4 (vanilla) to 1.2e-3
# (Ref-NeRF spatial) at these shapes on an H100 80GB HBM3, beyond the two
# limits above (PERF.md; backward_order_sensitivity reads it every run).
# So a bf16 backward is held against its plain chain with the delta
# products summed in f64, within the larger of its grad limit and
# BWD_ORDER_FACTOR times the plain f32 chain's distance from that chain on
# the same operands: the kernel may be at most 25% less accurate than the
# plain version (it read 0.82-1.00 of it over four draws of each, on an
# H100 80GB HBM3), and every planted fault must read beyond that limit
# (1.7x it or more there).
BWD_ORDER_FACTOR = 1.25
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
# proposal loss, on its epoch of lowest mean) and 6.3e-3 (image MSE); a later
# run 3.0e-2 and 9.7e-4.  Mip-NeRF (-m) is held to the same band: 6.7e-4 or
# less on both through its fourth epoch, then 2.7e-2 (loss) and 2.8e-2
# (image MSE) on its fifth, the epoch in which both routes' image MSE rises
# (two runs, the same to every digit).  A trainer that stops learning reads
# above 1 on both.
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
        source="nerf_tpu_torch/ops/csrc/prop_frame.cuh",
        replaces="nerf_tpu/ops/fused_mlp.py:478"),
    "vanilla_mlp_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/vanilla_frame.cuh",
        replaces="nerf_tpu/ops/fused_mlp.py:128"),
    "vanilla_mlp_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/vanilla_frame.cuh",
        replaces="nerf_tpu/ops/fused_mlp.py:150"),
    "vanilla_mlp_bwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:163"),
    "prop_mlp_bwd": dict(
        source="nerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:493"),
    "ref_spa_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/spa_frame.cuh",
        replaces="nerf_tpu/ops/ref_fused.py:643"),
    "ref_dir_fwd": dict(
        source="nerf_tpu_torch/ops/csrc/dir_frame.cuh",
        replaces="nerf_tpu/ops/ref_fused.py:841"),
    "ref_spa_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/spa_frame.cuh",
        replaces="nerf_tpu/ops/ref_fused.py:643"),
    "ref_dir_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/dir_frame.cuh",
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
        source="nerf_tpu_torch/ops/csrc/spa_frame.cuh",
        replaces="nerf_tpu/ops/ref_fused.py:643"),
    "ref_spa_bwd_recompute": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused_recompute.cu",
        replaces="nerf_tpu/ops/ref_fused.py:701"),
    "ref_dir_bwd_recompute": dict(
        source="nerf_tpu_torch/ops/csrc/ref_fused_recompute.cu",
        replaces="nerf_tpu/ops/ref_fused.py:867"),
    "prop_mlp_fwd_res": dict(
        source="nerf_tpu_torch/ops/csrc/prop_frame.cuh",
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
    # the weight-grad pass of every backward above, on its own entry
    "wgrad_reduce": dict(
        source="nerf_tpu_torch/ops/csrc/wgrad.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:228"),
    # the layer tile of every forward above (and of the rebuilds), on its
    # own entry
    "dense_layer": dict(
        source="nerf_tpu_torch/ops/csrc/dense.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:58"),
    # the delta pass of every backward above (and of the density gradient),
    # on its own entry
    "delta_layer": dict(
        source="nerf_tpu_torch/ops/csrc/delta.cu",
        replaces="nerf_tpu/ops/fused_mlp.py:69"),
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
                          "prop_mlp_bwd_res"),
    # Mip-NeRF (-m): no proposal net, its one net run twice a step
    ("mip", True): ("vanilla_mlp_fwd_res", "vanilla_mlp_bwd"),
    ("mip", False): ("vanilla_mlp_fwd", "vanilla_mlp_bwd_recompute")}
# the vanilla kernels of the Mip-NeRF path at its shapes (mip_kernels): each
# training kernel at a default step's coarse and fine pass (1024 rays of 64
# and of 128 frustums), the plain forward there too (the recompute form's
# step runs it) and at a default eval chunk's two passes
MIP_KERNELS = (
    [(k, (RAYS, p)) for k in ("vanilla_mlp_fwd_res", "vanilla_mlp_bwd",
                              "vanilla_mlp_bwd_recompute", "vanilla_mlp_fwd")
     for p in (N_COARSE, N_FINE)]
    + [("vanilla_mlp_fwd", (CHUNK, p)) for p in (N_COARSE, N_FINE)])
# the least peak-memory saving of the recompute form at a default bf16
# Mip-NeRF step: the residual form holds 9 activations of both passes'
# 196,608 points, 196,608 x 2,176 in bf16 (0.86 GB)
MIP_MEMORY_SAVING = 0.6e9


def per_step(model: str, form=True) -> dict:
    """Launches of each kernel in one step of ``model`` in ``form``
    (STEP_KERNELS' keys): one each, two for Mip-NeRF's two passes."""
    return dict.fromkeys(STEP_KERNELS[(model, form)],
                         2 if model == "mip" else 1)
# steps of the memory and time phase: 20 back to back, median of 3 runs
MEMORY_STEPS, MEMORY_RUNS = 20, 3


def emit(phase: str, **kw):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


class Tee(io.TextIOBase):
    """A text stream that writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


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


def ipe_encodings(gen, dtype, n_rays, n_frustums):
    """The Mip-NeRF path's kernel operands for ``n_rays`` camera rays of a
    400x400 lego view (random pixels of three poses) with ``n_frustums``
    frustums each between jittered stratified edges in [2, 6]: enc_x =
    [mu, IPE] (rays x frustums, 63) at the 400x400 pixel radius, and the
    per-ray direction encoding broadcast (rays x frustums, 27), as
    ``pipeline._mip_pass`` builds them, cast to ``dtype``."""
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    per = -(-n_rays // 3)
    rays = torch.cat([full_image_rays(400, 400, torch.tensor(
        pose_spherical(az, -30.0, 4.0)[:3], device="cuda"), focal)[
            torch.randint(0, 400 * 400, (per,), generator=gen,
                          device="cuda")] for az in (0.0, 120.0, 240.0)])
    rays = rays[:n_rays]
    jitter = torch.rand((n_rays, n_frustums + 1), generator=gen,
                        device="cuda")
    edges = sampling.stratified_samples(n_rays, n_frustums + 1, 2.0, 6.0,
                                        jitter=jitter)
    feat, mu, _ = ipe_feature(edges, rays, 10,
                              2.0 / math.sqrt(12.0) / focal[0])
    n = n_rays * n_frustums
    x = torch.cat([mu, feat], dim=-1).reshape(n, 63).to(dtype).contiguous()
    d = rays[:, 3:] / torch.linalg.vector_norm(rays[:, 3:], dim=-1,
                                               keepdim=True)
    d = cat_pos_pe(d, 4)[:, None, :].expand(n_rays, n_frustums, 27)
    return x, d.reshape(n, 27).to(dtype).contiguous()


def centre_sigma(ws, x, d):
    """Shift the opacity head's bias ws[16] by the median raw sigma of the
    plain forward on (x, d), so that about half the points pass the
    density's ReLU downstream.  The IPE operands vary little next to a
    bias drawn N(0, 0.5^2) (the raw sigma's spread is about 0.16 at these
    weights), so without it a draw can leave every sigma on one side,
    which the forwards' check refuses as degenerate."""
    ws[16] = ws[16] - ops.vanilla_mlp_plain(ws, x, d)[1].median()


def vanilla_encodings(gen, dtype, n, ipe=None):
    """A vanilla kernel's (enc_x, enc_d): uniform in [-1, 1] at ``n``
    points, or with ``ipe`` = (rays, frustums) ``ipe_encodings``."""
    return _encodings(gen, dtype, n) if ipe is None else \
        ipe_encodings(gen, dtype, *ipe)


def kernel_case(name, dtype, gen, ide_level=4, use_srgb=False, ipe=None):
    """(arguments, kernel call, plain call, held call, bytes moved, FLOPs,
    points) of ``name`` at its main-path shapes; ``ide_level`` and
    ``use_srgb`` pick the case of ref_dir_fwd, ``ipe`` = (rays, frustums a
    ray) gives a vanilla kernel the Mip-NeRF path's encodings at that many
    points (``ipe_encodings``) instead of its own.  The held call is what the
    kernel's output is held against: the plain version, except for the
    backwards that rebuild their forward (the recompute backwards and
    prop_mlp_bwd), whose plain version runs on the forward kernel's
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
        ws = random_weights(shapes, gen, dtype, gain=VANILLA_GAIN)
        x, d = vanilla_encodings(gen, dtype, n, ipe)
        n = x.shape[0]
        if ipe is not None:
            centre_sigma(ws, x, d)
        args = (ws, x, d)
        kernel, plain = ops.vanilla_mlp_fwd, ops.vanilla_mlp_plain
        moved = _nbytes(x, d, *ws) + n * 4 * 4
        macs = macs_per_point(shapes)
    elif name == "vanilla_mlp_fwd_res":
        shapes, n = vanilla_shapes(), RAYS * N_FINE
        ws = random_weights(shapes, gen, dtype, gain=VANILLA_GAIN)
        x, d = vanilla_encodings(gen, dtype, n, ipe)
        n = x.shape[0]
        if ipe is not None:
            centre_sigma(ws, x, d)
        args = (ws, x, d)
        kernel, plain = ops.vanilla_mlp_fwd_res, ops.vanilla_mlp_fwd_res_plain
        elem = torch.empty((), dtype=dtype).element_size()
        moved = _nbytes(x, d, *ws) + n * 4 * 4 + n * 2176 * elem
        macs = macs_per_point(shapes)
    elif name == "vanilla_mlp_bwd":
        shapes, n = vanilla_shapes(), RAYS * N_FINE
        ws = random_weights(shapes, gen, dtype)
        x, d = vanilla_encodings(gen, dtype, n, ipe)
        n = x.shape[0]
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
        x, d = vanilla_encodings(gen, dtype, n, ipe)
        n = x.shape[0]
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
        acts = ops.prop_mlp_fwd_res(ws, x)[1]
        held = lambda *a: ops.prop_mlp_bwd_res_plain(*a, acts)  # noqa: E731
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


def compare_grads(name, dtype, got, want, lim=None):
    rels, lim = [], grad_rel(name, dtype) if lim is None else lim
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


def compare(name, dtype, got, want, args=(), lim=None):
    """Hold a kernel's outputs against the plain version's (a backward's
    grads within ``lim``, by default its grad limit); returns (max abs err
    of the outputs, worst relative Frobenius error of the grads or the
    stored activations, or None, and a dict of further readings)."""
    lim = grad_rel(name, dtype) if lim is None else lim
    if name in ("ref_dir_bwd", "ref_dir_bwd_recompute"):
        rel = dheads_rel(got[0], want[0])
        if not (torch.isfinite(got[0]).all() and rel <= lim):
            fail(f"{name} {dtype}: d(heads) relative error {rel} beyond "
                 f"{lim}")
        err, worst = compare_grads(name, dtype, got[1], want[1], lim)
        return max(err, float((got[0] - want[0]).abs().max())), \
            max(rel, worst), {"dheads_rel_err": rel}
    if name in ("prop_mlp_bwd", "prop_mlp_bwd_res"):
        return (*compare_grads(name, dtype, got, want, lim),
                prop_bwd_identities(name, dtype, got, args))
    if is_bwd(name):
        return (*compare_grads(name, dtype, got, want, lim), {})
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


ORDER_DRAWS = 6


def order_sensitivity(gen):
    """How far the bf16 vanilla forward parts from itself when only the
    order of its f32 sums changes, at He's scale (gain 2) and at
    VANILLA_GAIN, over ORDER_DRAWS draws of a default step's 131,072 points
    each: the plain version with its products summed in f32 against the
    same with them summed in f64 (each rounded to f32, then every layer to
    bf16 as before), and the kernel against both; for each pair the draws
    whose rgb and sigma are within TOLS and the largest abs error."""
    def f64_dense(a, w, b=None):
        out = torch.matmul(a.double(), w.double()).float()
        return out if b is None else out + b

    tol = TOLS[torch.bfloat16]
    out = {}
    for gain in (2.0, VANILLA_GAIN):
        parts = {"plain_f32_vs_f64": [], "kernel_vs_plain_f32": [],
                 "kernel_vs_plain_f64": []}
        for _ in range(ORDER_DRAWS):
            ws = random_weights(vanilla_shapes(), gen, torch.bfloat16,
                                gain=gain)
            x, d = _encodings(gen, torch.bfloat16, RAYS * N_FINE)
            kernel = ops.vanilla_mlp_fwd(ws, x, d)
            f32 = ops.vanilla_mlp_plain(ws, x, d)
            dense, fused_mlp._dense = fused_mlp._dense, f64_dense
            try:
                f64 = ops.vanilla_mlp_plain(ws, x, d)
            finally:
                fused_mlp._dense = dense
            for key, (a, b) in (("plain_f32_vs_f64", (f32, f64)),
                                ("kernel_vs_plain_f32", (kernel, f32)),
                                ("kernel_vs_plain_f64", (kernel, f64))):
                parts[key].append((
                    max(float((u - v).abs().max()) for u, v in zip(a, b)),
                    all(torch.allclose(u, v, **tol) for u, v in zip(a, b))))
        out[f"gain_{gain:g}"] = {
            key: dict(max_abs_err=max(e for e, _ in v),
                      draws_within_tols=sum(ok for _, ok in v),
                      draws=len(v)) for key, v in parts.items()}
    return out


def _dwt_f64(delta, w):
    """The plain backwards' delta product, delta @ w^T, summed in f64."""
    return (delta.double() @ w.double().T).float()


@contextlib.contextmanager
def f64_delta_products():
    """Within, the plain versions sum every delta product (fused_mlp._dwt,
    which ref_fused shares) in f64."""
    saved = fused_mlp._dwt, ref_fused._dwt
    fused_mlp._dwt = ref_fused._dwt = _dwt_f64
    try:
        yield
    finally:
        fused_mlp._dwt, ref_fused._dwt = saved


def _chain_rel(got, want):
    """The worst relative Frobenius error over a backward's grads, and over
    the column groups of d(heads) where it returns (d(heads), grads)."""
    if not torch.is_tensor(got[1]):
        return max(dheads_rel(got[0], want[0]),
                   *(_rel_err(a, b) for a, b in zip(got[1], want[1])))
    return max(_rel_err(a, b) for a, b in zip(got, want))


def order_reference(name, dtype, held, args, got, plain):
    """A bf16 backward's reference and limit (BWD_ORDER_FACTOR): ``held``'s
    chain with its delta products summed in f64, and the larger of the grad
    limit and BWD_ORDER_FACTOR times the distance of ``plain`` (the chain
    with f32 sums, as cuBLAS takes them) from it; with the readings of both
    distances, the kernel's ``got`` against ``plain`` beside them."""
    with f64_delta_products():
        want = held(*args)
    own = _chain_rel(plain, want)
    lim = max(grad_rel(name, dtype), BWD_ORDER_FACTOR * own)
    return want, lim, dict(plain_vs_plain_f64=own,
                           kernel_vs_plain_f32=_chain_rel(got, plain),
                           kernel_vs_plain_f64=_chain_rel(got, want))


# each bf16 backward that check_kernel holds, and the density gradient
ORDER_KERNELS = tuple(k for k in KERNELS if is_bwd(k)
                      and k not in DISSECT_KERNELS) + ("ref_spa_fwd_res",)
ORDER_SEEDS = (1, 2, 3)


def _density_target(ws, enc, pos, acts):
    """The plain normal target and |g| on the activations ``acts``."""
    g = ref_fused.density_grad_plain(ws, enc, pos, acts)
    return (ref_fused.normal_target(g),
            torch.linalg.vector_norm(g, dim=-1, keepdim=True))


def order_readings(seeds=ORDER_SEEDS):
    """Over the draws of ``seeds``, each from a generator of its own (so
    that the other checks draw their operands as they would without it),
    every bf16 backward of ORDER_KERNELS at its main-path shapes: the plain
    chain (f32 sums) against the same with its delta products summed in
    f64, the kernel against both, the kernel's distance over the plain
    chain's (``ratio``), the limit check_kernel holds it to, and whether
    it met it.  For ref_spa_fwd_res the same readings of the normal target
    (|g|-weighted, as target_check; ref_spa_fwd_grad's equals it bit for
    bit), held to DGRAD_REL."""
    bf16 = torch.bfloat16
    out = {}
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for name in ORDER_KERNELS:
            args, kernel, _, held = kernel_case(name, bf16, gen)[:4]
            got = kernel(*args)
            if name == "ref_spa_fwd_res":
                t32, _ = _density_target(*args, got[-1])
                with f64_delta_products():
                    t64, g = _density_target(*args, got[-1])
                r = dict(plain_vs_plain_f64=_rel_err(t32 * g, t64 * g),
                         kernel_vs_plain_f32=_rel_err(got[1] * g, t32 * g),
                         kernel_vs_plain_f64=_rel_err(got[1] * g, t64 * g))
                lim = DGRAD_REL[bf16]
            else:
                _, lim, r = order_reference(name, bf16, held, args, got,
                                            held(*args))
            r.update(seed=seed, limit=lim,
                     ratio=r["kernel_vs_plain_f64"]
                     / max(r["plain_vs_plain_f64"], 1e-30),
                     met=r["kernel_vs_plain_f64"] <= lim)
            out.setdefault(name, []).append(r)
            del args, got
            torch.cuda.empty_cache()
    return out


def backward_order_sensitivity():
    """order_readings over ORDER_SEEDS; each bf16 backward must meet the
    limit check_kernel holds it to on every draw."""
    out = order_readings(ORDER_SEEDS)
    for name, rs in out.items():
        for r in rs:
            if not r["met"]:
                fail(f"{name} bf16, seed {r['seed']}: {r}")
    return dict(seeds=list(ORDER_SEEDS), factor=BWD_ORDER_FACTOR,
                max_ratio={k: max(r["ratio"] for r in v)
                           for k, v in out.items()}, draws=out)


def check_kernel(name, dtype, gen, timed=True, **case):
    """Hold ``name`` against its plain version at its main-path shapes (the
    ``case`` of ref_dir_fwd), a bf16 backward against its plain chain with
    the delta products summed in f64 (order_reference); with ``timed`` also
    time both."""
    args, kernel, plain, held, moved, flops, n = kernel_case(name, dtype,
                                                             gen, **case)
    got = kernel(*args)
    want = held(*args)
    lim, readings = grad_rel(name, dtype), {}
    if is_bwd(name) and dtype == torch.bfloat16:
        want, lim, readings = order_reference(name, dtype, held, args, got,
                                              want)
    torch.cuda.synchronize()
    err, rel, more = compare(name, dtype, got, want, args, lim)
    readings.update(more)
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
        if min(controls.values()) <= lim:
            fail(f"{name}: a planted cast fault reads {controls}, within "
                 f"the limit {lim}: the limit cannot tell it")
    del got, want
    rel_key = "act_rel_err" if name.endswith("_res") else "grad_rel_err"
    tol = (lim if is_bwd(name) else
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


# The persistent frame of the bf16 spatial forwards (csrc/spa_frame.cuh):
# the point counts at its edges (one point; one short of a 128-point tile
# and one past it; more tiles than three for each block of an H100's 132,
# so that every block walks at least three) and of the main paths (a
# default step's merged points and an eval chunk's, at 256 wide only), at
# the card tests' two width pairs (H, O), at 512 wide, where every form
# runs one consumer warpgroup on 64-point tiles and the training forms
# read the narrow heads' weights from device memory, and at 600 wide,
# above the training forms' fit, where their launchers run the 64-row
# tile; each with the frame's consumer warpgroups that the eval, res and
# grad launches must report (0: the 64-row tile; ref_fused.spa_body_name).
FRAME_NS = (1, 127, 129, 50_689, RAYS * N_MERGED, CHUNK * N_MERGED)
FRAME_WIDTHS = {(256, 256): (2, 2, 2), (48, 80): (2, 2, 2),
                (512, 512): (1, 1, 1), (600, 600): (1, 0, 0)}


def frame_identities(ws, x, pos):
    """The frame's identities on one case: each of ref_spa_fwd_res's 8
    stored activations against ops.dense_layer (the layer tile alone, on
    the 64-row frame) of its stored inputs (z5 through the two-operand
    form), ref_spa_fwd's heads and ref_spa_fwd_grad's heads and normal
    target against ref_spa_fwd_res's, each equal bit for bit or not; the
    heads' distance from the plain version's (tols_ratio, TOLS); the body
    that each launch reported (ops.BODIES)."""
    (heads, dgrad, acts), body_res = body_of(
        "ref_spa_fwd_res", lambda: ops.ref_spa_fwd_res(ws, x, pos))
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6, w7,
     b7) = ws[:17]
    inputs = [(x, w0, b0), (acts[0], w1, b1), (acts[1], w2, b2),
              (acts[2], w3, b3), (x, w4a, b4, acts[3], w4b),
              (acts[4], w5, b5), (acts[5], w6, b6), (acts[6], w7, b7)]
    layers = [bool(torch.equal(a, ops.dense_layer(*op)[0]))
              for a, op in zip(acts, inputs)]
    (g_heads, g_dgrad), body_grad = body_of(
        "ref_spa_fwd_grad", lambda: ops.ref_spa_fwd_grad(ws, x, pos))
    fwd, body = body_of("ref_spa_fwd", lambda: ops.ref_spa_fwd(ws, x))
    return dict(
        body=body, body_res=body_res, body_grad=body_grad,
        layers_equal_dense_layer=layers,
        fwd_heads_equal_res=bool(torch.equal(fwd, heads)),
        grad_equals_res=bool(torch.equal(g_heads, heads)
                             and torch.equal(g_dgrad, dgrad)),
        finite=bool(torch.isfinite(heads).all()
                    and torch.isfinite(dgrad).all()),
        heads_vs_plain=tols_ratio(heads, ops.ref_spa_plain(ws, x),
                                  TOLS[x.dtype]))


def tols_ratio(got, want, tol):
    """max |got - want| / (atol + rtol |want|): allclose holds where it is
    at most 1."""
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"]
                                        * want.abs())).max())


def frame_checks():
    """frame_identities at FRAME_NS x FRAME_WIDTHS on seeded bf16 operands
    (its own generator); fails where an identity does not hold, a value is
    not finite, the heads part from the plain version beyond TOLS or a
    launch ran another body than its width's (FRAME_WIDTHS); then the
    width scan (spa_frame_widths).  Its launches are not the main path's."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = []
    for (h, o), cons in FRAME_WIDTHS.items():
        ws = random_weights(ref_spa_shapes(h=h, o=o), gen, bf16,
                            gain=REF_GAIN)
        for n in FRAME_NS:
            if n > RAYS * N_MERGED and (h, o) != (256, 256):
                continue
            pos, x = ref_points(gen, bf16, n)
            r = dict(h=h, o=o, n=n, **frame_identities(ws, x, pos))
            cases.append(r)
            name = ref_fused.spa_body_name
            if not (all(r["layers_equal_dense_layer"])
                    and r["fwd_heads_equal_res"] and r["grad_equals_res"]
                    and r["finite"]
                    and r["heads_vs_plain"] <= 1.0
                    and r["body"] == name(cons[0], "eval")
                    and r["body_res"] == name(cons[1], "res")
                    and r["body_grad"] == name(cons[2], "grad")):
                fail(f"the bf16 spatial frame fails an identity: {r}")
            del pos, x
            torch.cuda.empty_cache()
    return dict(cases=cases, all_equal=True, widths=spa_frame_widths())


# the width scan of the spa_frame phase: H = O from 504 to 776 in steps of
# 8, 300 points each (the frame's widest fit in each form and the 64-row
# tile's lie between), and the widest that the 64-row tile ran in each
# form before the frame took the bf16 spatial forwards (ROADMAP B.6, C.2),
# which each form must reach again
SPA_WIDTH_SCAN = range(504, 784, 8)
SPA_TILE_WIDEST = {"eval": 776, "res": 712, "grad": 616}


def spa_frame_widths():
    """For each form of the bf16 spatial forward, the widest H = O of
    SPA_WIDTH_SCAN that runs the frame and the widest that runs at all
    (the 64-row tile above the frame's fit), each launch's heads within
    TOLS of the plain version's; fails where a width below one that runs
    raises, where the frame is chosen above a width that took the 64-row
    tile, where the widest that runs is short of SPA_TILE_WIDEST, or where
    the heads part from the plain version."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(22)
    calls = {"eval": ("ref_spa_fwd", lambda ws, x, pos: ops.ref_spa_fwd(
        ws, x)), "res": ("ref_spa_fwd_res", lambda ws, x, pos:
                         ops.ref_spa_fwd_res(ws, x, pos)[0]),
        "grad": ("ref_spa_fwd_grad", lambda ws, x, pos:
                 ops.ref_spa_fwd_grad(ws, x, pos)[0])}
    out = {}
    for form, (name, call) in calls.items():
        bodies, worst = [], 0.0
        for w in SPA_WIDTH_SCAN:
            ws = random_weights(ref_spa_shapes(h=w, o=w), gen, bf16,
                                gain=REF_GAIN)
            pos, x = ref_points(gen, bf16, 300)
            try:
                heads, body = body_of(name, lambda: call(ws, x, pos))
                torch.cuda.synchronize()
            except RuntimeError:
                bodies.append(None)
                continue
            bodies.append(body)
            worst = max(worst, tols_ratio(heads, ops.ref_spa_plain(ws, x),
                                          TOLS[bf16]))
            del ws, pos, x, heads
        runs = [w for w, b in zip(SPA_WIDTH_SCAN, bodies) if b]
        frame = [w for w, b in zip(SPA_WIDTH_SCAN, bodies)
                 if b and b.startswith("spa_frame_kernel")]
        out[form] = dict(frame_to=max(frame, default=None),
                         runs_to=max(runs, default=None),
                         heads_vs_plain=worst)
        if (runs != list(SPA_WIDTH_SCAN)[:len(runs)]
                or frame != runs[:len(frame)]
                or max(runs, default=0) < SPA_TILE_WIDEST[form]
                or worst > 1.0):
            fail(f"the spatial forwards' widths ({form}): "
                 f"{dict(zip(SPA_WIDTH_SCAN, bodies))}, heads vs plain "
                 f"{worst}, widest before the frame "
                 f"{SPA_TILE_WIDEST[form]}")
    return out


# The bf16 directional forwards on the frame (csrc/dir_frame.cuh): FRAME_NS
# (the main paths' two at 256 wide, N_MERGED points a ray, so that a ray's
# points cross tiles; the others with a few points a ray, DIR_FRAME_PER_RAY),
# at the card tests' two width pairs, at 512 wide (one consumer warpgroup
# on 64-point tiles) and at a width above the frame's fit, where the
# launcher runs the 64-row tile (DIR_FRAME_WIDE); the IDE levels, sRGB and
# the noise cycle through DIR_FRAME_GLUE, the main paths' cases at the
# default level 4, the render's without noise and the step's with.  Each
# width with the frame's consumer warpgroups that its launches must report
# (0: the 64-row tile; ref_fused.dir_body_name).
DIR_FRAME_WIDTHS = {(256, 256): 2, (48, 80): 2, (512, 512): 1}
DIR_FRAME_WIDE = (704, 704)
DIR_FRAME_PER_RAY = {1: 1, 127: 127, 129: 3, 50_689: 173}
# (IDE level, sRGB, noise)
DIR_FRAME_GLUE = ((2, False, True), (5, True, False), (5, False, True),
                  (2, True, False))


def dir_frame_cases():
    """(h, o, n, points a ray, IDE level, sRGB, noise) of the dir_frame
    phase, the wide case last (at level 2, within the 64-row tile's
    widths)."""
    cases = []
    for h, o in DIR_FRAME_WIDTHS:
        for n in FRAME_NS:
            if n >= RAYS * N_MERGED:
                if (h, o) == (256, 256):
                    cases.append((h, o, n, N_MERGED, 4, False,
                                  n == RAYS * N_MERGED))
                continue
            glue = DIR_FRAME_GLUE[len(cases) % len(DIR_FRAME_GLUE)]
            cases.append((h, o, n, DIR_FRAME_PER_RAY[n], *glue))
    return cases + [(*DIR_FRAME_WIDE, 50_689, 173, 2, False, True)]


def body_of(name: str, call):
    """(what ``call`` returns, the body that its one launch of kernel
    ``name`` reported, ops.BODIES)."""
    before = dict(ops.BODIES.get(name, {}))
    out = call()
    ran = [b for b, c in ops.BODIES.get(name, {}).items()
           if c != before.get(b, 0)]
    if len(ran) != 1:
        fail(f"one call of {name} counted the bodies {ran}")
    return out, ran[0]


def dir_frame_identities(ws, heads, dirs, per_ray, noise, level, srgb):
    """The directional frame's identities on one case: ref_dir_fwd's rgb,
    normal and density equal to ref_dir_fwd_dissect's "full" stage (the
    64-row tile, whose sRGB is off: its rgb is held where sRGB is off) and
    to ref_dir_fwd_res's, bit for bit; the stored activations h2, h3, h4,
    z6, z7 and z8 equal to ops.dense_layer of their stored inputs; every
    output finite; rgb's distance from the plain version's (tols_ratio,
    TOLS); the body that each launch reported (ops.BODIES)."""
    args = (ws, heads, dirs, per_ray, noise, level, srgb)
    fwd, body = body_of("ref_dir_fwd", lambda: ops.ref_dir_fwd(*args))
    res, body_res = body_of("ref_dir_fwd_res",
                            lambda: ops.ref_dir_fwd_res(*args))
    full = ops.ref_dir_fwd_dissect(ws, heads, dirs, per_ray, "full",
                                   noise=noise, ide_level=level)
    acts = res[3]
    inputs = [(acts[i - 1], ws[2 * i], ws[2 * i + 1]) for i in (1, 2, 3)] \
        + [(acts[i - 1], ws[2 * i + 1], ws[2 * i + 2]) for i in (5, 6, 7)]
    return dict(
        body=body, body_res=body_res,
        equal_dissect_full=[bool(torch.equal(fwd[i], full[i]))
                            for i in ((1, 2) if srgb else (0, 1, 2))],
        fwd_equal_res=[bool(torch.equal(fwd[i], res[i])) for i in range(3)],
        layers_equal_dense_layer=[
            bool(torch.equal(acts[i], ops.dense_layer(*op)[0]))
            for i, op in zip((1, 2, 3, 5, 6, 7), inputs)],
        finite=bool(all(torch.isfinite(t).all()
                        for t in list(fwd) + list(acts))),
        rgb_vs_plain=tols_ratio(fwd[0], ops.ref_dir_plain(*args)[0],
                                TOLS[ws[0].dtype]))


# the width scan of the dir_frame phase: H = O from 600 to 752 in steps of
# 8 (the frame's widest fit and the 64-row tile's lie between) at three IDE
# levels, 300 points each
DIR_WIDTH_SCAN = range(600, 760, 8)
DIR_WIDTH_LEVELS = (2, 4, 5)


def dir_frame_widths():
    """For each IDE level of DIR_WIDTH_LEVELS and each form, the widest
    H = O of DIR_WIDTH_SCAN whose bf16 directional forward runs the frame
    and the widest that runs at all (the 64-row tile above the frame's
    fit); fails where a width below one that runs raises, or where the
    frame is chosen above a width that took the 64-row tile."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for level in DIR_WIDTH_LEVELS:
        n_ch = ide_tables(level)["n_ch"]
        for res in (False, True):
            bodies = []
            for w in DIR_WIDTH_SCAN:
                ws = random_weights(ref_dir_shapes(n_ch, h=w, o=w), gen,
                                    bf16, gain=REF_GAIN)
                heads = torch.randn((300, ref_fused.HEAD_FIXED + 128),
                                    generator=gen, device="cuda")
                fn = ops.ref_dir_fwd_res if res else ops.ref_dir_fwd
                try:
                    bodies.append(body_of(
                        "ref_dir_fwd_res" if res else "ref_dir_fwd",
                        lambda: fn(ws, heads, camera_dirs(gen, 300), 1,
                                   None, level))[1])
                    torch.cuda.synchronize()
                except RuntimeError:
                    bodies.append(None)
                del ws, heads
            runs = [w for w, b in zip(DIR_WIDTH_SCAN, bodies) if b]
            frame = [w for w, b in zip(DIR_WIDTH_SCAN, bodies)
                     if b and b.startswith("dir_frame_kernel")]
            key = f"level {level} {'res' if res else 'eval'}"
            out[key] = dict(frame_to=max(frame, default=None),
                            runs_to=max(runs, default=None))
            if (runs and runs != list(DIR_WIDTH_SCAN)[:len(runs)]) \
                    or (frame and frame != runs[:len(frame)]):
                fail(f"the directional forwards' widths have a hole "
                     f"({key}): {dict(zip(DIR_WIDTH_SCAN, bodies))}")
    return out


def dir_frame_checks():
    """dir_frame_identities on seeded bf16 operands (its own generator) at
    each of dir_frame_cases; fails where an identity does not hold, a value
    is not finite, rgb parts from the plain version beyond TOLS, or a
    launch ran another body than its width's (DIR_FRAME_WIDTHS; the wide
    case the 64-row tile); then the width scan (dir_frame_widths).  Its
    launches are not the main path's."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = []
    for h, o, n, per_ray, level, srgb, noisy in dir_frame_cases():
        n_ch = ide_tables(level)["n_ch"]
        ws = random_weights(ref_dir_shapes(n_ch, h=h, o=o), gen, bf16,
                            gain=REF_GAIN)
        heads = torch.randn((n, ref_fused.HEAD_FIXED + 128), generator=gen,
                            device="cuda")
        dirs = camera_dirs(gen, n // per_ray)
        noise = ((0.02 * torch.randn((n, 128), generator=gen,
                                     device="cuda")).to(bf16)
                 if noisy else None)
        r = dict(h=h, o=o, n=n, per_ray=per_ray, ide_level=level, srgb=srgb,
                 noise=noisy, **dir_frame_identities(
                     ws, heads, dirs, per_ray, noise, level, srgb))
        cases.append(r)
        cons = DIR_FRAME_WIDTHS.get((h, o), 0)
        if not (all(r["equal_dissect_full"]) and all(r["fwd_equal_res"])
                and all(r["layers_equal_dense_layer"]) and r["finite"]
                and r["rgb_vs_plain"] <= 1.0
                and r["body"] == ref_fused.dir_body_name(cons, False)
                and r["body_res"] == ref_fused.dir_body_name(cons, True)):
            fail(f"the bf16 directional frame fails an identity: {r}")
        del ws, heads, dirs, noise
        torch.cuda.empty_cache()
    return dict(cases=cases, all_equal=True, widths=dir_frame_widths())


# The bf16 vanilla forwards on the frame (csrc/vanilla_frame.cuh): the
# frame's edge counts of FRAME_NS and the main paths' (a default step's
# 131,072 fine points, an eval chunk's 524,288; at the model's widths only)
# at the model's widths (H, B, R) = (256, 256, 128), the card tests' (48,
# 40, 24) and (64, 64, 32), and at 512 wide, where the frame runs one
# consumer warpgroup on 64-point tiles; each with the frame's consumer
# warpgroups that its launches must report (fused_mlp.vanilla_body_name)
VANILLA_FRAME_NS = (1, 127, 129, 50_689, RAYS * N_FINE, CHUNK * N_FINE)
VANILLA_FRAME_WIDTHS = {(256, 256, 128): 2, (48, 40, 24): 2,
                        (64, 64, 32): 2, (512, 512, 256): 1}


def vanilla_frame_identities(ws, x, d):
    """The vanilla frame's identities on one case: vanilla_mlp_fwd's rgb3
    and sigma equal to vanilla_mlp_fwd_res's, bit for bit; each of the 9
    stored activations equal to ops.dense_layer of its stored inputs (z5
    and r1 through the two-operand form, bvec without the ReLU); every
    output finite; rgb3's and sigma's distance from the plain version's
    (tols_ratio, TOLS); the body that each launch reported (ops.BODIES)."""
    fwd, body = body_of("vanilla_mlp_fwd",
                        lambda: ops.vanilla_mlp_fwd(ws, x, d))
    (rgb3, sigma, acts), body_res = body_of(
        "vanilla_mlp_fwd_res", lambda: ops.vanilla_mlp_fwd_res(ws, x, d))
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6, _, _, wb,
     bb, wr1a, wr1b, br1) = ws[:22]
    inputs = [(x, w0, b0), (acts[0], w1, b1), (acts[1], w2, b2),
              (acts[2], w3, b3), (x, w4a, b4, acts[3], w4b),
              (acts[4], w5, b5), (acts[5], w6, b6), (acts[6], wb, bb),
              (acts[7], wr1a, br1, d, wr1b)]
    plain = ops.vanilla_mlp_plain(ws, x, d)
    return dict(
        body=body, body_res=body_res,
        fwd_equal_res=[bool(torch.equal(fwd[0], rgb3)),
                       bool(torch.equal(fwd[1], sigma))],
        layers_equal_dense_layer=[
            bool(torch.equal(a, ops.dense_layer(*op, relu=i != 7)[0]))
            for i, (a, op) in enumerate(zip(acts, inputs))],
        finite=bool(all(torch.isfinite(t).all()
                        for t in list(fwd) + list(acts))),
        rgb_vs_plain=tols_ratio(fwd[0], plain[0], TOLS[x.dtype]),
        sigma_vs_plain=tols_ratio(fwd[1], plain[1], TOLS[x.dtype]))


# the width scan of the vanilla_frame phase: H = B from 400 to 768 in steps
# of 8 and R = B / 2 rounded down to 8, 300 points each (the frame's widest
# fit, 688 on an H100, and the 64-row tile's lie between), and the widest
# that the 64-row tile ran before the frame took the bf16 vanilla forwards,
# which both forms must reach again
VANILLA_WIDTH_SCAN = range(400, 776, 8)
VANILLA_TILE_WIDEST = 760


def vanilla_frame_widths():
    """For each vanilla form, the widest H = B of VANILLA_WIDTH_SCAN that
    runs the frame and the widest that runs at all (the 64-row tile above
    the frame's fit), each launch's rgb3 and sigma within TOLS of the plain
    version's; fails where a width below one that runs raises, where the
    frame is chosen above a width that took the 64-row tile, where the
    widest that runs is short of VANILLA_TILE_WIDEST, or where the outputs
    part from the plain version."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for res in (False, True):
        name = "vanilla_mlp_fwd_res" if res else "vanilla_mlp_fwd"
        fn = getattr(ops, name)
        bodies, worst = [], 0.0
        for w in VANILLA_WIDTH_SCAN:
            ws = random_weights(vanilla_shapes(h=w, bn=w, r=w // 16 * 8),
                                gen, bf16, gain=VANILLA_GAIN)
            x, d = vanilla_encodings(gen, bf16, 300)
            try:
                got, body = body_of(name, lambda: fn(ws, x, d))
                torch.cuda.synchronize()
            except RuntimeError:
                bodies.append(None)
                continue
            bodies.append(body)
            plain = ops.vanilla_mlp_plain(ws, x, d)
            worst = max(worst, *(tols_ratio(g, p, TOLS[bf16])
                                 for g, p in zip(got[:2], plain)))
            del ws, x, d, got, plain
        runs = [w for w, b in zip(VANILLA_WIDTH_SCAN, bodies) if b]
        frame = [w for w, b in zip(VANILLA_WIDTH_SCAN, bodies)
                 if b and b.startswith("vanilla_frame_kernel")]
        key = "res" if res else "eval"
        out[key] = dict(frame_to=max(frame, default=None),
                        runs_to=max(runs, default=None),
                        outputs_vs_plain=worst)
        if (runs != list(VANILLA_WIDTH_SCAN)[:len(runs)]
                or frame != runs[:len(frame)]
                or max(runs, default=0) < VANILLA_TILE_WIDEST
                or worst > 1.0):
            fail(f"the vanilla forwards' widths ({key}): "
                 f"{dict(zip(VANILLA_WIDTH_SCAN, bodies))}, outputs vs "
                 f"plain {worst}, widest before the frame "
                 f"{VANILLA_TILE_WIDEST}")
    return out


def vanilla_frame_checks():
    """vanilla_frame_identities on seeded bf16 operands (its own generator)
    at VANILLA_FRAME_NS x VANILLA_FRAME_WIDTHS; fails where an identity
    does not hold, a value is not finite, rgb3 or sigma part from the plain
    version beyond TOLS, or a launch ran another body than its width's;
    then the width scan (vanilla_frame_widths).  Its launches are not the
    main path's."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(24)
    cases = []
    t0 = time.perf_counter()
    for (h, bn, r), cons in VANILLA_FRAME_WIDTHS.items():
        ws = random_weights(vanilla_shapes(h=h, bn=bn, r=r), gen, bf16,
                            gain=VANILLA_GAIN)
        for n in VANILLA_FRAME_NS:
            if n > FRAME_NS[3] and (h, bn, r) != (256, 256, 128):
                continue
            x, d = vanilla_encodings(gen, bf16, n)
            c = dict(h=h, bn=bn, r=r, n=n,
                     **vanilla_frame_identities(ws, x, d))
            cases.append(c)
            name = fused_mlp.vanilla_body_name
            if not (all(c["fwd_equal_res"])
                    and all(c["layers_equal_dense_layer"]) and c["finite"]
                    and c["rgb_vs_plain"] <= 1.0
                    and c["sigma_vs_plain"] <= 1.0
                    and c["body"] == name(cons, False)
                    and c["body_res"] == name(cons, True)):
                fail(f"the bf16 vanilla frame fails an identity: {c}")
            del x, d
            torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0
    return dict(cases=cases, all_equal=True, seconds=checks_s,
                widths=vanilla_frame_widths())


# The bf16 proposal forwards on the frame (csrc/prop_frame.cuh): the
# frame's edge counts of FRAME_NS and the main paths' (a default step's
# 65,536 coarse points, an eval chunk's 262,144; at the model's width only)
# at the model's width H = 256, the card tests' 48 and 64, and at 512 wide,
# where the frame runs one consumer warpgroup on 64-point tiles; each with
# the frame's consumer warpgroups that its launches must report
# (fused_mlp.prop_body_name)
PROP_FRAME_NS = (1, 127, 129, 50_689, RAYS * N_COARSE, CHUNK * N_COARSE)
PROP_FRAME_WIDTHS = {256: 2, 48: 2, 64: 2, 512: 1}


def prop_frame_identities(ws, x):
    """The proposal frame's identities on one case: prop_mlp_fwd's density
    equal to prop_mlp_fwd_res's, bit for bit; each of h1 .. h4 equal to
    ops.dense_layer of its stored input (h1 of enc); every output finite;
    the density's distance from the plain version's (tols_ratio, TOLS); the
    body that each launch reported (ops.BODIES)."""
    density, body = body_of("prop_mlp_fwd",
                            lambda: ops.prop_mlp_fwd(ws, x))
    (dres, acts), body_res = body_of("prop_mlp_fwd_res",
                                     lambda: ops.prop_mlp_fwd_res(ws, x))
    inputs = [x] + list(acts[:3])
    return dict(
        body=body, body_res=body_res,
        fwd_equal_res=bool(torch.equal(density, dres)),
        layers_equal_dense_layer=[
            bool(torch.equal(a, ops.dense_layer(a_in, ws[2 * i],
                                                ws[2 * i + 1])[0]))
            for i, (a, a_in) in enumerate(zip(acts, inputs))],
        finite=bool(all(torch.isfinite(t).all()
                        for t in [density] + list(acts))),
        density_vs_plain=tols_ratio(density, ops.prop_mlp_plain(ws, x),
                                    TOLS[x.dtype]))


# the width scan of the prop_frame phase: H from 640 to 792 in steps of 8,
# 300 points each (the frame's widest fit and the 64-row tile's lie
# between), and the widest that the 64-row tile ran in both bf16 forms
# before the frame took them, which both forms must reach again
PROP_WIDTH_SCAN = range(640, 800, 8)
PROP_TILE_WIDEST = 776


def prop_frame_widths():
    """For each proposal form, the widest H of PROP_WIDTH_SCAN that runs the
    frame and the widest that runs at all (the 64-row tile above the
    frame's fit), each launch's density within TOLS of the plain version's;
    fails where a width below one that runs raises, where the frame is
    chosen above a width that took the 64-row tile, where the widest that
    runs is short of PROP_TILE_WIDEST, or where the density parts from the
    plain version."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for res in (False, True):
        name = "prop_mlp_fwd_res" if res else "prop_mlp_fwd"
        fn = getattr(ops, name)
        bodies, worst = [], 0.0
        for w in PROP_WIDTH_SCAN:
            ws = random_weights(prop_shapes(h=w), gen, bf16, gain=PROP_GAIN)
            x, _ = _encodings(gen, bf16, 300, dd=False)
            try:
                got, body = body_of(name, lambda: fn(ws, x))
                torch.cuda.synchronize()
            except RuntimeError:
                bodies.append(None)
                continue
            bodies.append(body)
            density = got[0] if res else got
            worst = max(worst, tols_ratio(density, ops.prop_mlp_plain(ws, x),
                                          TOLS[bf16]))
            del ws, x, got, density
        runs = [w for w, b in zip(PROP_WIDTH_SCAN, bodies) if b]
        frame = [w for w, b in zip(PROP_WIDTH_SCAN, bodies)
                 if b and b.startswith("prop_frame_kernel")]
        key = "res" if res else "eval"
        out[key] = dict(frame_to=max(frame, default=None),
                        runs_to=max(runs, default=None),
                        density_vs_plain=worst)
        if (runs != list(PROP_WIDTH_SCAN)[:len(runs)]
                or frame != runs[:len(frame)]
                or max(runs, default=0) < PROP_TILE_WIDEST
                or worst > 1.0):
            fail(f"the proposal forwards' widths ({key}): "
                 f"{dict(zip(PROP_WIDTH_SCAN, bodies))}, density vs plain "
                 f"{worst}, widest before the frame {PROP_TILE_WIDEST}")
    return out


def prop_frame_checks():
    """prop_frame_identities on seeded bf16 operands (its own generator) at
    PROP_FRAME_NS x PROP_FRAME_WIDTHS; fails where an identity does not
    hold, a value is not finite, the density parts from the plain version
    beyond TOLS, or a launch ran another body than its width's; then the
    width scan (prop_frame_widths).  Its launches are not the main
    path's."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(26)
    cases = []
    t0 = time.perf_counter()
    for h, cons in PROP_FRAME_WIDTHS.items():
        ws = random_weights(prop_shapes(h=h), gen, bf16, gain=PROP_GAIN)
        for n in PROP_FRAME_NS:
            if n > FRAME_NS[3] and h != 256:
                continue
            x, _ = _encodings(gen, bf16, n, dd=False)
            c = dict(h=h, n=n, **prop_frame_identities(ws, x))
            cases.append(c)
            name = fused_mlp.prop_body_name
            if not (c["fwd_equal_res"] and all(c["layers_equal_dense_layer"])
                    and c["finite"] and c["density_vs_plain"] <= 1.0
                    and c["body"] == name(cons, False)
                    and c["body_res"] == name(cons, True)):
                fail(f"the bf16 proposal frame fails an identity: {c}")
            del x
            torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0
    return dict(cases=cases, all_equal=True, seconds=checks_s,
                widths=prop_frame_widths())


# The bf16 spatial backwards' delta passes on the frame
# (csrc/spa_bwd_frame.cuh): the frame's edge counts of FRAME_NS and a
# default step's merged points, and for the recompute form a ragged last
# chunk (three whole chunks of fused_mlp.chunk_rows(TILE_ROWS) points and
# 129 more), at FRAME_WIDTHS' width pairs; each with the frame's consumer
# warpgroups that the residual and recompute launches must report (0: the
# 64-row tile; ref_fused.spa_bwd_body_name): two at 256 and 48/80 wide,
# one in both forms at 320 wide and in the recompute form at 512 wide, the
# 64-row tile above the residual form's fit and at 600 wide
SPA_BWD_FRAME_NS = FRAME_NS[:4] + (RAYS * N_MERGED,)
SPA_BWD_RAGGED = 3 * fused_mlp.chunk_rows(TILE_ROWS) + 129
SPA_BWD_FRAME_WIDTHS = {(256, 256): (2, 2), (48, 80): (2, 2),
                        (320, 320): (1, 1), (512, 512): (0, 1),
                        (600, 600): (0, 0)}


def spa_bwd_inter(ws, g, inter, recompute: bool):
    """d(inter) of the spatial backwards from ops.delta_layer calls, the
    heads' pullbacks added as the 64-row tiles add them: g_rt's, g_nct's
    added, g_bn's added and masked by inter in the residual form; g_bn's,
    g_nct's added, g_rt's added and masked in the recompute form (jax.vjp's
    order)."""
    wrt, wnct, wbn = ws[17], ws[19], ws[21]
    cd = wrt.dtype
    heads = [(g[:, :2], wrt), (g[:, 2:11], wnct), (g[:, 11:], wbn)]
    if recompute:
        heads.reverse()
    (a0, w0), (a1, w1), (a2, w2) = [(a.to(cd).contiguous(), w)
                                    for a, w in heads]
    t = ops.delta_layer(a0, w0)[0]
    t = ops.delta_layer(a1, w1, add=t)[0]
    return ops.delta_layer(a2, w2, act=inter, add=t)[0]


def spa_bwd_chain(ws, acts, deltas):
    """Whether each of d7 .. d1 (deltas[6] .. deltas[0]) equals
    ops.delta_layer of the delta before it (deltas[7] = d(inter) first),
    its layer's W (w7, w6, w5, w4b, w3, w2, w1) and the activation that
    masks it (z7 .. h1), bit for bit: d7 first."""
    mats = (ws[15], ws[13], ws[11], ws[9], ws[6], ws[4], ws[2])
    return [bool(torch.equal(deltas[6 - j], ops.delta_layer(
        deltas[7 - j], w, act=acts[6 - j])[0])) for j, w in enumerate(mats)]


# The grads of a bf16 spatial backward over a few hundred points or fewer,
# against the plain version's: its weight grads are a tile's or two of
# rounded partials, and one partial rounded one ulp apart moves a grad by
# up to 2^-8 of itself, so that the order limit, made for a step's points,
# reads the 64-row tile beyond it too (1.26e-3 against 1.05e-3 at 600 wide
# and 127 points on an H100 80GB HBM3); tests/test_torch_cuda.py holds the
# Ref-NeRF backwards at this limit there (its REF_GRAD_REL).
SPA_BWD_FEW = 300
SPA_BWD_FEW_REL = 2e-3


def spa_bwd_grads(name, n, got, plain):
    """A bf16 spatial backward's 23 grads ``got`` over n points against
    ``plain`` (a call of its plain version): above SPA_BWD_FEW points as
    check_kernel holds them (order_reference: the plain chain with f64 delta
    sums, the larger of REF_GRAD_REL and BWD_ORDER_FACTOR times the f32
    chain's distance from it), else the plain version within
    SPA_BWD_FEW_REL.  Returns (whether all are finite, the worst relative
    error, its limit)."""
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    if n <= SPA_BWD_FEW:
        return finite, _chain_rel(got, plain()), SPA_BWD_FEW_REL
    want, lim, _ = order_reference(name, torch.bfloat16, plain, (), got,
                                   plain())
    return finite, _chain_rel(got, want), lim


def spa_bwd_frame_identities(ws, x, pos, n, recompute: bool):
    """The backward frame's identities on one case of n points (a seeded
    cotangent g; the residual form on ref_spa_fwd_res's stored
    activations): the residual form's rounded heads' cotangents equal to
    g's columns cast to bf16, d(inter) to spa_bwd_inter's and d7 .. d1 to
    spa_bwd_chain's, bit for bit; the recompute form's rebuilt activations
    (the last chunk's, which its scratch holds) equal to ref_spa_fwd_res's
    rows, and its deltas to the same identities in its order; the grads
    finite and within their limit of the plain version's (spa_bwd_grads);
    the body that the launch reported (ops.BODIES)."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    g = torch.randn((n, ref_fused.HEAD_FIXED + ws[21].shape[1]),
                    generator=gen, device="cuda")
    acts = ops.ref_spa_fwd_res(ws, x, pos)[2]
    if recompute:
        name = "ref_spa_bwd_recompute"
        (grads, racts, deltas), body = body_of(
            name, lambda: ref_fused._spa_bwd_recompute_launch(
                ws, x, g, TILE_ROWS))
        chunk = fused_mlp.chunk_rows(TILE_ROWS)
        c0 = (n - 1) // chunk * chunk
        rows = slice(c0, n)
        racts = [a[:n - c0] for a in racts]
        deltas = [d[:n - c0] for d in deltas]
        out = dict(acts_equal_res=[bool(torch.equal(a, b[rows]))
                                   for a, b in zip(racts, acts)])
        plain = lambda: ops.ref_spa_bwd_recompute_plain(  # noqa: E731
            ws, x, g, TILE_ROWS, acts=acts)
    else:
        name, rows = "ref_spa_bwd", slice(0, n)
        (grads, deltas), body = body_of(
            name, lambda: ref_fused._spa_bwd_launch(ws, x, g, acts,
                                                     TILE_ROWS))
        racts = acts
        cd = x.dtype
        out = dict(heads_rounded=bool(
            torch.equal(deltas[8], g[:, :2].to(cd))
            and torch.equal(deltas[9], g[:, 2:11].to(cd))
            and torch.equal(deltas[10], g[:, 11:].to(cd))))
    inter = spa_bwd_inter(ws, g[rows], racts[7], recompute)
    finite, rel, lim = spa_bwd_grads(name, n, grads, plain if recompute
                                     else lambda: ops.ref_spa_bwd_plain(
                                         ws, x, g, acts, TILE_ROWS))
    return dict(out, body=body,
                inter_equal=bool(torch.equal(deltas[7], inter)),
                chain_equal=spa_bwd_chain(ws, racts, deltas),
                finite=finite, grad_rel_err=rel, grad_rel_lim=lim)


# the width scan of the spa_bwd_frame phase: H = O from 472 to 776 in steps
# of 8, 300 points each (the frame's widest fit in each form and the 64-row
# tile's lie between), and the widest that the 64-row tile ran in each
# bf16 form before the frame took the spatial backwards' delta passes
# (kernel_ab.py --spa_bwd on the parent), which each form must reach again.
# Where the frame runs, the scan holds its deltas to the phase's identities
# bit for bit; the grads' distance from the plain version is a reading
# beside them (one tile's rounded weight grads at these widths, above the
# SPA_BWD_FEW_REL of the phase's cases: 2.03e-3 in the residual form on an
# H100 80GB HBM3, the same with the frame's stores synchronous or by the
# bulk-copy engine).
SPA_BWD_WIDTH_SCAN = range(472, 784, 8)
SPA_BWD_TILE_WIDEST = {"res": 768, "recompute": 736}


def spa_bwd_frame_widths():
    """For each form of the bf16 spatial backward, the widest H = O of
    SPA_BWD_WIDTH_SCAN that runs the frame and the widest that runs at all
    (the 64-row tile above the frame's fit), each launch's grads finite,
    and at each width that ran the frame its identities (those of
    spa_bwd_frame_identities: the rounded heads' cotangents, d(inter) and
    d7 .. d1, on the activations it read or rebuilt) bit for bit; fails
    where a width below one that runs raises, where the frame is chosen
    above a width that took the 64-row tile, where the widest that runs is
    short of SPA_BWD_TILE_WIDEST, or where a grad is not finite or an
    identity fails.  Reads the worst relative distance of the grads from
    the plain version's (the recompute form's on the activations it
    rebuilt, which its scratch holds for these few points)."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for form in ("res", "recompute"):
        name = "ref_spa_bwd" if form == "res" else "ref_spa_bwd_recompute"
        bodies, worst, finite, broken = [], 0.0, True, []
        for w in SPA_BWD_WIDTH_SCAN:
            ws = random_weights(ref_spa_shapes(h=w, o=w), gen, bf16,
                                gain=REF_GAIN)
            pos, x = ref_points(gen, bf16, 300)
            g = torch.randn((300, ref_fused.HEAD_FIXED + 128), generator=gen,
                            device="cuda")
            if form == "res":
                acts = [torch.relu(torch.randn((300, w), generator=gen,
                                               device="cuda")).to(bf16)
                        for _ in range(8)]
                call = lambda: ref_fused._spa_bwd_launch(  # noqa: E731
                    ws, x, g, acts, TILE_ROWS)
                plain = lambda: ops.ref_spa_bwd_plain(  # noqa: E731
                    ws, x, g, acts, TILE_ROWS)
            else:
                call = lambda: ref_fused._spa_bwd_recompute_launch(  # noqa
                    ws, x, g, TILE_ROWS)
                plain = lambda: ops.ref_spa_bwd_recompute_plain(  # noqa
                    ws, x, g, TILE_ROWS, acts=got[1])
            try:
                got, body = body_of(name, call)
                torch.cuda.synchronize()
            except RuntimeError:
                bodies.append(None)
                continue
            bodies.append(body)
            grads, deltas = got[0], got[-1]
            racts = acts if form == "res" else got[1]
            finite = finite and all(bool(torch.isfinite(t).all())
                                    for t in grads)
            worst = max(worst, _chain_rel(grads, plain()))
            if body.startswith("spa_bwd_frame_kernel"):
                ok = (torch.equal(deltas[7], spa_bwd_inter(
                          ws, g, racts[7], form == "recompute"))
                      and all(spa_bwd_chain(ws, racts, deltas)))
                if form == "res":
                    ok = ok and torch.equal(deltas[8], g[:, :2].to(bf16)) \
                        and torch.equal(deltas[9], g[:, 2:11].to(bf16)) \
                        and torch.equal(deltas[10], g[:, 11:].to(bf16))
                if not ok:
                    broken.append(w)
            del ws, pos, x, g, got, grads, deltas, racts
        runs = [w for w, b in zip(SPA_BWD_WIDTH_SCAN, bodies) if b]
        frame = [w for w, b in zip(SPA_BWD_WIDTH_SCAN, bodies)
                 if b and b.startswith("spa_bwd_frame_kernel")]
        out[form] = dict(frame_to=max(frame, default=None),
                         runs_to=max(runs, default=None),
                         identities_held_at=frame, grads_finite=finite,
                         grads_vs_plain=worst)
        if (runs != list(SPA_BWD_WIDTH_SCAN)[:len(runs)]
                or frame != runs[:len(frame)]
                or max(runs, default=0) < SPA_BWD_TILE_WIDEST[form]
                or not finite or broken):
            fail(f"the spatial backwards' widths ({form}): "
                 f"{dict(zip(SPA_BWD_WIDTH_SCAN, bodies))}, grads finite "
                 f"{finite}, identities failing at {broken}, widest before "
                 f"the frame {SPA_BWD_TILE_WIDEST[form]}")
    return out


def spa_bwd_frame_checks():
    """spa_bwd_frame_identities on seeded bf16 operands (its own generator)
    at SPA_BWD_FRAME_NS (and SPA_BWD_RAGGED for the recompute form) x
    SPA_BWD_FRAME_WIDTHS; fails where an identity does not hold, a grad is
    not finite or parts from the plain version beyond its limit, or a launch
    ran another body than its width's; then the width scan
    (spa_bwd_frame_widths).  Its launches are not the main path's."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(27)
    cases = []
    t0 = time.perf_counter()
    for (h, o), cons in SPA_BWD_FRAME_WIDTHS.items():
        ws = random_weights(ref_spa_shapes(h=h, o=o), gen, bf16,
                            gain=REF_GAIN)
        for n in SPA_BWD_FRAME_NS + (SPA_BWD_RAGGED,):
            pos, x = ref_points(gen, bf16, n)
            for form, c in zip(("res", "recompute"), cons):
                if n == SPA_BWD_RAGGED and form == "res":
                    continue
                r = dict(h=h, o=o, n=n, form=form,
                         **spa_bwd_frame_identities(ws, x, pos, n,
                                                    form == "recompute"))
                cases.append(r)
                if not (r.get("heads_rounded", True)
                        and all(r.get("acts_equal_res", [True]))
                        and r["inter_equal"] and all(r["chain_equal"])
                        and r["finite"]
                        and r["grad_rel_err"] <= r["grad_rel_lim"]
                        and r["body"] == ref_fused.spa_bwd_body_name(c,
                                                                     form)):
                    fail(f"the bf16 spatial backward frame fails an "
                         f"identity: {r}")
            del pos, x
            torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0
    return dict(cases=cases, all_equal=True, seconds=checks_s,
                widths=spa_bwd_frame_widths())


# ---------------------------------------------------------------------------
# phase 4: the render path
# ---------------------------------------------------------------------------

def write_split(root: str, split: str, n_views: int,
                gen: np.random.Generator, filters=0):
    """``n_views`` 800x800 RGBA views of ``split`` in the Blender layout
    under root/data/lego, lego's field of view, poses on the orbit; their
    rows under the PNG ``filters`` (``utils.png.filter_rows``), written on
    a thread pool."""
    scene = os.path.join(root, "data", "lego")
    os.makedirs(os.path.join(scene, split))
    yy, xx = np.mgrid[0:VIEW_HW, 0:VIEW_HW] / VIEW_HW
    frames = []
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = []
        for i in range(n_views):
            pose = pose_spherical(-180.0 + 360.0 * i / max(n_views, 4),
                                  -30.0, 4.0)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
            phase = gen.uniform(0, 2 * np.pi, 3)
            rgb = 0.5 + 0.5 * np.sin(6 * xx[..., None] + 4 * yy[..., None]
                                     + phase)
            alpha = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.1)[..., None]
            img = np.concatenate([rgb, alpha], -1) * 255.0 + 0.5
            jobs.append(pool.submit(
                write_png, os.path.join(scene, split, f"r_{i}.png"),
                img.astype(np.uint8), filters))
        for job in jobs:
            job.result()
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
            if m is None:       # Mip-NeRF has no proposal net
                continue
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
    (launches, s per frame, the normal panels' spread, the launches by body
    of the kernels that report one).  Each eval forward of the path launches
    once per chunk, every other kernel never, each that reports a body on
    the frame's two consumer warpgroups; the Ref-NeRF grids carry the
    normal panel, which must not be blank."""
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
    bodies = launched_bodies(launches, frame_launched(launches))
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
    return launches, wall / N_FRAMES, normal_std, bodies


# the kernels whose C entry reports the body it launched (ops.BODIES), and
# the body each runs at the main paths' default widths in bf16: the frame,
# two consumer warpgroups
BODY_KERNELS = {
    "prop_mlp_fwd": fused_mlp.prop_body_name(2, False),
    "prop_mlp_fwd_res": fused_mlp.prop_body_name(2, True),
    "vanilla_mlp_fwd": fused_mlp.vanilla_body_name(2, False),
    "vanilla_mlp_fwd_res": fused_mlp.vanilla_body_name(2, True),
    "ref_spa_fwd": ref_fused.spa_body_name(2, "eval"),
    "ref_spa_fwd_res": ref_fused.spa_body_name(2, "res"),
    "ref_spa_fwd_grad": ref_fused.spa_body_name(2, "grad"),
    "ref_dir_fwd": ref_fused.dir_body_name(2, False),
    "ref_dir_fwd_res": ref_fused.dir_body_name(2, True),
    "ref_spa_bwd": ref_fused.spa_bwd_body_name(2, "res"),
    "ref_spa_bwd_recompute": ref_fused.spa_bwd_body_name(2, "recompute")}


def frame_launched(launches: dict) -> tuple:
    """The kernels of BODY_KERNELS that a bf16 run which counted
    ``launches`` launched: each must have run its frame alone."""
    return tuple(k for k in BODY_KERNELS if launches.get(k))


def launched_bodies(launches: dict, frame=()) -> dict:
    """The launches by body (ops.BODIES) of the run that counted
    ``launches``: fails unless each kernel of BODY_KERNELS that launched has
    them and they add up to its launches, or unless each kernel of ``frame``
    ran its BODY_KERNELS body alone."""
    bodies = {k: dict(v) for k, v in ops.BODIES.items()}
    for k in BODY_KERNELS:
        if sum(bodies.get(k, {}).values()) != launches[k]:
            fail(f"{k}: launches by body {bodies.get(k)} do not add up to "
                 f"its {launches[k]} launches")
    for k in frame:
        if bodies.get(k) != {BODY_KERNELS[k]: launches[k]}:
            fail(f"{k} ran {bodies.get(k)}, not {BODY_KERNELS[k]} alone")
    return bodies


def frame_inputs(model: str = "vanilla"):
    """A 400x400 frame's pose, focal and noise (Mip-NeRF: one more
    stratified edge a ray)."""
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    pose = pose_spherical(30.0, -30.0, 4.0)
    g = torch.Generator(device="cuda").manual_seed(1)
    n = 400 * 400
    jitter = torch.rand((n, N_COARSE + (model == "mip")), generator=g,
                        device="cuda")
    u = torch.sort(torch.rand((n, N_FINE + 1), generator=g, device="cuda"),
                   dim=-1).values
    return pose, focal, (jitter, u)


def frame_check(model: str = "vanilla"):
    """One f32 frame through the kernels and through the nn.Module path,
    same weights, same injected noise: max abs diff of rgb (and of the
    Ref-NeRF normal map), and the depth's spread."""
    ref = model == "ref"
    cfg = finalize_config(PipelineConfig(model=model, white_bkg=True,
                                         use_ipe=model == "mip"),
                          fov_to_focal(LEGO_FOV, (400, 400)))
    models = seeded_models(cfg, 3 if ref else 0)
    pose, focal, noise = frame_inputs(model)
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
    kernel from torch.profiler; beside it the same warm frame through the
    nn.Module route (eval_use_pallas=False: cuBLAS products), as a
    yardstick."""
    from torch.profiler import ProfilerActivity, profile

    ref = model == "ref"
    cfg = finalize_config(PipelineConfig(model=model, white_bkg=True,
                                         use_bf16=True,
                                         use_ipe=model == "mip"),
                          fov_to_focal(LEGO_FOV, (400, 400)))
    models = seeded_models(cfg, 3 if ref else 0)
    pose, focal, noise = frame_inputs(model)

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
    module_cfg = cfg.replace(eval_use_pallas=False)

    def module_frame():
        ops.reset_launches()
        render_image(models, pose, (400, 400), focal, module_cfg,
                     noise=noise, render_normal=ref, device="cuda")
        torch.cuda.synchronize()
        if sum(ops.LAUNCHES.values()):
            fail(f"the nn.Module {model} frame launched {dict(ops.LAUNCHES)}")

    module_frame()
    t0 = time.perf_counter()
    module_frame()
    module_wall = time.perf_counter() - t0
    return dict(
        frame_s=wall, module_frame_s=module_wall,
        profiled_frame_s=wall_profiled, device_ms=device_ms,
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


def step_batch(seed: int = 2, n_strat: int = N_COARSE):
    """One default step's rays (1024 of a 400x400 view), ground truth and
    injected noise (jitter (1024, n_strat), sorted uniforms), from
    ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    pose = torch.tensor(pose_spherical(30.0, -30.0, 4.0)[:3],
                        device="cuda")
    pool = torch.rand((1, 400 * 400, 3), generator=g, device="cuda")
    rays, gt = sample_train_rays(pool, pose[None], 0, (400, 400), focal,
                                 RAYS, generator=g)
    jitter = torch.rand((RAYS, n_strat), generator=g, device="cuda")
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
    rebuilds bit for bit), and the step's launch set checked.  Mip-NeRF
    (``model="mip"``, the IPE at the 400x400 pixel radius) runs its one net
    through the vanilla kernels twice."""
    ref, mip = model == "ref", model == "mip"
    cfg = finalize_config(PipelineConfig(
        model=model, bottleneck_noise=0.0, store_residuals=store_residuals,
        prop_store_residuals=prop_res, use_ipe=mip),
        fov_to_focal(LEGO_FOV, (400, 400)))
    kernels = per_step(model, "prop_res" if prop_res else store_residuals)
    loss_rtol, grad_rel = ((REF_STEP_LOSS_RTOL, REF_STEP_GRAD_REL) if ref
                           else (STEP_LOSS_RTOL, STEP_GRAD_REL))
    models = seeded_models(cfg, 4 if ref else 1)
    rays, gt, jitter, u = step_batch(n_strat=N_COARSE + mip)
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
    if any(launches[k] != kernels.get(k, 0) for k in launches) or any(
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
    if metrics["coarse_loss" if mip else "prop_loss"] <= 0.0 or (
            ref and metrics["normal_loss"] <= 0.0):
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
    limit and the equal ones counted; each launch that reports a body ran
    the frame's two consumer warpgroups (the launches by body of each
    step)."""
    cfg = PipelineConfig(model=model, bottleneck_noise=0.0, use_bf16=True)
    models = seeded_models(cfg, 6)
    rays, gt, jitter, u = step_batch(7)
    params = train_parameters(models)
    out, bodies = {}, {}
    for res in (True, False):
        ops.reset_launches()
        loss, _ = compute_loss(models, rays, gt,
                               cfg.replace(prop_store_residuals=res),
                               noise=(jitter, u))
        out[res] = (loss.item(), torch.autograd.grad(loss, params),
                    dict(ops.LAUNCHES))
        bodies["prop_res" if res else "prop_recompute"] = launched_bodies(
            out[res][2], frame_launched(out[res][2]))
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
                bodies=bodies, loss_rel=loss_rel, grad_rel_err_max=max(rels),
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
    net's residual pair (``prop_res``; not for Mip-NeRF, which has no
    proposal net), same seeded weights and rays.  Memory:
    ``max_memory_allocated`` after ``reset_peak_memory_stats`` around one
    warm step (forward, backward, Adam), and its excess over what was
    allocated before the step.  Time: ms per step over MEMORY_STEPS
    back-to-back calls then a synchronize, median of MEMORY_RUNS; the
    launches of those steps, one per step of each kernel of the form and
    none of the other form's."""
    out = {}
    mip = model == "mip"
    for form in ("res", "recompute") + (() if mip else ("prop_res",)):
        res = form != "recompute"
        cfg = finalize_config(PipelineConfig(
            model=model, use_bf16=True, store_residuals=res,
            prop_store_residuals=form == "prop_res", use_ipe=mip),
            fov_to_focal(LEGO_FOV, (400, 400)))
        models = seeded_models(cfg, 8)
        opt = make_optimizer(models)
        rays, gt, _, _ = step_batch(9, N_COARSE + mip)
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
        want = dict(dict.fromkeys(launches, 0), **{
            k: c * steps for k, c in per_step(
                model, "prop_res" if form == "prop_res" else res).items()})
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
    least = MIP_MEMORY_SAVING if mip else MEMORY_SAVING[model]
    if saving < least:
        fail(f"{model}: the recompute form saves {saving} bytes of peak "
             f"memory, less than {least}: {out}")
    return dict(out, peak_saving_bytes=saving, peak_saving_min=least)


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
# Mip-NeRF's forms (batch_scaling's residuals axis): it has no proposal net
MIP_SCALING_FORMS = {"fine_res": dict(store_residuals=True),
                     "fine_recompute": dict(store_residuals=False)}
# vanilla at three ray batches in all three forms; Ref-NeRF, whose residual
# step holds about 3 GB at 1024 rays, at two, on the prop_res axis;
# Mip-NeRF (--model mip) at three in both of its forms
SCALING_ROWS = (
    [("vanilla", r, f) for r in (1024, 4096, 16384) for f in SCALING_FORMS]
    + [("ref", r, f) for r in (1024, 4096)
       for f in ("fine_res_prop_res", "fine_res_prop_recompute")]
    + [("mip", r, f) for r in (1024, 4096, 16384)
       for f in MIP_SCALING_FORMS])
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
        cfg = batch_scaling.config(model, r, use_pallas=True, **(
            MIP_SCALING_FORMS if model == "mip" else SCALING_FORMS)[form])
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
            lim, order = REF_GRAD_REL[dtype], {}
            if mode == "recompute":
                rel = None
                if not torch.allclose(dh, pdh, **TOLS[dtype]):
                    fail(f"ref_dir_bwd_dissect[recompute] {dtype}: rgb, "
                         f"normal, density beyond {TOLS[dtype]}")
            elif dtype == torch.bfloat16:
                # as check_kernel holds ref_dir_bwd_recompute
                # (order_reference); the mode's zero parts read 0
                with f64_delta_products():
                    ref = plain(acts=acts)
                own = _chain_rel((pdh, pgrads), ref)
                lim = max(lim, BWD_ORDER_FACTOR * own)
                order = dict(plain_vs_plain_f64=own, kernel_vs_plain_f32=max(
                    [_rel_err(a, b) for a, b in zip(grads, pgrads)]
                    + [dheads_rel(dh, pdh)] * (mode != "wgrads")))
                pdh, pgrads = ref
            if mode != "recompute":
                rel = dheads_rel(dh, pdh) if mode != "wgrads" else 0.0
                if not rel <= lim:
                    fail(f"ref_dir_bwd_dissect[{mode}] {dtype}: d(heads) "
                         f"relative error {rel} beyond {lim}")
            gerr, grel = compare_grads("ref_dir_bwd_dissect", dtype, grads,
                                       pgrads, lim)
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
                dheads_rel_err=rel, grad_rel_err=grel, tol=lim, **order,
                ms=timed[dtype]["bwd_modes"][mode],
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
# phase 15: the weight-grad pass alone
# ---------------------------------------------------------------------------

# K-splits of TILE_ROWS points, each partial rounded to bf16 (the Ref-NeRF
# lists), against the plain version: a partial summed in another order may
# round to the neighbouring bf16 value, as in the Ref-NeRF backwards
WGRAD_REL = {False: GRAD_REL[torch.bfloat16], True: REF_GRAD_REL[torch.bfloat16]}
# cuda_device_ms: calls timed together, and the clock cycles (about 30 ms)
# the card sleeps before each timing while the host queues them
WGRAD_BATCH = 5
SLEEP_CYCLES = 60_000_000


def cuda_device_ms(fn, reps: int, batch: int = WGRAD_BATCH) -> float:
    """The device's time of ``fn``: the median of ``reps`` CUDA-event
    timings of ``batch`` calls, each timing queued behind a sleeping
    kernel so that the host has issued every call before the card reaches
    the first (the host's time to issue them is not counted), over
    ``batch``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def wgrad_lists(gen):
    """The weight-grad job lists of one default bf16 step's backwards, the
    ``add_job`` lists of csrc/*.cu: ``name -> (jobs over all points, points
    a K-split, rounded partials, points a chunk or None for one pass)``.
    The deltas are the plain delta chains' (``*_wgrad_jobs``) on the
    backward kernel cases' operands: vanilla_mlp_bwd (131,072 points),
    prop_mlp_bwd_res (65,536 points in two chunks of 8 splits),
    ref_spa_bwd, the same spatial list as the recompute form and the hybrid
    route walk it (the heads' f32 cotangent read in place, strided at
    offsets 0, 2 and 11; six chunks) and ref_dir_bwd (196,608 points)."""
    bf = torch.bfloat16
    args = kernel_case("vanilla_mlp_bwd", bf, gen)[0]
    n = args[1].shape[0]
    yield "vanilla", (fused_mlp.vanilla_wgrad_jobs(*args),
                      math.ceil(n / fused_mlp._splits(n)), False, None)
    del args
    args = kernel_case("prop_mlp_bwd_res", bf, gen)[0]
    n = args[1].shape[0]
    rows = math.ceil(n / fused_mlp._splits(n))
    yield "prop", (fused_mlp.prop_wgrad_jobs(*args), rows, False,
                   fused_mlp.chunk_rows(rows))
    del args
    ws, x, g, acts, tile = kernel_case("ref_spa_bwd", bf, gen)[0]
    yield "ref_spa", (ref_fused.ref_spa_wgrad_jobs(ws, x, g, acts), tile,
                      True, None)
    yield "ref_spa_recompute", (
        ref_fused.ref_spa_wgrad_jobs(ws, x, g, acts, recompute=True), tile,
        True, fused_mlp.chunk_rows(tile))
    del ws, x, g, acts
    args = kernel_case("ref_dir_bwd", bf, gen)[0]
    yield "ref_dir", (ref_fused.ref_dir_wgrad_jobs(*args[:-1])[1],
                      args[-1], True, None)


def wgrad_walk(jobs, chunk):
    """The jobs cut into chunks of ``chunk`` points (one piece if None)."""
    n = jobs[0][0].shape[0]
    step = chunk or max(n, 1)
    return [[(a[c0:c0 + step], d[c0:c0 + step], b) for a, d, b in jobs]
            for c0 in range(0, n, step)]


def stage_path(t, delta_path="tma"):
    """How csrc/wgrad.cuh's bf16 body stages an operand (stage_mode): by TMA
    where its rows are 16-byte aligned ("tma" into the slot, "f32 tma" into
    a copy area), else by the producer threads from one bulk copy of the
    chunk's span ("span"), from 4-byte copies of an f32 delta ("rows") or
    from device memory ("elementwise": A where delta takes the copy
    areas)."""
    f32 = t.dtype == torch.float32
    ld = t.stride(0)
    if t.data_ptr() % 16 == 0 and ld % (4 if f32 else 8) == 0:
        return "f32 tma" if f32 else "tma"
    if delta_path not in ("tma", "elementwise"):
        return "elementwise"
    if ld <= (128 if f32 else 256):
        return "span"
    return "rows" if f32 else "elementwise"


def stage_paths(a, d):
    """(A's, delta's) staging paths."""
    dp = stage_path(d)
    return stage_path(a, dp), dp


def wgrad_call(pieces, rows, rnd, fn):
    """One walk of ``fn`` (the kernel or the plain version) over the
    pieces, each reduced onto the sums of those before it."""
    grads = None
    for jobs in pieces:
        grads = fn(jobs, rows, rnd, grads=grads)
    return grads


# the weight-grad pass's rounding gate: the 256 x 256 trunk job (A and a
# bf16 delta both read by TMA) and the 63 x 256 first-layer job (A = enc_x,
# staged by the threads), each on its own seeded points in K-splits of
# 4096 (ROWS_PER_SPLIT), partials unrounded
WGRAD_GATE_SHAPES = ((256, 256), (63, 256))
WGRAD_GATE_N = 131_072
WGRAD_GATE_ROWS = 4096
WGRAD_GATE_SEED = 18
# the largest relative Frobenius error of the pass's weight grad against
# the split summed in f64 and rounded (wgrad.wgrad_reduce_f64), as a
# multiple of the error of the f32 sum in the order of the points
# (wgrad.wgrad_reduce_in_order): a pass that chains its k-steps through the
# tensor cores' truncating accumulator reads above it
WGRAD_GATE_FACTOR = 1.0


def wgrad_gate_readings():
    """At each shape of WGRAD_GATE_SHAPES, one job with bias on A (ReLU'd
    N(0, 1) activations, or U(-1, 1) encodings at width 63) and delta
    U(-1, 1), bf16: the weight grad's relative Frobenius error and its
    largest error in units in the last place against
    wgrad.wgrad_reduce_f64, for the kernel, the in-order f32 sum and the
    plain version (cuBLAS's f32 torch.mm a split), the limit and the
    kernel's ratio to the in-order error; the bias's relative errors
    beside them (f32 sums on the CUDA cores, not gated)."""
    gen = torch.Generator(device="cuda").manual_seed(WGRAD_GATE_SEED)
    out = []
    for m, k in WGRAD_GATE_SHAPES:
        a = torch.randn((WGRAD_GATE_N, m), generator=gen, device="cuda")
        a = (a.relu() if m != 63 else torch.rand(
            (WGRAD_GATE_N, m), generator=gen, device="cuda") * 2 - 1)
        d = torch.rand((WGRAD_GATE_N, k), generator=gen, device="cuda") * 2 - 1
        jobs = [(a.to(torch.bfloat16), d.to(torch.bfloat16), True)]
        del a, d
        exact = wgrad_lib.wgrad_reduce_f64(jobs, WGRAD_GATE_ROWS)
        errs = {key: [wgrad_lib.summation_error(g, e)
                      for g, e in zip(fn(jobs, WGRAD_GATE_ROWS), exact)]
                for key, fn in (("kernel", ops.wgrad_reduce),
                                ("in_order_f32",
                                 wgrad_lib.wgrad_reduce_in_order),
                                ("plain", ops.wgrad_reduce_plain))}
        limit = WGRAD_GATE_FACTOR * errs["in_order_f32"][0]["rel"]
        out.append(dict(
            shape=f"{m}x{k}", n=WGRAD_GATE_N, rows_per_split=WGRAD_GATE_ROWS,
            limit=limit, ratio=errs["kernel"][0]["rel"]
            / errs["in_order_f32"][0]["rel"],
            **{key: e[0]["rel"] for key, e in errs.items()},
            ulps={key: e[0]["ulps"] for key, e in errs.items()},
            bias_rel={key: e[1]["rel"] for key, e in errs.items()}))
        del jobs, exact
    return out


def wgrad_rounding_gate():
    """wgrad_gate_readings; fails where the pass's error is above
    WGRAD_GATE_FACTOR times the in-order sum's."""
    out = wgrad_gate_readings()
    for r in out:
        if r["kernel"] > r["limit"]:
            fail(f"wgrad_reduce[{r['shape']}]: its weight grad's relative "
                 f"error {r['kernel']} against the f64 splits is above "
                 f"{r['limit']} ({WGRAD_GATE_FACTOR} x the in-order f32 "
                 f"sum's)")
    return out


def wgrad_phase(gen):
    """ops.wgrad_reduce at each list of ``wgrad_lists`` in bf16: its grads
    against wgrad_reduce_plain's (relative Frobenius error of each grad
    within WGRAD_REL), a second walk equal bit for bit, its device time
    (``cuda_device_ms``: the pass as the backwards launch it, from C, with
    no host in the way), the plain version's time, the library yardstick
    (one torch.mm(A^T, delta) a job over all points on the same bf16
    operands, delta rounded beforehand; the port never calls it) and the
    bound: each operand read once (a delta that two jobs share counted
    once, a strided one by the columns read), each grad written once, 2 m k
    FLOPs a point and job and k for the bias sums.  Each job's staging
    paths (stage_paths: TMA or the threads) are listed as csrc/wgrad.cuh
    picks them.  The launches are counted over the lists' kernel walks
    alone.  Then the rounding gate (wgrad_rounding_gate)."""
    out, launches = {}, 0
    for name, (jobs, rows, rnd, chunk) in wgrad_lists(gen):
        pieces = wgrad_walk(jobs, chunk)
        n = jobs[0][0].shape[0]
        ops.reset_launches()
        got = wgrad_call(pieces, rows, rnd, ops.wgrad_reduce)
        again = wgrad_call(pieces, rows, rnd, ops.wgrad_reduce)
        launches += ops.LAUNCHES["wgrad_reduce"]
        want = wgrad_call(pieces, rows, rnd, ops.wgrad_reduce_plain)
        torch.cuda.synchronize()
        rels = [_rel_err(a, b) for a, b in zip(got, want)]
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not max(rels) <= WGRAD_REL[rnd]:
            fail(f"wgrad_reduce[{name}]: grad relative errors {rels} beyond "
                 f"{WGRAD_REL[rnd]}")
        if not all(map(torch.equal, got, again)):
            fail(f"wgrad_reduce[{name}]: two walks differ")
        del got, again, want

        def walk():
            return wgrad_call(pieces, rows, rnd, ops.wgrad_reduce)
        ms = cuda_device_ms(walk, 20)
        plain_ms = cuda_device_ms(lambda: wgrad_call(
            pieces, rows, rnd, ops.wgrad_reduce_plain), 20, 1)
        lib_ops = [(a, d.to(torch.bfloat16)) for a, d, _ in jobs]
        library_ms = cuda_device_ms(lambda: [torch.mm(a.T, d)
                                             for a, d in lib_ops], 20)
        del lib_ops
        reads = {}
        for a, d, _ in jobs:
            for t in (a, d):
                reads[(t.data_ptr(), tuple(t.shape))] = _nbytes(t)
        moved = sum(reads.values()) + 4 * sum(
            math.prod(s) for s in grad_shapes(jobs))
        flops = float(sum(n * d.shape[1] * (2 * a.shape[1] + bias)
                          for a, d, bias in jobs))
        paths = [dict(m=a.shape[1], k=d.shape[1], ld=d.stride(0),
                      delta=str(d.dtype).replace("torch.", ""),
                      stages=stage_paths(a, d)) for a, d, _ in jobs]
        out[name] = dict(
            n=n, rows_per_split=rows, chunk_points=chunk,
            round_partial=rnd, jobs=len(jobs), max_abs_err=err,
            grad_rel_err=max(rels), tol=WGRAD_REL[rnd], bit_equal=True,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(moved, flops, torch.bfloat16), bytes=moved, flops=flops,
            tflops=flops / (ms * 1e-3) / 1e12, paths=paths)
        del jobs, pieces
        torch.cuda.empty_cache()
    if launches == 0:
        fail("the wgrad phase launched wgrad_reduce no time")
    gate = wgrad_rounding_gate()
    # the pass's share of each default bf16 step: the lists its backwards
    # walk (the hybrid route's directional net is the nn.Module's)
    steps = {"vanilla": ("vanilla", "prop"),
             "ref": ("ref_spa", "ref_dir", "prop"),
             "hybrid": ("ref_spa_recompute", "prop")}
    per_step = {k: {key: sum(out[x][key] for x in v)
                    for key in ("ms", "library_ms", "bound_ms")}
                for k, v in steps.items()}
    return dict(lists=out, per_step=per_step, launches=launches,
                rounding_gate=gate)


# ---------------------------------------------------------------------------
# phase 16: the forward layer tile alone (ops.dense_layer)
# ---------------------------------------------------------------------------

# the layers of the main paths: (input widths, output width); one input for
# a plain layer, two for a skip layer ([x, h4] of the trunks, [bvec, enc_d]
# of the vanilla net)
DENSE_SHAPES = ([((k,), o) for k in (63, 27, 167, 128, 256)
                 for o in (128, 256)]
                + [((63, 256), 256), ((167, 256), 256), ((256, 27), 128)])
# an eval chunk's merged Ref-NeRF points and a default vanilla step's fine
# points
DENSE_N = (CHUNK * N_MERGED, RAYS * N_FINE)
# the card tests' narrow widths, over a single row and ragged tiles
DENSE_NARROW = [((63,), 48), ((48,), 40), ((40,), 48), ((48, 27), 24),
                ((40,), 80)]
DENSE_RAGGED_N = (1, 70, 4099)


def dense_operands(gen, n, ks, n_out, dtype):
    """Rows U(-1, 1), matrices N(0, 2 / fan_in), bias N(0, 0.25)."""
    acts = [(torch.rand((n, k), generator=gen, device="cuda") * 2 - 1)
            .to(dtype) for k in ks]
    ws = [(torch.randn((k, n_out), generator=gen, device="cuda")
           * math.sqrt(2.0 / sum(ks))).to(dtype) for k in ks]
    b = torch.randn(n_out, generator=gen, device="cuda") * 0.5
    return acts, ws, b


def dense_call(fn, acts, ws, b, **kw):
    a1 = acts[1] if len(acts) > 1 else None
    w1 = ws[1] if len(ws) > 1 else None
    return fn(acts[0], ws[0], b, a1, w1, **kw)


def dense_check(gen, n, ks, n_out, dtype, timed=True):
    """One layer shape: the tile against its plain version (max abs error,
    within TOLS), its stored rows and mask bits against its own output and
    a second launch, all bit for bit; with ``timed`` its ms, the plain
    version's, torch.addmm's on the same operands (the skip layer's inputs
    and matrices concatenated beforehand: one call a layer), the bound and
    the weight bytes the blocks stage from L2 (computed, not measured)."""
    acts, ws, b = dense_operands(gen, n, ks, n_out, dtype)
    got, stored, bits = dense_call(ops.dense_layer, acts, ws, b, store=True,
                                   mask=True)
    again, _, _ = dense_call(ops.dense_layer, acts, ws, b)
    want, _, _ = dense_call(ops.dense_layer_plain, acts, ws, b)
    torch.cuda.synchronize()
    label = f"dense_layer[{'+'.join(map(str, ks))}->{n_out}, n={n}, {dtype}]"
    err = float((got.float() - want.float()).abs().max()) if n else 0.0
    tol = TOLS[dtype]
    if not bool(((got.float() - want.float()).abs()
                 <= tol["atol"] + tol["rtol"] * want.float().abs()).all()):
        fail(f"{label}: max abs error {err} beyond {tol}")
    if not (torch.equal(got, again) and torch.equal(got, stored)):
        fail(f"{label}: two launches or the stored rows differ")
    if not torch.equal(bits, dense_lib.pack_mask(got)):
        fail(f"{label}: the mask bits are not its output's > 0")
    res = dict(k=list(ks), n_out=n_out, n=n,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               tol=tol, bit_equal=True)
    del got, stored, bits, again, want
    if not timed:
        return res
    ms = cuda_ms(lambda: dense_call(ops.dense_layer, acts, ws, b), 20)
    plain_ms = cuda_ms(lambda: dense_call(ops.dense_layer_plain, acts, ws,
                                          b), 20)
    cat_a = torch.cat(acts, 1) if len(acts) > 1 else acts[0]
    cat_w = torch.cat(ws, 0) if len(ws) > 1 else ws[0]
    bias = b.to(dtype).reshape(1, -1)
    library_ms = cuda_ms(lambda: torch.addmm(bias, cat_a, cat_w), 20)
    k = sum(ks)
    moved = _nbytes(*acts, *ws, b) + n * n_out * acts[0].element_size()
    flops = 2.0 * n * n_out * k
    staged = math.ceil(n / 64) * k * n_out * acts[0].element_size()
    return dict(res, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(moved, flops, dtype), bytes=moved, flops=flops,
                tflops=flops / (ms * 1e-3) / 1e12,
                weight_bytes_staged=staged,
                weight_stage_tb_per_s=staged / (ms * 1e-3) / 1e12)


# the tile's rounding gate: the 256 -> 256 layer and the longest chain of
# the main paths (167 + 256 -> 256, 27 k-steps) on their own seeded rows
DENSE_GATE_SHAPES = (((256,), 256), ((167, 256), 256))
DENSE_GATE_N = 131_072
DENSE_GATE_SEED = 16
# the most bf16 outputs of the tile that may differ from the layer summed in
# f64 and rounded, as a multiple of the share of the f32 sum in the order
# of k (dense.dense_layer_in_order): a tile that chains its k-steps through
# the tensor cores' truncating accumulator reads above it
DENSE_GATE_FACTOR = 1.0


def rounding_gate():
    """At each shape of DENSE_GATE_SHAPES: the share of the tile's bf16
    outputs that differ from the layer summed in f64 and then rounded, the
    in-order f32 sum's share and the plain version's (cuBLAS) beside it;
    fails where the tile's share is above DENSE_GATE_FACTOR times the
    in-order sum's."""
    gen = torch.Generator(device="cuda").manual_seed(DENSE_GATE_SEED)
    out = []
    for ks, n_out in DENSE_GATE_SHAPES:
        acts, ws, b = dense_operands(gen, DENSE_GATE_N, ks, n_out,
                                     torch.bfloat16)
        exact = dense_call(dense_lib.dense_layer_f64, acts, ws, b)
        shares = {
            key: dense_lib.rounding_share(got, exact) for key, got in (
                ("tile", dense_call(ops.dense_layer, acts, ws, b)[0]),
                ("in_order_f32", dense_call(dense_lib.dense_layer_in_order,
                                            acts, ws, b)),
                ("plain", dense_call(ops.dense_layer_plain, acts, ws,
                                     b)[0]))}
        limit = DENSE_GATE_FACTOR * shares["in_order_f32"]
        label = f"{'+'.join(map(str, ks))}->{n_out}"
        if shares["tile"] > limit:
            fail(f"dense_layer[{label}]: {shares['tile']} of its bf16 "
                 f"outputs differ from the f64 layer, above {limit} "
                 f"({DENSE_GATE_FACTOR} x the in-order f32 sum's)")
        out.append(dict(shape=label, n=DENSE_GATE_N, limit=limit,
                        ratio=shares["tile"] / shares["in_order_f32"],
                        **shares))
        del acts, ws, exact
    return out


def dense_phase(gen):
    """ops.dense_layer at every layer shape of the main paths (DENSE_SHAPES)
    and both row counts of DENSE_N in bf16, timed; the same shapes in f32
    at a step's rows (the CUDA-core body, within TOLS); the narrow widths
    and ragged row counts untimed; the rounding gate (rounding_gate).  The
    launches are counted over the phase's own calls."""
    ops.reset_launches()
    timed, f32, narrow = [], [], []
    for n in DENSE_N:
        for ks, n_out in DENSE_SHAPES:
            timed.append(dense_check(gen, n, ks, n_out, torch.bfloat16))
            torch.cuda.empty_cache()
    for ks, n_out in DENSE_SHAPES:
        f32.append(dense_check(gen, DENSE_N[1], ks, n_out, torch.float32))
    for dtype in (torch.bfloat16, torch.float32):
        for n in DENSE_RAGGED_N:
            for ks, n_out in DENSE_NARROW + DENSE_SHAPES:
                narrow.append(dense_check(gen, n, ks, n_out, dtype, False))
    gate = rounding_gate()
    launches = ops.LAUNCHES["dense_layer"]
    if launches == 0:
        fail("the dense phase launched dense_layer no time")
    return dict(timed=timed, f32=f32, rounding_gate=gate,
                untimed_cases=len(narrow),
                untimed_max_abs_err=max(r["max_abs_err"] for r in narrow),
                launches=launches)


# (k_dim, n_out, form) of every delta pass of the main paths (the forms of
# delta_check): the vanilla dr1, dbvec (f32 rows), dz7 (the sigma term) and
# trunk layers; the proposal's dh4 (the K = 1 term alone); Ref-NeRF's
# d(inter) as three pullbacks summed, the density gradient's first layer
# and trunk with stored activations or mask bits, the directional head and
# the two pullbacks into its 167-wide input; the density gradient's 63-wide
# pullback into the encoding (enc_pull) takes the f32 form's product
DELTA_SHAPES = [(3, 128, "act"), (128, 256, "f32"), (256, 256, "gs"),
                (256, 256, "act"), (0, 256, "gs"), (2, 256, "none"),
                (9, 256, "add"), (128, 256, "add_act"), (2, 256, "act"),
                (2, 256, "bits"), (256, 256, "bits"), (256, 63, "f32"),
                (3, 256, "act"), (256, 167, "none"), (256, 167, "add"),
                (2, 256, "add_act")]
# a vanilla step's fine points and a Ref-NeRF step's merged points
DELTA_N = (RAYS * N_FINE, RAYS * N_MERGED)
# the card tests' narrow widths: the heads' k_dim, odd and narrow n_out, a
# ragged k-step, a layer wider than one pass
DELTA_NARROW = [(0, 48, "gs"), (2, 40, "add_act"), (3, 24, "act"),
                (9, 48, "add"), (48, 63, "f32"), (40, 167, "none"),
                (48, 167, "add"), (40, 37, "bits"), (24, 5, "act"),
                (48, 552, "gs"), (3, 48, "bits")]


def delta_operands(gen, n, k, n_out, form, dtype):
    """delta_layer's keyword arguments for ``form``: deltas U(-1, 1), the
    forward matrix N(0, 1 / n_out), activations N(0, 1) (about half of
    them masked), gs U(-1, 1), wcol N(0, 1 / n_out), the ADD operand
    U(-1, 1); the rows stored in the compute dtype, or f32 (form "f32")."""
    def u(*shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2
                - 1).to(dtype)

    def g(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    kw = dict(a=u(n, k), w=g(n_out, k, scale=n_out ** -0.5))
    act = g(n, n_out)
    if form in ("act", "gs", "add_act"):
        kw["act"] = act
    if form == "bits":
        kw["bits"] = dense_lib.pack_mask(act)
    if form == "gs":
        kw["gs"], kw["wcol"] = u(n), g(n_out, scale=n_out ** -0.5)
    if form in ("add", "add_act"):
        kw["add"] = u(n, n_out)
    kw["store"] = torch.float32 if form == "f32" else dtype
    return kw


# timings of each delta case, whose median is read: each sleeps the card
# SLEEP_CYCLES first, and at 20 the phase's 48 timed cases took 95 s
DELTA_REPS = 10


def delta_check(gen, n, k, n_out, form, dtype, timed=True):
    """One delta shape and form: the pass against its plain version (max
    abs error of its output and its stored rows, within TOLS), its stored
    rows against its output and a second launch, bit for bit; with
    ``timed`` the device ms (cuda_device_ms, median of DELTA_REPS) of the
    pass, of the plain
    version and of torch.mm(a, W^T) on the same operands (the product's
    yardstick: no mask, no store), and the bound: 2 n k n_out FLOPs (plus
    the K = 1 term's 2 n n_out) against each operand read once and the
    one output written once."""
    kw = delta_operands(gen, n, k, n_out, form, dtype)
    got, stored = ops.delta_layer(**kw)
    again, _ = ops.delta_layer(**kw)
    want, want_stored = ops.delta_layer_plain(**kw)
    torch.cuda.synchronize()
    label = f"delta_layer[{k}->{n_out} {form}, n={n}, {dtype}]"
    tol = TOLS[dtype]
    errs = []
    for x, y in ((got, want), (stored, want_stored)):
        d = (x.float() - y.float()).abs()
        errs.append(float(d.max()) if n else 0.0)
        if not bool((d <= tol["atol"] + tol["rtol"] * y.float().abs()).all()):
            fail(f"{label}: max abs error {errs[-1]} beyond {tol}")
    if not (torch.equal(got, again) and torch.equal(stored.to(dtype), got)):
        fail(f"{label}: two launches or the stored rows differ")
    res = dict(k=k, n_out=n_out, form=form, n=n,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=errs[0],
               stored_max_abs_err=errs[1], tol=tol, bit_equal=True)
    del got, stored, again, want, want_stored
    if not timed:
        return res
    # one output, as the fused kernels take the pass: the rows in the
    # compute dtype, or for form "f32" the unrounded f32 rows (the entry
    # also writes its copy in the compute dtype, which the bound leaves out)
    if form != "f32":
        kw["store"] = None
    ms = cuda_device_ms(lambda: ops.delta_layer(**kw), DELTA_REPS)
    plain_ms = cuda_device_ms(lambda: ops.delta_layer_plain(**kw),
                              DELTA_REPS)
    a, wt = kw["a"], kw["w"].t()
    library_ms = cuda_device_ms(lambda: torch.mm(a, wt), DELTA_REPS)
    moved = _nbytes(*[v for v in kw.values() if torch.is_tensor(v)]) \
        + n * n_out * (4 if form == "f32" else a.element_size())
    flops = 2.0 * n * n_out * (k + (1 if form == "gs" else 0))
    return dict(res, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(moved, flops, dtype), bytes=moved, flops=flops,
                tflops=flops / (ms * 1e-3) / 1e12)


# the delta pass's rounding gate: the 256 -> 256 trunk layer and the
# directional net's pullback into its 167-wide input (16 k-steps, an odd
# width), unmasked so that no output is a zero that hides its sum, on their
# own seeded rows
DELTA_GATE_SHAPES = ((256, 256, "none"), (256, 167, "none"))
DELTA_GATE_N = 131_072
DELTA_GATE_SEED = 17
# the most bf16 outputs of the pass that may differ from the pass summed in
# f64 and rounded, as a multiple of the share of the f32 sum in the order
# of k (delta.delta_layer_in_order): a pass that chains its k-steps through
# the tensor cores' truncating accumulator reads above it
DELTA_GATE_FACTOR = 1.0


def delta_gate_readings():
    """At each shape of DELTA_GATE_SHAPES: the share of the pass's bf16
    outputs that differ from the pass summed in f64 and then rounded
    (delta.delta_layer_f64), beside the in-order f32 sum's share and the
    plain version's (cuBLAS), the limit and the kernel's ratio to the
    in-order share."""
    gen = torch.Generator(device="cuda").manual_seed(DELTA_GATE_SEED)
    out = []
    for k, n_out, form in DELTA_GATE_SHAPES:
        kw = delta_operands(gen, DELTA_GATE_N, k, n_out, form,
                            torch.bfloat16)
        kw.pop("store")
        exact = delta_lib.delta_layer_f64(**kw)
        shares = {key: dense_lib.rounding_share(got, exact) for key, got in (
            ("kernel", ops.delta_layer(**kw)[0]),
            ("in_order_f32", delta_lib.delta_layer_in_order(**kw)),
            ("plain", ops.delta_layer_plain(**kw)[0]))}
        out.append(dict(shape=f"{k}->{n_out} {form}", n=DELTA_GATE_N,
                        limit=DELTA_GATE_FACTOR * shares["in_order_f32"],
                        ratio=shares["kernel"] / shares["in_order_f32"],
                        **shares))
        del kw, exact
    return out


def delta_rounding_gate():
    """delta_gate_readings; fails where the pass's share is above
    DELTA_GATE_FACTOR times the in-order sum's."""
    out = delta_gate_readings()
    for r in out:
        if r["kernel"] > r["limit"]:
            fail(f"delta_layer[{r['shape']}]: {r['kernel']} of its bf16 "
                 f"outputs differ from the f64 pass, above {r['limit']} "
                 f"({DELTA_GATE_FACTOR} x the in-order f32 sum's)")
    return out


def delta_phase(gen):
    """ops.delta_layer at every delta shape and form of the main paths
    (DELTA_SHAPES) at both row counts of DELTA_N in bf16, timed; the same
    shapes in f32 at a vanilla step's rows (the CUDA-core body, within TOLS,
    timed); the narrow widths at 1, 70 and 4099 rows untimed; the rounding
    gate (delta_rounding_gate).  The launches are counted over the phase's
    own calls."""
    ops.reset_launches()
    timed, f32, narrow = [], [], []
    for n in DELTA_N:
        for k, n_out, form in DELTA_SHAPES:
            timed.append(delta_check(gen, n, k, n_out, form, torch.bfloat16))
            torch.cuda.empty_cache()
    for k, n_out, form in DELTA_SHAPES:
        f32.append(delta_check(gen, DELTA_N[0], k, n_out, form,
                               torch.float32))
    for dtype in (torch.bfloat16, torch.float32):
        for n in DENSE_RAGGED_N:
            for k, n_out, form in DELTA_NARROW:
                narrow.append(delta_check(gen, n, k, n_out, form, dtype,
                                          False))
    gate = delta_rounding_gate()
    launches = ops.LAUNCHES["delta_layer"]
    if launches == 0:
        fail("the delta phase launched delta_layer no time")
    return dict(timed=timed, f32=f32, rounding_gate=gate,
                untimed_cases=len(narrow),
                untimed_max_abs_err=max(r["max_abs_err"] for r in narrow),
                launches=launches)


# the libraries whose kernels run the delta pass, the weight-grad pass or
# the frame, each with its <lib>_occupancy entry (mlp_tile.cuh's
# OCCUPANCY_ENTRY), the bf16 kernels that the phases before the occupancy
# line launch among them, and the libraries whose bf16 weight-grad body
# (wgrad_mma_kernel, built for one block an SM) those phases launch
OCCUPANCY_LIBS = ("fused_mlp", "fused_mlp_bwd", "fused_mlp_recompute",
                  "ref_fused", "ref_fused_bwd", "ref_fused_recompute",
                  "ref_dissect", "delta", "wgrad")
WGRAD_LIBS = ("fused_mlp_bwd", "fused_mlp_recompute", "ref_fused_bwd",
              "ref_fused_recompute", "ref_dissect", "wgrad")
OCCUPANCY_BF16 = (
    "vanilla_delta_kernel", "prop_delta_kernel<true>",
    "prop_delta_kernel<false>", "vanilla_recompute_kernel",
    "spa_frame_kernel<eval>", "spa_frame_kernel<res>",
    "spa_frame_kernel<grad>", "dir_frame_kernel<eval>",
    "dir_frame_kernel<res>", "vanilla_frame_kernel<eval>",
    "vanilla_frame_kernel<res>", "prop_frame_kernel<eval>",
    "prop_frame_kernel<res>", "spa_bwd_frame_kernel<res>",
    "spa_bwd_frame_kernel<recompute>", "ref_dir_delta_kernel",
    "ref_dir_recompute_kernel<1>",
    "ref_dir_recompute_kernel<2>", "ref_dir_recompute_kernel<3>",
    "delta_layer_kernel")


def delta_occupancy():
    """The runtime's occupancy query of every launch of a kernel that runs
    the delta pass, and of the bf16 weight-grad body, in this process so
    far, as each library noted it (mlp_tile.cuh's note_occupancy): by
    "<lib> <name>/<bf16|f32>", the shared memory and blocks an SM of each
    distinct launch.  Fails where a launch ran below the blocks an SM its
    kernel was built for (two for a bf16 delta-pass kernel, one for the
    weight-grad body and for the frame's eleven forms), a query
    failed, a bf16 kernel of OCCUPANCY_BF16 was
    never launched, or a library of WGRAD_LIBS never launched
    wgrad_mma_kernel."""
    out = {}
    for lib in OCCUPANCY_LIBS:
        fn = getattr(build.load(lib), f"{lib}_occupancy")
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_char_p, ctypes.c_int]
        buf = ctypes.create_string_buffer(fn(None, 0))
        fn(buf, len(buf))
        for ln in buf.value.decode().splitlines():
            name, smem, blocks, want = ln.split()
            bf16 = (want == "2" or name == "wgrad_mma_kernel"
                    or name.startswith(FRAME_KERNELS))
            key = f"{lib} {name}/{'bf16' if bf16 else 'f32'}"
            out.setdefault(key, []).append(dict(smem=int(smem),
                                                blocks=int(blocks)))
            if int(blocks) < int(want):
                fail(f"{key} launched at {blocks} blocks an SM with {smem} "
                     f"bytes of shared memory, below its {want}")
    seen = {k.split(" ", 1)[1] for k in out}
    missing = [n for n in OCCUPANCY_BF16 if f"{n}/bf16" not in seen]
    missing += [f"{lib} wgrad_mma_kernel" for lib in WGRAD_LIBS
                if f"{lib} wgrad_mma_kernel/bf16" not in out]
    if missing:
        fail(f"no occupancy noted for the bf16 {missing}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the train path, then render-only on its checkpoint
# ---------------------------------------------------------------------------

def train_argv(tmp: str, *extra: str, epochs: int = TRAIN_EPOCHS):
    """The train phase's command line (after ``python -m nerf_tpu_torch``)."""
    return ["--epochs", str(epochs), "-s", "-w", "--dataset_root",
            os.path.join(tmp, "data"), "--dataset_name", "lego",
            "--warmup_step", "20", "--eval_time", "1", "--no_tensorboard",
            "--output_dir", os.path.join(tmp, "output"), *extra]


def train_once(tmp: str, route: str, *extra: str,
               epochs: int = TRAIN_EPOCHS):
    """One run of the entry with the train phase's flags and ``extra`` for
    ``epochs`` epochs: (launches, per-step losses, per-step image MSEs,
    seconds); under ``-t`` the normal and back-face losses, under ``-m``
    the coarse loss must be logged and finite too."""
    log_dir = os.path.join(tmp, "logs", route)
    argv = train_argv(tmp, "--log_dir", log_dir, *extra, epochs=epochs)
    ops.reset_launches()
    torch.cuda.synchronize()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with cwd(tmp), contextlib.redirect_stdout(tee):
        rc = entry_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = launched_bodies(launches)
    if rc != 0:
        fail(f"train entry ({route}) returned {rc}")
    log = [os.path.join(d, f) for d, _, fs in os.walk(log_dir)
           for f in fs if f == "metrics.jsonl"][0]
    # phase 21 holds each run's MFU against the formula
    EPOCH_RUNS[route] = dict(
        flags=list(extra), epochs=epochs, output="".join(tee.parts),
        bodies=bodies,
        mfu=read_scalars(log, "MFU"), time=read_scalars(log, "Time/epoch"))
    losses = [v for _, v in read_scalars(log, "Train Loss")]
    mses = [10.0 ** (-v / 10.0) for _, v in read_scalars(log, "PSNR")]
    steps = TRAIN_VIEWS * epochs
    tags = (("Normal Loss", "Backface Loss") if "-t" in extra
            else ("Coarse Loss",) if "-m" in extra else ())
    if tags:
        for tag in tags:
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


# the train phases' routes: (flags, launches of each kernel a step, band of
# the epoch means against --no_pallas, launches of each kernel a chunk of
# an eval render)
_VANILLA_EVAL = dict.fromkeys(("prop_mlp_fwd", "vanilla_mlp_fwd"), 1)
ROUTES = {
    "vanilla": ((), per_step("vanilla"), TRAIN_BAND, _VANILLA_EVAL),
    "ref": (("-t", "--name", "ref_1"), per_step("ref"), REF_TRAIN_BAND,
            dict.fromkeys(REF_KERNELS, 1)),
    "hybrid": (("-t", "--ref_kernels", "hybrid", "--name", "hybrid_1"),
               per_step("hybrid"), REF_TRAIN_BAND,
               dict.fromkeys(("prop_mlp_fwd", "ref_spa_fwd"), 1)),
    # Mip-NeRF: the coarse and the fine pass of one net, no proposal net
    "mip": (("-m", "--name", "mip_1"), per_step("mip"), TRAIN_BAND,
            {"vanilla_mlp_fwd": 2}),
    # the vanilla model with the IPE fine net: the vanilla launches
    "ipe": (("--use_ipe", "--name", "ipe_1"), per_step("vanilla"),
            TRAIN_BAND, _VANILLA_EVAL)}


def route_launches(model: str, steps: int, chunks: int) -> dict:
    """Every kernel's launches in a train run of ``model``'s route of
    ``steps`` steps and an eval render of ``chunks`` chunks."""
    _, step, _, chunk = ROUTES[model]
    want = dict.fromkeys(ops.LAUNCHES, 0)
    for counts, times in ((step, steps), (chunk, chunks)):
        for k, c in counts.items():
            want[k] += c * times
    return want


def run_train(tmp: str, model: str = "vanilla"):
    """``python -m nerf_tpu_torch [-t [--ref_kernels hybrid] | -m] --epochs
    5 -s -w`` on the 20-view train split, through the kernels and through
    the nn.Module route (``--no_pallas``, its checkpoint under another
    name): launches per step of each training kernel (and by body, for the
    kernels that report one, each on the frame's two consumer warpgroups),
    and the two routes' loss curves."""
    flags, kernels, band_lim, _ = ROUTES[model]
    steps = TRAIN_VIEWS * TRAIN_EPOCHS
    eval_chunks = math.ceil(400 * 400 / CHUNK)   # one test view, at the end
    runs = {"plain": train_once(tmp, f"{model}_plain", *flags, "--no_pallas",
                                "--name", f"{model}_plain_route"),
            "kernels": train_once(tmp, f"{model}_kernels", *flags)}
    want = route_launches(model, 0, eval_chunks)
    if runs["plain"][0] != want:
        fail(f"{model} train path --no_pallas launches {runs['plain'][0]}, "
             f"expected {want}")
    want = route_launches(model, steps, eval_chunks)
    launches, losses, mses, wall = runs["kernels"]
    if launches != want:
        fail(f"{model} train path launches {launches}, expected {want}")
    bodies = EPOCH_RUNS[f"{model}_kernels"]["bodies"]
    for k in frame_launched(launches):
        if bodies.get(k) != {BODY_KERNELS[k]: launches[k]}:
            fail(f"{model} train path: {k} ran {bodies.get(k)}, not "
                 f"{BODY_KERNELS[k]} alone")
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
    # a reading: where the per-step image MSEs of the two routes part
    step_rel = [abs(k / p - 1.0) for k, p in zip(runs["kernels"][2],
                                                 runs["plain"][2])]
    parting = next((i for i, r in enumerate(step_rel) if r > 1e-2), None)
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if not last < first:
        fail(f"{model} train path: loss did not fall ({first} -> {last})")
    for route, c in curves.items():
        if not c["img_mse"][-1] < c["img_mse"][0]:
            fail(f"{model} train path: the image MSE of the {route} route "
                 f"did not fall: {curves}")
    return dict(command="python -m nerf_tpu_torch " + " ".join(
        a if "/" not in a else "<tmp>" for a in train_argv(tmp, *flags)),
        steps=steps, launches=launches, bodies=bodies,
        launches_per_step={k: launches[k] / steps for k in kernels},
        loss_first10=first, loss_last10=last, epoch_means=curves,
        kernels_vs_plain_rel=band, band=band_lim,
        img_mse_step_rel_max=[max(step_rel[i:i + TRAIN_VIEWS])
                              for i in range(0, steps, TRAIN_VIEWS)],
        first_step_over_1pct=parting, img_mse_steps={
            route: r[2][parting:parting + 5] for route, r in runs.items()}
        if parting is not None else None, s_entry=wall,
        s_entry_plain=runs["plain"][3])


def render_trained(tmp: str, model: str = "vanilla"):
    """``-r -e -s -w`` (Ref-NeRF: ``-t ... --render_normal``, the hybrid
    route with ``--ref_kernels hybrid``, Mip-NeRF ``-m``, IPE
    ``--use_ipe``) on the checkpoint the train phase wrote: each eval kernel
    of the route launches once per chunk (Mip-NeRF's twice), no other
    kernel, each that reports a body on the frame's two consumer
    warpgroups (the launches by body); the seconds of the entry (one
    400x400 frame, the data and the model loaded)."""
    ref = model in ("ref", "hybrid")
    flags = ROUTES[model][0]
    argv = list(flags) + ["-r", "-e", "-s", "-w", "--dataset_root",
                    os.path.join(tmp, "data"), "--dataset_name", "lego",
                    "--output_dir", os.path.join(tmp, "output")] \
        + (["--render_normal"] if ref else [])
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cwd(tmp):
        rc = entry_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_chunks = math.ceil(400 * 400 / CHUNK)
    want = route_launches(model, 0, n_chunks)
    if rc != 0 or launches != want:
        fail(f"render of the trained {model} checkpoint: rc {rc}, launches "
             f"{launches}, expected {want}")
    bodies = launched_bodies(launches, frame_launched(launches))
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
        bodies=bodies, normal_panel_std=normal_std, s_entry=wall)


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


# ---------------------------------------------------------------------------
# phase 21: data and observability (the native image decoder, --trace, the
# trainer's MFU, the orbit GIF)
# ---------------------------------------------------------------------------

DATA_VIEWS = 100                 # lego's train split has 100 800x800 views
PNG_FILTERS = (0, 1, 2, 3, 4)    # every view's rows cycle through all five
BUILTIN_CHECKS = 4               # views also decoded by the built-in decoder
TRACE_EPOCHS = 3                 # --trace records the second
ORBIT_SCALE = 0.125              # 800 -> 100: the 120-frame orbit's size
ORBIT_FRAMES = 120
# the device function that each training kernel's wrapper launches, as the
# trace names it
TRACE_FUNCTIONS = {"vanilla_mlp_fwd_res": "vanilla_frame_kernel",
                   "vanilla_mlp_bwd": "vanilla_delta_kernel",
                   "prop_mlp_fwd": "prop_frame_kernel",
                   "prop_mlp_bwd": "prop_delta_kernel"}
# train_once's console output and logged MFU and epoch times, per route
EPOCH_RUNS = {}
# the runs whose MFU phase 21 holds against the formula: the trace run and
# the kernel routes of phases 7, 8, 11 and 18
MFU_ROUTES = ("trace", "vanilla_kernels", "ref_kernels", "hybrid_kernels",
              "mip_kernels")


def _median_s(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def data_load(tmp: str) -> dict:
    """100 seeded 800x800 RGBA views whose rows cycle through the five PNG
    filters, loaded as the trainer loads lego (img_scale 0.5, -w) by the
    native decoder: the split's seconds, one view's alone on one thread,
    and BUILTIN_CHECKS views through the built-in decoder (utils/png.py and
    the numpy resize, no Pillow), which the native decoder must equal within
    1e-6; where Pillow imports, its seconds and its distance from the native
    decoder (both compute Pillow's resize) as readings."""
    t0 = time.perf_counter()
    write_split(tmp, "train", DATA_VIEWS, np.random.default_rng(21),
                PNG_FILTERS)
    write_split(tmp, "test", 1, np.random.default_rng(22), PNG_FILTERS)
    write_s = time.perf_counter() - t0
    root = os.path.join(tmp, "data", "lego")
    paths = [os.path.join(root, "train", f"r_{i}.png")
             for i in range(DATA_VIEWS)]
    t0 = time.perf_counter()
    data = BlenderDataset.load(root, "train", img_scale=0.5, white_bkg=True)
    split_s = time.perf_counter() - t0
    half = VIEW_HW // 2
    if data.decoder != "native" or data.images.shape != (DATA_VIEWS, half,
                                                         half, 3):
        fail(f"native load: decoder {data.decoder!r}, images "
             f"{data.images.shape}")
    if not (np.isfinite(data.images).all() and data.images.min() >= 0.0
            and data.images.max() <= 1.0):
        fail("native load: pixels outside [0, 1]")
    one_s = _median_s(lambda: native.decode_images(paths[:1], 0.5, True,
                                                   n_threads=1))
    full_s = _median_s(lambda: native.decode_images(paths[:1], 1.0, True,
                                                    n_threads=1))
    pillow = blender.pillow
    blender.pillow = lambda: None
    try:
        t0 = time.perf_counter()
        plain, decoder = blender._load_plain(paths[:BUILTIN_CHECKS], 0.5,
                                             True)
        builtin_s = (time.perf_counter() - t0) / BUILTIN_CHECKS
    finally:
        blender.pillow = pillow
    err = float(np.abs(data.images[:BUILTIN_CHECKS] - plain).max())
    if "built-in" not in decoder or not err <= 1e-6:
        fail(f"native load against the built-in decoder ({decoder}): max "
             f"abs err {err}, limit 1e-6")
    # a reading where Pillow imports: the loader it stands in for
    pillow_s = pillow_err = None
    if blender.pillow() is not None:
        t0 = time.perf_counter()
        with_pil, _ = blender._load_plain(paths[:BUILTIN_CHECKS], 0.5, True)
        pillow_s = (time.perf_counter() - t0) / BUILTIN_CHECKS
        pillow_err = float(np.abs(data.images[:BUILTIN_CHECKS]
                                  - with_pil).max())
    return dict(views=DATA_VIEWS, hw=[VIEW_HW, VIEW_HW], img_scale=0.5,
                filters=list(PNG_FILTERS), host_cpus=os.cpu_count(),
                write_s=write_s, native_split_s=split_s,
                native_s_per_view_in_split=split_s / DATA_VIEWS,
                native_s_one_view_one_thread=one_s,
                native_s_one_view_full_size=full_s,
                builtin_s_per_view=builtin_s,
                builtin_over_native_one_thread=builtin_s / one_s,
                builtin_views_checked=BUILTIN_CHECKS,
                native_vs_builtin_max_abs=err, tol=1e-6,
                pillow_s_per_view=pillow_s,
                native_vs_pillow_max_abs=pillow_err)


def trace_run(tmp: str) -> dict:
    """``python -m nerf_tpu_torch -s -w --epochs 3 --trace DIR`` on 20 of
    the 100 views: one Chrome trace of the second epoch, whose kernel
    events must name each training kernel's device function once a step or
    more; the run's launches as the train phase's."""
    src = os.path.join(tmp, "data", "lego")
    sub = os.path.join(tmp, "trace")
    scene = os.path.join(sub, "data", "lego")
    os.makedirs(os.path.join(scene, "train"))
    shutil.copytree(os.path.join(src, "test"), os.path.join(scene, "test"))
    shutil.copy(os.path.join(src, "transforms_test.json"), scene)
    with open(os.path.join(src, "transforms_train.json")) as f:
        meta = json.load(f)
    meta["frames"] = meta["frames"][:TRAIN_VIEWS]
    with open(os.path.join(scene, "transforms_train.json"), "w") as f:
        json.dump(meta, f)
    for i in range(TRAIN_VIEWS):
        os.link(os.path.join(src, "train", f"r_{i}.png"),
                os.path.join(scene, "train", f"r_{i}.png"))
    trace_dir = os.path.join(sub, "trace")
    launches, _, _, wall = train_once(sub, "trace", "--trace", trace_dir,
                                      "--name", "trace_1",
                                      epochs=TRACE_EPOCHS)
    want = route_launches("vanilla", TRAIN_VIEWS * TRACE_EPOCHS,
                          math.ceil((VIEW_HW // 2) ** 2 / CHUNK))
    if launches != want:
        fail(f"--trace run launches {launches}, expected {want}")
    if f"profiler trace written to {trace_dir}" not in \
            EPOCH_RUNS["trace"]["output"]:
        fail("--trace run: no 'profiler trace written to' line")
    files = sorted(os.listdir(trace_dir))
    if files != ["rank0.pt.trace.json"]:
        fail(f"--trace wrote {files}, expected rank0.pt.trace.json")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(fn in e.get("name", "") for e in kernels)
              for k, fn in TRACE_FUNCTIONS.items()}
    if any(c < TRAIN_VIEWS for c in counts.values()):
        fail(f"--trace: kernel events per device function {counts}, "
             f"expected {TRAIN_VIEWS} (one a step) or more each")
    steps = [e for e in events if e.get("name") == "Optimizer.step#Adam.step"
             and e.get("ph") == "X"]
    span_us = (max(e["ts"] + e.get("dur", 0) for e in kernels)
               - min(e["ts"] for e in kernels))
    kernel_us = sum(e.get("dur", 0) for e in kernels)
    return dict(command="python -m nerf_tpu_torch -s -w --epochs "
                f"{TRACE_EPOCHS} --trace <dir>", steps=TRAIN_VIEWS *
                TRACE_EPOCHS, traced_steps=len(steps), launches=launches,
                trace_mb=os.path.getsize(path) / 1e6, events=len(events),
                kernel_events=len(kernels), kernel_events_named=counts,
                functions=TRACE_FUNCTIONS, kernel_ms=kernel_us / 1e3,
                kernel_span_ms=span_us / 1e3,
                kernel_busy_share=kernel_us / max(span_us, 1),
                s_entry=wall)


EPOCH_LINE = re.compile(r"Epoch +(\d+) / +\d+\t.*\t([\d,]+) rays/s\t"
                        r"MFU: ([\d.]+)%\tETA")


def mfu_check(route: str) -> dict:
    """The MFU of each epoch line and of the metrics log of a train run
    against the formula: rays/s / ray_batch x the step's FLOPs (counted on
    the route's models) / the H100's dense bf16 peak.  The printed one must
    be the formula on the printed rays/s to its one decimal, the logged one
    steps / Time/epoch x FLOPs / peak."""
    run = EPOCH_RUNS.get(route)
    if run is None:
        fail(f"MFU: no train run of route {route}")
    cfg = config_from_args(get_parser().parse_args(
        train_argv("/data", *run["flags"], epochs=run["epochs"])))
    step_flops = train_step_flops(cfg, make_models(cfg, "cpu"))
    lines = EPOCH_LINE.findall(run["output"])
    if [int(ep) for ep, _, _ in lines] != list(range(run["epochs"])) or \
            len(run["mfu"]) != run["epochs"]:
        fail(f"MFU of {route}: epoch lines {lines}, logged {run['mfu']}")
    printed, logged, rays = [], [], []
    for (_, r, p), (_, m), (_, dt) in zip(lines, run["mfu"], run["time"]):
        r, p = int(r.replace(",", "")), float(p)
        want = r / cfg.ray_batch * step_flops / H100_BF16_PEAK * 100.0
        want_log = TRAIN_VIEWS / dt * step_flops / H100_BF16_PEAK
        if not (abs(p - want) <= 0.05 + 1e-9 and want > 0.0
                and abs(m - want_log) <= 1e-9 * want_log):
            fail(f"MFU of {route}: printed {p}% at {r} rays/s, formula "
                 f"{want}%; logged {m}, formula {want_log}")
        printed.append(p)
        logged.append(m * 100.0)
        rays.append(r)
    return dict(route=route, model=cfg.model, flops_per_step=step_flops,
                peak_flops=H100_BF16_PEAK, rays_per_s=rays,
                mfu_pct_printed=printed, mfu_pct_logged=logged)


def gif_blocks(data: bytes) -> dict:
    """The frames, delays (hundredths of a second) and loop count of a
    GIF89a, read block by block."""
    if data[:6] != b"GIF89a":
        fail(f"orbit.gif: header {data[:6]!r}")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 * 2 ** ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, delays, loop, sizes = 0, [], None, set()

    def sub_blocks(pos):
        blocks = []
        while data[pos]:
            blocks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return blocks, pos + 1

    while data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            label = data[pos + 1]
            blocks, pos = sub_blocks(pos + 2)
            if label == 0xF9:
                delays.append(struct.unpack("<H", blocks[0][1:3])[0])
            elif label == 0xFF and blocks[0] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", blocks[1][1:3])[0]
        elif kind == 0x2C:
            _, _, fw, fh, packed = struct.unpack("<HHHHB",
                                                 data[pos + 1:pos + 10])
            sizes.add((fw, fh))
            pos += 10 + (3 * 2 ** ((packed & 7) + 1) if packed & 0x80 else 0)
            _, pos = sub_blocks(pos + 1)     # after the LZW code size
            frames += 1
        else:
            fail(f"orbit.gif: unknown block 0x{kind:02x} at byte {pos}")
    return dict(width=w, height=h, frames=frames, delays_cs=delays,
                loop=loop, frame_sizes=sorted(sizes), bytes=len(data))


def orbit_gif(tmp: str) -> dict:
    """``-r -s -w --img_scale 0.125`` on the trace run's checkpoint: the
    120 orbit frames at 100x100, each chunk through the eval kernels, and
    ``orbit.gif`` with 120 frames of 5 hundredths of a second, looped; the
    GIF write timed (quantizer and LZW)."""
    sub = os.path.join(tmp, "trace")
    argv = ["-r", "-s", "-w", "--dataset_root", os.path.join(sub, "data"),
            "--dataset_name", "lego", "--img_scale", str(ORBIT_SCALE),
            "--name", "trace_1", "--output_dir", os.path.join(sub, "output")]
    write_gif, gif_s = render_mod.write_gif, []

    def timed_write_gif(*args, **kw):
        t0 = time.perf_counter()
        out = write_gif(*args, **kw)
        gif_s.append(time.perf_counter() - t0)
        return out

    render_mod.write_gif = timed_write_gif
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with cwd(sub):
            rc = entry_main(argv)
    finally:
        render_mod.write_gif = write_gif
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    side = int(VIEW_HW * ORBIT_SCALE)
    want = route_launches("vanilla", 0, ORBIT_FRAMES * math.ceil(
        side * side / CHUNK))
    if rc != 0 or launches != want or len(gif_s) != 1:
        fail(f"orbit render: rc {rc}, launches {launches}, expected {want}, "
             f"GIF writes {len(gif_s)}")
    path = os.path.join(sub, "output", "sphere", "orbit.gif")
    with open(path, "rb") as f:
        blocks = gif_blocks(f.read())
    if (blocks["frames"] != ORBIT_FRAMES or blocks["loop"] != 0
            or blocks["delays_cs"] != [5] * ORBIT_FRAMES
            or blocks["frame_sizes"] != [(side, side)]
            or (blocks["width"], blocks["height"]) != (side, side)):
        fail(f"orbit.gif: {blocks['frames']} frames of "
             f"{blocks['frame_sizes']}, delays "
             f"{sorted(set(blocks['delays_cs']))}, loop {blocks['loop']}")
    return dict(command="python -m nerf_tpu_torch -r -s -w --img_scale "
                f"{ORBIT_SCALE}", launches=launches, frames=blocks["frames"],
                hw=[side, side], delays_cs=sorted(set(blocks["delays_cs"])),
                loop=blocks["loop"], gif_bytes=blocks["bytes"],
                gif_write_s=gif_s[0],
                gif_write_ms_per_frame=gif_s[0] * 1e3 / ORBIT_FRAMES,
                s_entry=wall)


# ---------------------------------------------------------------------------
# phase 19: the trainer's operations shell (resume, the rotating window, the
# SIGTERM save, render-only's fallback, -b, the one-epoch-deep read-back)
# ---------------------------------------------------------------------------

RESUME_STEPS = 3        # N: 2N steps straight against N, save, load, N
SHELL_EPOCHS = 5        # the SIGTERM drill's run


def _params(models) -> list:
    return [(f"{net}.{k}", p) for net, m in zip(NETS, models)
            if m is not None for k, p in m.named_parameters()]


@torch.no_grad()
def _max_abs(a_models, b_models) -> dict:
    """{parameter: max |a - b|} of the parameters that differ."""
    out = {}
    for (name, p), (_, q) in zip(_params(a_models), _params(b_models)):
        d = float((p - q).abs().max())
        if d != 0.0 or not torch.equal(p, q):
            out[name] = d
    return out


def resume_step(tmp: str, model: str):
    """A default bf16 step of ``model`` through the kernels, 2N steps
    straight (twice: is the straight run itself repeatable?) against N
    steps, a save through CheckpointManager, a load into fresh modules,
    optimizer and generator, and N more: the params must be equal bit for
    bit.  Pixels and noise are drawn from the generator, as in the trainer,
    on a 4-view 400x400 pool drawn from a seed.  Also the slot's size and
    its save and load ms (median of 3, each ending in a synchronize)."""
    focal = fov_to_focal(LEGO_FOV, (400, 400))
    cfg = finalize_config(PipelineConfig(model=model, use_bf16=True), focal)
    g = torch.Generator(device="cuda").manual_seed(31)
    pool = torch.rand((4, 400 * 400, 3), generator=g, device="cuda")
    poses = torch.tensor(np.stack([pose_spherical(a, -30.0, 4.0)[:3]
                                   for a in (0.0, 90.0, 180.0, 270.0)]),
                         dtype=torch.float32, device="cuda")
    lr = schedule_lib.decay_schedule(5e-4, warmup_step=0)

    def fresh(seed):
        models = make_models(cfg, "cuda", torch.Generator().manual_seed(seed))
        return (models, make_optimizer(models),
                torch.Generator(device="cuda").manual_seed(seed))

    def run(state, i0, i1):
        models, opt, gen = state
        for i in range(i0, i1):
            rays, gt = sample_train_rays(pool, poses, i % 4, (400, 400),
                                         focal, RAYS, generator=gen)
            train_step(models, opt, rays, gt, cfg, lr(i), generator=gen,
                       device="cuda")
        torch.cuda.synchronize()

    ops.reset_launches()
    straight, repeat = fresh(0), fresh(0)
    run(straight, 0, 2 * RESUME_STEPS)
    run(repeat, 0, 2 * RESUME_STEPS)
    first = fresh(0)
    run(first, 0, RESUME_STEPS)
    mgr = CheckpointManager(os.path.join(tmp, "resume", model),
                            prefix=f"{model}_chkpt")
    save_ms, load_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(*first, step=RESUME_STEPS, epoch=0)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    resumed = fresh(7)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(mgr.latest_path(), *resumed)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    run(resumed, RESUME_STEPS, 2 * RESUME_STEPS)
    launches = dict(ops.LAUNCHES)
    steps = 6 * RESUME_STEPS
    want = {k: c * steps for k, c in per_step(model).items()}
    if {k: launches[k] for k in want} != want:
        fail(f"resume_step {model}: launches {launches}, expected {want}")
    repeat_diff = _max_abs(straight[0], repeat[0])
    resume_diff = _max_abs(straight[0], resumed[0])
    res = dict(model=model, steps=2 * RESUME_STEPS, launches=launches,
               straight_repeat_equal=not repeat_diff,
               straight_repeat_max_abs=repeat_diff,
               resume_equal=not resume_diff, resume_max_abs=resume_diff,
               slot_mb=os.path.getsize(path) / 1e6,
               param_mb=sum(p.numel() * 4 for _, p in _params(first[0]))
               / 1e6, save_ms=statistics.median(save_ms),
               load_ms=statistics.median(load_ms), save_ms_all=save_ms,
               load_ms_all=load_ms)
    if resume_diff:
        fail(f"resume_step {model}: the resumed params part from the "
             f"straight run's: {res}")
    return res


def sigterm_drill(tmp: str):
    """``python -m nerf_tpu_torch -s -w --epochs 5 --ckpt_dir D --max_save
    2`` in a subprocess on the card, SIGTERM once the first epoch's line is
    printed: exit 143, a slot whose index holds step (epoch + 1) x 20 of an
    epoch before the last, and the seconds from the signal to the exit.
    Then ``-l`` in this process runs the saved epoch again and the rest
    through the kernels: each training kernel launches its count a step
    times the steps, each eval forward once a chunk of the final render."""
    ckpt = os.path.join(tmp, "ckpt_drill")
    argv = train_argv(tmp, "--log_dir", os.path.join(tmp, "logs", "drill"),
                      "--ckpt_dir", ckpt, "--max_save", "2", "--name",
                      "drill_1", "--output_time", "100000",
                      epochs=SHELL_EPOCHS)
    with open(os.path.join(tmp, "drill.err"), "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "nerf_tpu_torch", *argv], cwd=tmp,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=err, text=True)
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("Epoch    0 /"):
                    break
            t_sig = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            lines.append(proc.communicate(timeout=600)[0])
            exit_s = time.perf_counter() - t_sig
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        stderr = err.read()
    stdout = "".join(lines)
    idx_path = os.path.join(ckpt, "lego", "drill_1_chkpt_index.json")
    if proc.returncode != 128 + signal.SIGTERM or not os.path.exists(
            idx_path):
        fail(f"SIGTERM drill: rc {proc.returncode}, stdout {stdout[-2000:]}"
             f", stderr {stderr[-2000:]}")
    with open(idx_path) as f:
        idx = json.load(f)
    if not (idx["step"] == (idx["epoch"] + 1) * TRAIN_VIEWS
            and idx["epoch"] < SHELL_EPOCHS - 1 and idx["count"] == 1
            and f"checkpointed step {idx['step']}, epoch {idx['epoch']}"
            in stdout):
        fail(f"SIGTERM drill: index {idx}, stdout {stdout[-2000:]}")
    ops.reset_launches()
    with cwd(tmp):
        rc = entry_main(argv + ["-l"])
    launches = dict(ops.LAUNCHES)
    steps = (SHELL_EPOCHS - idx["epoch"]) * TRAIN_VIEWS
    want = route_launches("vanilla", steps, math.ceil(400 * 400 / CHUNK))
    final = torch.load(os.path.join(tmp, "model", "drill_1_mip.pt"),
                       weights_only=True)
    # the saved epoch runs again, as in nerf_tpu
    if rc != 0 or launches != want or \
            final["train_cnt"] != idx["step"] + steps:
        fail(f"-l after the SIGTERM drill: rc {rc}, launches {launches}, "
             f"expected {want}, train_cnt {final['train_cnt']}")
    return dict(command="python -m nerf_tpu_torch " + " ".join(
        a if "/" not in a else "<tmp>" for a in argv), rc=proc.returncode,
        index=idx, signal_to_exit_s=exit_s, resumed_steps=steps,
        resumed_launches=launches)


def render_fallback(tmp: str):
    """``-r -e -s -w`` of the drill's run twice: from its
    ``model/drill_1_{mip,prop}.pt``, then with those moved away, from the
    newest slot under ``--ckpt_dir`` (the same weights: the last eval's
    slot and the final save follow the same step).  The frames are equal
    bit for bit, and each eval forward launches once a chunk."""
    import nerf_tpu_torch.cli.render as render_cli

    argv = ["-r", "-e", "-s", "-w", "--dataset_root",
            os.path.join(tmp, "data"), "--dataset_name", "lego", "--name",
            "drill_1", "--ckpt_dir", os.path.join(tmp, "ckpt_drill"),
            "--output_dir", os.path.join(tmp, "output")]
    render = render_cli.render_image
    frames, loaded = {}, {}

    def recording(*a, **kw):
        out = render(*a, **kw)
        frames[source].append(out["rgb"])
        return out

    render_cli.render_image = recording
    try:
        for source in ("pt", "slot"):
            if source == "slot":
                for path in checkpoint_paths("model", "drill_1"):
                    os.replace(os.path.join(tmp, path),
                               os.path.join(tmp, path + ".away"))
            frames[source] = []
            ops.reset_launches()
            with cwd(tmp), contextlib.redirect_stdout(io.StringIO()) as out:
                entry_main(argv)
            loaded[source] = next(ln for ln in out.getvalue().splitlines()
                                  if ln.startswith("Loaded ")
                                  and "(step " in ln)
            want = route_launches("vanilla", 0, math.ceil(400 * 400 / CHUNK))
            if dict(ops.LAUNCHES) != want:
                fail(f"render_fallback ({source}): launches "
                     f"{dict(ops.LAUNCHES)}, expected {want}")
    finally:
        render_cli.render_image = render
    equal = len(frames["pt"]) == len(frames["slot"]) == 1 and all(
        np.array_equal(a, b) for a, b in zip(frames["pt"], frames["slot"]))
    if not equal or "chkpt" not in loaded["slot"]:
        fail(f"render_fallback: frames equal {equal}, loaded {loaded}")
    return dict(loaded=loaded, frames_equal=equal,
                max_abs=float(np.abs(frames["pt"][0]
                                     - frames["slot"][0]).max()))


def debug_run(tmp: str):
    """``-b`` through the entry (2 epochs, an eval at the second): no kernel
    launches; then a NaN planted in one weight of a full-width fine net: a
    default f32 step's loss raises FloatingPointError naming its module."""
    ops.reset_launches()
    t0 = time.perf_counter()
    with cwd(tmp):
        rc = entry_main(train_argv(tmp, "-b", "--name", "debug_1",
                                   "--log_dir", os.path.join(tmp, "logs",
                                                             "debug"),
                                   "--output_time", "1", epochs=2))
    wall = time.perf_counter() - t0
    if rc != 0 or any(ops.LAUNCHES.values()):
        fail(f"-b run: rc {rc}, launches {dict(ops.LAUNCHES)}")
    cfg = PipelineConfig(use_pallas=False)
    models = seeded_models(cfg, 5)
    with torch.no_grad():
        models[0].lin_block2[2].weight[7, 3] = float("nan")
    rays, gt, jitter, u = step_batch()
    try:
        with nan_attribution(models):
            compute_loss(models, rays, gt, cfg, noise=(jitter, u),
                         device="cuda")
        message = None
    except FloatingPointError as e:
        message = str(e)
    if message is None or "of nerf.lin_block2.2 (Dense)" not in message \
            or any(ops.LAUNCHES.values()):
        fail(f"-b planted NaN: {message}, launches {dict(ops.LAUNCHES)}")
    return dict(steps=2 * TRAIN_VIEWS, s_entry=wall, launches=0,
                planted_nan=message)


def epoch_gap(tmp: str):
    """``loop_ab.turn`` on this checkout: the device's idle ms at each of
    three epoch boundaries of ``Trainer.train()`` with the one-epoch-deep
    read-back, the epochs' device periods as rays/s, and the rays/s of
    ``Trainer.run_epoch`` as PERF.md §2 measures them.  ``python3
    loop_ab.py --other <checkout>`` takes the same readings of another
    checkout in turns with this one."""
    return loop_ab.turn(ROOT, loop_ab.loop_argv(sys.modules[__name__], tmp),
                        tmp)


# ---------------------------------------------------------------------------
# phase 18: Mip-NeRF (-m) and the IPE mode (--use_ipe)
# ---------------------------------------------------------------------------

IPE_EPOCHS = 2    # 40 steps and the eval render at the end


def ipe_train(tmp: str):
    """A short ``python -m nerf_tpu_torch --use_ipe --epochs 2 -s -w`` run
    on the train split (the proposal net and the IPE fine net): one launch
    a step of each vanilla training kernel, one a chunk of each eval
    forward, each that reports a body on the frame's two consumer
    warpgroups, finite logged losses."""
    flags = ROUTES["ipe"][0]
    steps = TRAIN_VIEWS * IPE_EPOCHS
    launches, losses, mses, wall = train_once(tmp, "ipe_kernels", *flags,
                                              epochs=IPE_EPOCHS)
    want = route_launches("ipe", steps, math.ceil(400 * 400 / CHUNK))
    if launches != want:
        fail(f"--use_ipe train run launches {launches}, expected {want}")
    bodies = EPOCH_RUNS["ipe_kernels"]["bodies"]
    for k in frame_launched(launches):
        if bodies.get(k) != {BODY_KERNELS[k]: launches[k]}:
            fail(f"--use_ipe train run: {k} ran {bodies.get(k)}, not "
                 f"{BODY_KERNELS[k]} alone")
    return dict(command="python -m nerf_tpu_torch " + " ".join(
        a if "/" not in a else "<tmp>" for a in train_argv(
            tmp, *flags, epochs=IPE_EPOCHS)), steps=steps, launches=launches,
        bodies=bodies,
        loss_first10=statistics.mean(losses[:10]),
        loss_last10=statistics.mean(losses[-10:]),
        img_mse_epoch_means=epoch_means(mses), s_entry=wall)


def mip_kernel_checks():
    """The vanilla kernels on the Mip-NeRF path's own operands (MIP_KERNELS,
    ``ipe_encodings``; a generator of their own), bf16 and f32, held as
    phase 3 holds them, the bf16 backwards with their planted faults."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = []
    for name, ipe in MIP_KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            out.append(check_kernel(name, dtype, gen, ipe=ipe))
            emit("mip_kernels", **out[-1])
            torch.cuda.empty_cache()
    return out


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


def wgrad_entry(name, meta, wgrad, train_launches, ref_train_launches):
    """The kernels line's entry of the weight-grad pass: the vanilla list
    (the default vanilla step's fine net) at the top, every list beside it;
    ``launches`` counts this entry's launches in the wgrad phase, and
    ``backward_launches_train`` / ``_ref_train`` the backward kernels (each
    running the pass once a chunk) on the train paths."""
    top = wgrad["lists"]["vanilla"]
    keys = ("max_abs_err", "grad_rel_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "tflops")
    bwd = ("vanilla_mlp_bwd", "prop_mlp_bwd", "ref_spa_bwd", "ref_dir_bwd")
    return dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=wgrad["launches"],
        backward_launches_train={k: train_launches[k] for k in bwd},
        backward_launches_ref_train={k: ref_train_launches[k] for k in bwd},
        **{k: top[k] for k in keys}, tol=top["tol"], n=top["n"],
        per_step=wgrad["per_step"],
        lists={k: {x: v[x] for x in keys} for k, v in
               wgrad["lists"].items()})


def dense_entry(name, meta, dense):
    """The kernels line's entry of the layer tile: the 256 -> 256 layer at
    an eval chunk's rows at the top, every timed shape beside it;
    ``launches`` counts this entry's launches in the dense phase."""
    top = next(r for r in dense["timed"] if r["k"] == [256]
               and r["n_out"] == 256 and r["n"] == DENSE_N[0])
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops")
    f32 = next(r for r in dense["f32"] if r["k"] == [256]
               and r["n_out"] == 256)
    return dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=dense["launches"],
        **{k: top[k] for k in keys}, tol=top["tol"], n=top["n"],
        f32={k: f32[k] for k in keys},
        shapes={f"{'+'.join(map(str, r['k']))}->{r['n_out']} n={r['n']}":
                {k: r[k] for k in keys} for r in dense["timed"]})


def delta_entry(name, meta, delta):
    """The kernels line's entry of the delta pass: the 256 -> 256 trunk layer
    (masked by its stored activation) at a Ref-NeRF step's rows at the top,
    every timed shape and form beside it; ``launches`` counts this entry's
    launches in the delta phase."""
    top = next(r for r in delta["timed"] if r["k"] == 256
               and r["n_out"] == 256 and r["form"] == "act"
               and r["n"] == DELTA_N[1])
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops")
    f32 = next(r for r in delta["f32"] if r["k"] == 256
               and r["n_out"] == 256 and r["form"] == "act")
    return dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=delta["launches"],
        **{k: top[k] for k in keys}, tol=top["tol"], n=top["n"],
        f32={k: f32[k] for k in keys},
        shapes={f"{r['k']}->{r['n_out']} {r['form']} n={r['n']}":
                {k: r[k] for k in keys} for r in delta["timed"]})


# the kernels that run dense_tile (mlp_tile.cuh), by the name in their
# mangled symbol: the fused forwards, the rebuilds of the recompute
# backwards and of prop_mlp_bwd (prop_delta_kernel<true, T>), the tile's
# own entry
TILE_KERNELS = ("prop_mlp_fwd_kernel", "vanilla_mlp_fwd_kernel",
                "ref_spa_fwd_kernel", "ref_spa_fwd_res_kernel",
                "ref_dir_fwd_kernel", "prop_delta_kernelILb1E",
                "vanilla_recompute_kernel", "ref_spa_recompute_kernel",
                "ref_dir_recompute_kernel", "dense_layer_kernel")
# the kernels that run the delta pass (delta_tile) and no dense_tile: the
# residual backwards' delta passes and the pass's own entry
DELTA_KERNELS = ("vanilla_delta_kernel", "prop_delta_kernelILb0E",
                 "ref_spa_delta_kernel", "ref_dir_delta_kernel",
                 "delta_layer_kernel")
# the bf16 kernels that run dense_tile and a delta pass with a narrow head
# (the rebuilding backwards, the density gradient), by library and
# demangled name.  Every bf16 kernel that runs the delta pass holds HGMMA
# (its trunk passes' wgmma) and, but for the proposal net's (HEADLESS:
# its only head, the K = 1 term, multiplies no delta), HMMA (its narrow
# heads' mma.sync); every other bf16 kernel of TILE_KERNELS holds HGMMA and
# no HMMA.  (The dissection's recompute-only stage, mode 0, runs no delta
# pass.)
HEADLESS = ("prop_delta_kernel<true>", "prop_delta_kernel<false>")
# the bf16 persistent frame of the spatial, directional, vanilla and
# proposal forwards (spa_frame.cuh, dir_frame.cuh, vanilla_frame.cuh,
# prop_frame.cuh; ref_fused.cu and
# fused_mlp.cu launch it for bf16, and their 64-row tiles in bf16 too for
# the widths whose frame does not fit) and of the spatial backwards' delta
# passes (spa_bwd_frame.cuh; ref_fused_bwd.cu and ref_fused_recompute.cu):
# each instantiation holds HGMMA and spills nothing, and no HMMA (the
# density column's first pullback is no product there) but in the frames
# that run the narrow heads' pullbacks on mma.sync (FRAME_HEAD_MMA), which
# hold it; each kernel is built once for each of its forms (FRAME_FORMS)
FRAME_KERNELS = ("spa_frame_kernel", "dir_frame_kernel",
                 "vanilla_frame_kernel", "prop_frame_kernel",
                 "spa_bwd_frame_kernel")
FRAME_FORMS = {"spa_frame_kernel": 3, "dir_frame_kernel": 2,
               "vanilla_frame_kernel": 2, "prop_frame_kernel": 2,
               "spa_bwd_frame_kernel": 2}
FRAME_HEAD_MMA = ("spa_bwd_frame_kernel",)
# the frame's forms that must keep no stack frame (the spatial res and grad
# forms keep 96 and 32 bytes)
STACKLESS_FRAMES = ("dir_frame_kernel", "vanilla_frame_kernel",
                    "prop_frame_kernel", "spa_bwd_frame_kernel")
TILE_AND_DELTA = (
    ("fused_mlp_recompute", "vanilla_recompute_kernel<__nv_bfloat16>"),
    ("ref_fused", "ref_spa_fwd_res_kernel<(bool)0, __nv_bfloat16>"),
    ("ref_fused", "ref_spa_fwd_res_kernel<(bool)1, __nv_bfloat16>"),
    ("ref_fused_recompute", "ref_spa_recompute_kernel<__nv_bfloat16>"),
    ("ref_fused_recompute",
     "ref_dir_recompute_kernel<(int)3, __nv_bfloat16>"),
    ("ref_dissect", "ref_dir_recompute_kernel<(int)1, __nv_bfloat16>"),
    ("ref_dissect", "ref_dir_recompute_kernel<(int)2, __nv_bfloat16>"),
    ("ref_dissect", "ref_dir_recompute_kernel<(int)3, __nv_bfloat16>"),
)


def short_name(demangled: str) -> str:
    """A demangled kernel's name and template arguments, without its
    namespace, return type and parameters."""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "",
                  demangled)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        if ch == ">":
            depth -= 1
            if depth == 0:
                return name[:i + 1]
    return name.split("(", 1)[0]


def kernel_label(base: str) -> str:
    """A TILE_KERNELS or DELTA_KERNELS name as the build phase prints it."""
    return base.replace("ILb1E", "<true>").replace("ILb0E", "<false>")


def tile_kernel(func: str):
    """(kernel label, "bf16" or "f32") of a mangled symbol that runs
    dense_tile or delta_tile, else None: the bf16 instantiations carry
    __nv_bfloat16."""
    base = next((k for k in TILE_KERNELS + DELTA_KERNELS + FRAME_KERNELS
                 if k in func), None)
    if base is None:
        return None
    return kernel_label(base), ("bf16" if "__nv_bfloat16" in func else "f32")


def demangle(names):
    """cu++filt's (or c++filt's) demangled names, {} without either."""
    tool = (shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if not tool or not names:
        return {}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {}


def ptxas_by_function(reports, pick):
    """ptxas's lines (registers, shared memory, spills) of each entry
    function that ``pick`` takes, by library and mangled name."""
    out = {}
    for lib, log in reports.items():
        func = None
        for ln in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", ln)
            if m:
                func = m.group(1)
            elif func and pick(func) and ("registers" in ln
                                          or "spill" in ln):
                out.setdefault(lib, {}).setdefault(func, []).append(
                    ln.split(":", 1)[-1].strip())
    return out


def wgrad_ptxas(reports):
    """ptxas's lines for each weight-grad kernel it compiled."""
    return ptxas_by_function(reports, lambda f: "wgrad" in f)


def tile_ptxas(reports):
    """ptxas's registers, shared memory and spills of every kernel that runs
    dense_tile or delta_tile, by "<lib> <demangled name>"."""
    found = ptxas_by_function(reports,
                              lambda f: tile_kernel(f) is not None)
    names = demangle(sorted({f for v in found.values() for f in v}))
    return {f"{lib} {names.get(f, f)}": lines
            for lib, funcs in found.items() for f, lines in funcs.items()}


def sass_mma_counts():
    """The tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma) in
    each built library's SASS (``cuobjdump -sass``): in all, in the
    weight-grad kernels (wgrad_mma_kernel, wgrad_kernel), and in every
    kernel that runs dense_tile or delta_tile: ``tiles`` ("name<dtype>" ->
    [HGMMA, HMMA] of each of its instantiations) and ``functions`` (its
    short_name -> {"HGMMA": n, "HMMA": m, "kernel": its label}); None when
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = {}
    for lib in build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts = {"all": {"HMMA": 0, "HGMMA": 0},
                  "wgrad_mma_kernel": {"HMMA": 0, "HGMMA": 0},
                  "wgrad_kernel": {"HMMA": 0, "HGMMA": 0}, "tiles": {},
                  "functions": {}}
        func, tile, name = "all", None, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                func = next((k for k in ("wgrad_mma_kernel", "wgrad_kernel")
                             if k in ln), "all")
                tile = tile_kernel(ln)
                name = ln.split("Function :", 1)[1].strip()
                if tile is not None:
                    counts["tiles"].setdefault(
                        f"{tile[0]}<{tile[1]}>", []).append([0, 0])
                    counts["functions"][name] = {"HGMMA": 0, "HMMA": 0,
                                                 "kernel": tile[0]}
            for i, op in enumerate(("HGMMA", "HMMA")):
                if re.search(rf"\b{op}\.", ln):
                    counts[func][op] += 1
                    if func != "all":
                        counts["all"][op] += 1
                    if tile is not None:
                        counts["tiles"][f"{tile[0]}<{tile[1]}>"][-1][i] += 1
                        counts["functions"][name][op] += 1
                    break
        names = demangle(list(counts["functions"]))
        counts["functions"] = {short_name(names.get(f, f)): c
                               for f, c in counts["functions"].items()}
        out[lib] = counts
    return out


def delta_build(reports, mma):
    """For every bf16 kernel that runs the delta pass, by "<lib> <short
    demangled name>": ptxas's registers and spill bytes (stores, loads)
    and the HGMMA (its trunk passes' wgmma) and HMMA (its heads' mma.sync)
    in its SASS; fails where ptxas reports a spill."""
    found = ptxas_by_function(reports, lambda f: tile_kernel(f) is not None
                              and "__nv_bfloat16" in f)
    names = demangle(sorted({f for v in found.values() for f in v}))
    out = {}
    for lib, funcs in found.items():
        for f, lines in funcs.items():
            name = short_name(names.get(f, f))
            c = (mma or {}).get(lib, {}).get("functions", {}).get(name)
            label = tile_kernel(f)[0]
            if label in FRAME_KERNELS:
                continue
            delta = (label not in {kernel_label(k) for k in TILE_KERNELS}
                     or label in HEADLESS or (lib, name) in TILE_AND_DELTA)
            if not delta:
                continue
            text = " ".join(lines)
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", text)
            r = dict(registers=int(regs.group(1)) if regs else None,
                     spill_bytes=[int(spill.group(1)), int(spill.group(2))]
                     if spill else None,
                     HGMMA=c["HGMMA"] if c else None,
                     HMMA=c["HMMA"] if c else None)
            out[f"{lib} {name}"] = r
            if r["spill_bytes"] and sum(r["spill_bytes"]):
                fail(f"{lib} {name} spills: {r}")
    return out


def wgrad_build(reports, mma):
    """For each library's bf16 weight-grad body (wgrad_mma_kernel) that this
    process compiled: ptxas's registers and spill bytes (stores, loads) and
    the HGMMA (its wgmma) and HMMA (mma.sync) in its SASS; fails where
    ptxas reports a spill.  Every library of WGRAD_LIBS must hold the body
    with HGMMA and no HMMA (check_wgrad_mma)."""
    out = {}
    for lib, funcs in ptxas_by_function(
            reports, lambda f: "wgrad_mma_kernel" in f).items():
        for lines in funcs.values():
            text = " ".join(lines)
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", text)
            c = (mma or {}).get(lib, {}).get("wgrad_mma_kernel")
            r = dict(registers=int(regs.group(1)) if regs else None,
                     spill_bytes=[int(spill.group(1)), int(spill.group(2))]
                     if spill else None,
                     HGMMA=c["HGMMA"] if c else None,
                     HMMA=c["HMMA"] if c else None)
            out[lib] = r
            if r["spill_bytes"] and sum(r["spill_bytes"]):
                fail(f"{lib} wgrad_mma_kernel spills: {r}")
    return out


def check_wgrad_mma(mma):
    """Fail unless the bf16 weight-grad body of every library of WGRAD_LIBS
    holds HGMMA (its wgmma) and no HMMA: no mma.sync is left in the
    pass."""
    for lib in WGRAD_LIBS:
        c = mma[lib]["wgrad_mma_kernel"]
        if not c["HGMMA"] or c["HMMA"]:
            fail(f"{lib}: wgrad_mma_kernel should hold HGMMA and no HMMA: "
                 f"{c}")


def check_tile_mma(mma):
    """Fail unless every bf16 instantiation of a kernel that runs dense_tile
    or delta_tile holds HGMMA (the tile's and the delta pass's trunk
    wgmma), every bf16 one that runs delta_tile but HEADLESS also HMMA
    (its heads' mma.sync), no bf16 kernel that runs the tile alone
    (outside TILE_AND_DELTA) holds HMMA, no f32 one holds either, and
    every such kernel was found: no mma.sync path is left for the tile or
    the delta pass's trunk."""
    seen = set()
    tile_names = {kernel_label(k) for k in TILE_KERNELS}
    for lib, counts in mma.items():
        for key, per in counts["tiles"].items():
            seen.add(key)
            base = key.rsplit("<", 1)[0]
            if key.endswith("<f32>") and any(sum(c) for c in per):
                fail(f"{lib}: an f32 {key} has HGMMA or HMMA in its SASS: "
                     f"{per}")
            if not key.endswith("<bf16>") or base in FRAME_KERNELS:
                continue
            wants = ((0,) if base in tile_names or base in HEADLESS
                     else (0, 1))                      # HGMMA, HMMA
            for want in wants:
                if min(c[want] for c in per) == 0:
                    fail(f"{lib}: a bf16 {key} has no "
                         f"{('HGMMA', 'HMMA')[want]} in its SASS: {per}")
        for func, c in counts["functions"].items():
            if "__nv_bfloat16" not in func or (lib, func) in TILE_AND_DELTA:
                continue
            if c["kernel"] in tile_names and c["HMMA"]:
                fail(f"{lib}: {func} runs the tile alone and holds HMMA: "
                     f"{c}")
    want = {f"{kernel_label(k)}<{d}>" for k in TILE_KERNELS + DELTA_KERNELS
            for d in ("bf16", "f32")}
    want |= {f"{k}<bf16>" for k in FRAME_KERNELS}
    if want - seen:
        fail(f"no SASS found for {sorted(want - seen)}")
    for lib, func in TILE_AND_DELTA:
        c = mma[lib]["functions"].get(func)
        if c is None or not (c["HGMMA"] and c["HMMA"]):
            fail(f"{lib}: {func} should hold HGMMA and HMMA: {c}")
    for lib, counts in mma.items():
        for key, per in counts["tiles"].items():
            if key.endswith("<f32>") and key.rsplit("<", 1)[0] in \
                    FRAME_KERNELS:
                fail(f"{lib}: the frame has an f32 instantiation: {key}")


def frame_build(reports, mma):
    """For each instantiation of the bf16 frame (FRAME_KERNELS: the spatial
    net's three forms, the directional net's two, the vanilla net's two,
    the proposal net's two, the spatial backward's two),
    by "<lib> <short demangled name>": ptxas's registers (the launch's; the
    consumers run at setmaxnreg's 232), stack frame and spill bytes (stores,
    loads) and its remarks that wgmma instructions were serialized, and the
    HGMMA and HMMA in its SASS.  Fails on a spill, on a stack frame in a
    directional, vanilla, proposal or backward form (STACKLESS_FRAMES),
    without HGMMA, on HMMA outside FRAME_HEAD_MMA and without it inside, or
    unless each kernel was built once for each of its forms
    (FRAME_FORMS)."""
    found = ptxas_by_function(reports, lambda f: any(
        k in f for k in FRAME_KERNELS))
    names = demangle(sorted({f for v in found.values() for f in v}))
    out = {}
    for lib, funcs in found.items():
        for f, lines in funcs.items():
            name = short_name(names.get(f, f))
            c = (mma or {}).get(lib, {}).get("functions", {}).get(name)
            text = " ".join(lines)
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", text)
            stack = re.search(r"(\d+) bytes stack frame", text)
            r = dict(registers=int(regs.group(1)) if regs else None,
                     stack_bytes=int(stack.group(1)) if stack else None,
                     spill_bytes=[int(spill.group(1)), int(spill.group(2))]
                     if spill else None,
                     wgmma_serialized=sum(
                         "serialized" in ln and f in ln
                         for ln in reports[lib].splitlines()),
                     HGMMA=c["HGMMA"] if c else None,
                     HMMA=c["HMMA"] if c else None)
            out[f"{lib} {name}"] = r
            if r["spill_bytes"] is None or sum(r["spill_bytes"]):
                fail(f"{lib} {name} spills: {r}")
            if name.startswith(STACKLESS_FRAMES) and r["stack_bytes"] != 0:
                fail(f"{lib} {name} keeps a stack frame: {r}")
            heads = name.startswith(FRAME_HEAD_MMA)
            if mma is not None and (not r["HGMMA"]
                                    or bool(r["HMMA"]) != heads):
                fail(f"{lib} {name} should hold HGMMA and "
                     f"{'HMMA' if heads else 'no HMMA'}: {r}")
    if any(sum(n.split(" ", 1)[1].startswith(k + "<") for n in out)
           != FRAME_FORMS[k] for k in FRAME_KERNELS):
        fail(f"the frame's forms were not each built once: {sorted(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the distributed modes (ddp and ma) on torch.distributed
# ---------------------------------------------------------------------------

DIST_TIMEOUT = 300        # seconds a process of phase 20 may take
TERM_VIEWS = 6            # the SIGTERM drill's split: 3 steps a rank an epoch
MA_METHODS = ("all_reduce", "broadcast", "p2p")
DIST_EPOCHS = 3           # epochs timed in each turn of the readings
SYNC_CALLS = 20           # grad syncs traced and timed alone


def nets_of(models) -> list:
    """The nets' state dicts, on the CPU."""
    return [{k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
            for m in models if m is not None]


def saved_nets(tmp: str, name: str) -> list:
    """The state dicts of ``model/<name>_{mip,prop}.pt`` under ``tmp``."""
    return [torch.load(p, weights_only=True)["model"]
            for p in checkpoint_paths(os.path.join(tmp, "model"), name)
            if os.path.exists(p)]


def nets_diff(a: list, b: list) -> dict:
    """{tensor: max |a - b|} of the tensors that differ ({"nets": ...} when
    the lists differ in length)."""
    if len(a) != len(b):
        return {"nets": [len(a), len(b)]}
    out = {}
    for net, x, y in zip(NETS, a, b):
        for k in x:
            if not torch.equal(x[k], y[k]):
                out[f"{net}.{k}"] = float((x[k] - y[k]).abs().max())
    return out


def start_torchrun(tmp: str, module: str, name: str, *extra: str):
    """``python -m torch.distributed.run --standalone --nproc_per_node=1 -m
    <module>`` with the train phase's flags, ``--name <name>`` and
    ``extra``, started in the background; returns (process, log file)."""
    argv = train_argv(tmp, "--log_dir", os.path.join(tmp, "logs", name),
                      "--name", name, *extra)
    log = open(os.path.join(tmp, f"{name}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", module, *argv], cwd=tmp,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=log,
        stderr=subprocess.STDOUT, text=True)
    return proc, log


def start_ranks(tmp: str, drills, tag: str):
    """Two gloo ranks on cuda:0, ``python3 chip_smoke.py --rank <spec>``,
    each running ``drills`` (RANK_DRILLS) in order; returns [(process, log
    file, results path)]."""
    store = os.path.join(tmp, f"store_{tag}")
    out = []
    for rank in range(2):
        spec = os.path.join(tmp, f"{tag}_{rank}.json")
        result = os.path.join(tmp, f"{tag}_{rank}.pt")
        with open(spec, "w") as f:
            json.dump(dict(rank=rank, store=store, tmp=tmp, drills=drills,
                           out=result), f)
        log = open(os.path.join(tmp, f"{tag}_{rank}.log"), "w+")
        out.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rank",
             spec], cwd=tmp, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=log, stderr=subprocess.STDOUT, text=True), log, result))
    return out


def wait_all(procs, what: str) -> list:
    """Wait for (process, log, ...) tuples within DIST_TIMEOUT; kill every
    process still running then, which fails the phase.  Returns
    [(returncode, log text)]."""
    deadline = time.perf_counter() + DIST_TIMEOUT
    out = []
    try:
        for proc, log, *_ in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fail(f"{what}: a process ran past {DIST_TIMEOUT} s")
    finally:
        for proc, log, *_ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            out.append((proc.returncode, log.read()))
            log.close()
    return out


# --- the ranks' drills (run in ``python3 chip_smoke.py --rank SPEC``) ------

_RANK_DATA = {}


def rank_trainer(spec, mode: str, *extra: str, epochs: int,
                 root: str = "data"):
    """A Trainer of ``mode`` on cuda:0 with the train phase's flags and
    ``extra``, on the split under ``tmp/<root>`` (loaded once a process)."""
    tmp = spec["tmp"]
    parser = ma_parser() if mode == "ma" else ddp_parser()
    args = parser.parse_args(train_argv(
        tmp, "--log_dir", os.path.join(tmp, "logs", f"rank{spec['rank']}"),
        "--dataset_root", os.path.join(tmp, root), *extra, epochs=epochs))
    if root not in _RANK_DATA:
        lego = os.path.join(tmp, root, "lego")
        _RANK_DATA[root] = tuple(BlenderDataset.load(
            lego, split, img_scale=args.img_scale,
            white_bkg=args.white_bkg) for split in ("train", "test"))
    return Trainer(args, "cuda:0", *_RANK_DATA[root], mode=mode)


def drill_sigterm(spec, rank):
    """ddp on the 6-view split; rank 1 alone signals itself after epoch 0:
    both ranks must leave train() with exit 143 after that epoch."""
    t = rank_trainer(spec, "ddp", "--name", "term", "--ckpt_dir",
                     os.path.join(spec["tmp"], "ckpt_term"),
                     "--output_time", "100000", epochs=4, root="term/data")
    if rank == 1:
        run_epoch = t.run_epoch

        def signalled(ep):
            out = run_epoch(ep)
            if ep == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        t.run_epoch = signalled
    t.train()
    return {}


def drill_resume(spec, rank):
    """2 straight epochs on the 6-view split against the SIGTERM drill's
    slot (after epoch 0) resumed by -l for epoch 1: 3 + 3 steps a rank."""
    straight = rank_trainer(spec, "ddp", "--name", "straight",
                            "--output_time", "100000", epochs=2,
                            root="term/data")
    straight.train()
    resumed = rank_trainer(spec, "ddp", "--name", "term", "--ckpt_dir",
                           os.path.join(spec["tmp"], "ckpt_term"), "-l",
                           "--output_time", "100000", epochs=2,
                           root="term/data")
    restored = [resumed.step, resumed.epoch_start]
    resumed.epoch_start += 1      # -l itself runs the saved epoch again
    resumed.train()
    return dict(straight=nets_of(straight.models),
                resumed=nets_of(resumed.models), restored=restored,
                steps=[straight.step, resumed.step])


def sharded_frame(group=None) -> np.ndarray:
    """The 400x400 bf16 frame of ``profile_frame`` (seeded weights and
    noise), sharded over ``group`` when given."""
    cfg = finalize_config(PipelineConfig(white_bkg=True, use_bf16=True),
                          fov_to_focal(LEGO_FOV, (400, 400)))
    models = seeded_models(cfg, 0)
    pose, focal, noise = frame_inputs()
    return render_image(models, pose, (400, 400), focal, cfg, noise=noise,
                        device="cuda", group=group)["rgb"]


def drill_sharded_render(spec, rank):
    """The frame of ``sharded_frame`` over both ranks (a chunk grid of
    2 x 4096 rays), its launches, and its seconds, warm."""
    grid = parallel.make_grid(1, 2, torch.device("cuda", 0))
    ops.reset_launches()

    def frame():
        return sharded_frame(grid.grid_group)

    out = frame()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame()
    return dict(rgb=torch.from_numpy(out), launches=launches,
                frame_s=time.perf_counter() - t0)


def timed_epochs(trainer, first_ep: int, epochs: int = DIST_EPOCHS):
    """ms a step of ``epochs`` epochs of ``trainer.run_epoch`` (each ending
    in a synchronize), median, and the host's issue ms a step."""
    times, issue = [], []
    for ep in range(first_ep, first_ep + epochs):
        steps = len(trainer.epoch_order(ep))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch(ep)
        issue.append((time.perf_counter() - t0) / steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps)
    return statistics.median(times) * 1e3, statistics.median(issue) * 1e3


def drill_ddp(spec, rank, *extra):
    """One epoch of ddp on the 20-view split (10 steps a rank), the eval at
    its end sharded over both ranks; the nets, the launches, then the
    rays/s of a rank over DIST_EPOCHS more epochs and the grad sync alone
    on the grads the last step left, SYNC_CALLS calls traced (device ms a
    call, by kernel: gloo stages CUDA tensors through the host) and timed
    on the host's clock to the end of its device work."""
    from torch.profiler import ProfilerActivity, profile

    t = rank_trainer(spec, "ddp", "--name", "ddp2_nsp" if extra else "ddp2",
                     *extra, epochs=1)
    ops.reset_launches()
    t.train()
    res = dict(nets=nets_of(t.models), steps=t.step, launches={
        k: v for k, v in ops.LAUNCHES.items() if v})
    if not extra:
        ms, issue = timed_epochs(t, 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SYNC_CALLS):
                t.grad_sync()
            torch.cuda.synchronize()
        sync_ms, sync_top = device_times(prof, 6)
        wall = []
        for _ in range(SYNC_CALLS):
            t0 = time.perf_counter()
            t.grad_sync()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        res.update(step_ms=ms, host_issue_ms=issue,
                   rays_per_s_rank=RAYS / (ms * 1e-3),
                   grad_sync_device_ms=(sync_ms / SYNC_CALLS if sync_ms
                                        else None),
                   grad_sync_kernels=[[k, v / SYNC_CALLS]
                                      for k, v in sync_top],
                   grad_sync_wall_ms=statistics.median(wall))
    return res


def drill_ma(spec, rank, method):
    """One epoch of ma over two replicas (10 images each), then the
    averaging (weights 1/2 each) and the eval: the nets before and after
    the averaging, and its seconds."""
    t = rank_trainer(spec, "ma", "--name", f"ma2_{method}", "--ma_epoch",
                     "1", "--ma_method", method, epochs=1)
    seen = {}
    average = t.average

    def recorded(ep):
        seen["before"] = nets_of(t.models)
        seen["seconds"] = average(ep)
        return seen["seconds"]

    t.average = recorded
    t.train()
    return dict(nets=nets_of(t.models), before=seen["before"],
                average_ms=seen["seconds"] * 1e3, weights=[
                    float(w) for w in t.ma_weights])


RANK_DRILLS = {
    "sigterm": drill_sigterm, "resume": drill_resume,
    "sharded_render": drill_sharded_render, "ddp": drill_ddp,
    "ddp_no_sync_prop": lambda spec, rank: drill_ddp(spec, rank,
                                                     "--no_sync_prop"),
    **{f"ma_{m}": (lambda m: lambda spec, rank: drill_ma(spec, rank, m))(m)
       for m in MA_METHODS}}


def rank_main(spec_path: str) -> int:
    """One gloo rank of phase 20 on cuda:0; its results after each drill
    to the spec's ``out``."""
    import datetime

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + spec["store"], rank=spec["rank"],
        world_size=2, timeout=datetime.timedelta(seconds=120))
    results = {}
    with cwd(spec["tmp"]):
        for drill in spec["drills"]:
            results[drill] = RANK_DRILLS[drill](spec, spec["rank"])
            torch.save(results, spec["out"])
    dist.destroy_process_group()
    return 0


# --- the phase, in this process -------------------------------------------

def gloo_refusal(done) -> list:
    """The p2p pair's ends, where a rank failed: gloo's TCP pair refusing
    the send/recv of CUDA memory (an error raised in its ``pair.cc``, a
    ``gloo::IoException``, "Bad address" on one rank at least; its peer may
    see the pair close) is recorded and left out; any other failure fails
    the phase.  Returns each rank's line from ``pair.cc``."""
    lines = [[x.strip() for x in log.splitlines() if "pair.cc" in x]
             for _, log in done]
    if not all(lines[i] for i, (rc, _) in enumerate(done) if rc) or not any(
            "Bad address" in x for found in lines for x in found):
        fail(f"ma p2p: rcs {[rc for rc, _ in done]}, not gloo's refusal of "
             f"CUDA memory: {done[0][1][-2000:]} {done[1][1][-2000:]}")
    return [found[0][:300] if found else "" for found in lines]


def ddp_oracle(tmp: str) -> list:
    """One process: both ranks' rays from their generators (rank_seed) on
    the epoch's images, both backwards through the kernels, (a + b) / 2,
    the clip and Adam, for the 10 steps of the 2-rank ddp drill."""
    args = get_parser().parse_args(train_argv(tmp, epochs=1))
    with cwd(tmp):
        t = Trainer(args, "cuda")
    gens = [torch.Generator(device="cuda").manual_seed(
        parallel.rank_seed(args.seed, r)) for r in range(2)]
    order = epoch_indices("ddp", len(t.train_set), 0, args.seed, 2)
    params = train_parameters(t.models)
    for i in range(order.shape[0]):
        grads = []
        for r in range(2):
            rays, gt = sample_train_rays(
                t.pool, t.poses, int(order[i, 0, r]), t.hw, t.focal,
                t.cfg.ray_batch, crop_window=(
                    t.crop_window if i < args.center_crop_iter else None),
                generator=gens[r])
            t.optimizer.zero_grad(set_to_none=True)
            compute_loss(t.models, rays, gt, t.cfg, generator=gens[r],
                         device="cuda")[0].backward()
            grads.append([p.grad for p in params])
        for p, a, b in zip(params, *grads):
            p.grad = (a + b) / 2
        if args.grad_clip > 0:
            clip_by_global_norm_([p.grad for p in params], args.grad_clip)
        for group in t.optimizer.param_groups:
            group["lr"] = t.schedule(i)
        t.optimizer.step()
    return nets_of(t.models)


def world1_readings(tmp: str) -> dict:
    """NCCL at world size 1 in this process, on the train split: the
    single-device trainer and a ddp trainer in turns (single, ddp, ddp,
    single; DIST_EPOCHS epochs each, ms a step of ``run_epoch`` and host
    issue ms, as PERF.md §2 reads them), neither of which syncs grads (one
    data rank); one ddp epoch traced with torch.profiler; a grad sync over
    the one-rank NCCL data group, built here and called alone, SYNC_CALLS
    calls traced (device ms a call, by kernel) and timed by CUDA events:
    the cost a step would pay for it; the averaging ms of each method
    (median of 5 calls, Time/communication)."""
    from torch.profiler import ProfilerActivity, profile

    args = get_parser().parse_args(train_argv(tmp))
    with cwd(tmp):
        single = Trainer(args, "cuda")
        data = (single.train_set, single.test_set)
        ddp = Trainer(args, "cuda", *data, mode="ddp")
        ma_args = ma_parser().parse_args(train_argv(tmp) + ["--ma_epoch",
                                                            "1"])
        ma = Trainer(ma_args, "cuda", *data, mode="ma")
    backend = dist.get_backend()
    if ddp.grad_sync is not None or ma.grad_sync is not None:
        fail("world-1 ddp and ma built a grad sync over one data rank")
    turns = {"single": [], "ddp": []}
    for tr in (single, ddp):
        tr.run_epoch(0)
    ep = 1
    for name in ("single", "ddp", "ddp", "single"):
        turns[name].append(timed_epochs(single if name == "single" else ddp,
                                        ep))
        ep += DIST_EPOCHS
    steps = len(ddp.epoch_order(ep))
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ddp.run_epoch(ep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    device_ms, top = device_times(prof, 12)
    # a grad sync alone, on the grads the last step left: its kernels
    # (the cat of each net's grads, NCCL's all_reduce, the division)
    sync = parallel.GradSync(ddp.models, ddp.grid.data_group, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SYNC_CALLS):
            sync()
        torch.cuda.synchronize()
    sync_ms, sync_top = device_times(prof, 6)
    sync_events_ms = cuda_ms(sync, SYNC_CALLS)
    ma.writer = MetricsWriter(enabled=False)
    average_ms = {}
    for method in MA_METHODS:
        ma.ma_method = method
        average_ms[method] = statistics.median(
            ma.average(0) * 1e3 for _ in range(5))
    parallel.destroy_process_group()
    med = {k: [statistics.median(x[0] for x in v),
               statistics.median(x[1] for x in v)] for k, v in turns.items()}
    return dict(
        backend=backend, turns={k: [list(x) for x in v]
                                for k, v in turns.items()},
        step_ms={k: v[0] for k, v in med.items()},
        host_issue_ms={k: v[1] for k, v in med.items()},
        rays_per_s={k: RAYS / (v[0] * 1e-3) for k, v in med.items()},
        ddp_vs_single=med["single"][0] / med["ddp"][0],
        profiled_steps=steps, launches=launches,
        device_ms_per_step=(device_ms / steps if device_ms else None),
        device_busy_share=(device_ms / (wall * 1e3) if device_ms else None),
        nccl_sync_alone_device_ms=(sync_ms / SYNC_CALLS if sync_ms
                                   else None),
        nccl_sync_alone_kernels=[[k, v / SYNC_CALLS] for k, v in sync_top],
        nccl_sync_alone_ms_cuda_events=sync_events_ms,
        grad_bytes=4 * sum(p.numel() for p in train_parameters(ddp.models)),
        average_ms=average_ms,
        top_device_ms_per_step=[[k, v / steps] for k, v in top])


def distributed_phase(train_nets: list, ref_nets: list, card: str):
    """Phase 20.  World size 1 through the CLI under torchrun, NCCL, with
    the train phases' flags: ddp, ma --ma_epoch 2 under each method and
    ddp -t, their final nets against the train phases' bit for bit
    (started together with the SIGTERM drill's two gloo ranks); the
    2-rank drills on cuda:0 over gloo (the resume after the SIGTERM drill,
    the sharded frame, ddp and --no_sync_prop against the one-process
    oracle, ma with each method against w0 p0 + w1 p1); the world-1
    readings.  Emits one line a part, each with ``card``, nvidia-smi's
    name and power limit."""
    with tempfile.TemporaryDirectory() as tmp:
        write_train_split(tmp)
        rng = np.random.default_rng(5)
        write_split(os.path.join(tmp, "term"), "train", TERM_VIEWS, rng)
        write_split(os.path.join(tmp, "term"), "test", 1, rng)
        t0 = time.perf_counter()
        runs = {"ddp_1": start_torchrun(tmp, "nerf_tpu_torch.ddp_train",
                                        "ddp_1"),
                "ddp_ref_1": start_torchrun(tmp, "nerf_tpu_torch.ddp_train",
                                            "ddp_ref_1", "-t")}
        for m in MA_METHODS:
            runs[f"ma_{m}"] = start_torchrun(
                tmp, "nerf_tpu_torch.model_average", f"ma_{m}",
                "--ma_epoch", "2", "--ma_method", m)
        term = start_ranks(tmp, ["sigterm"], "term")
        # gloo's send/recv of CUDA memory may fail in its own thread and
        # abort the process: the p2p ring runs in a pair of its own
        p2p = start_ranks(tmp, ["ma_p2p"], "p2p")
        done = dict(zip(runs, wait_all(list(runs.values()), "torchrun")))
        term_done = wait_all(term, "the SIGTERM drill")
        p2p_done = wait_all(p2p, "the p2p averaging")
        world1_s = time.perf_counter() - t0
        world1 = {}
        for name, (rc, log) in done.items():
            want = ref_nets if name == "ddp_ref_1" else train_nets
            diff = nets_diff(saved_nets(tmp, name), want)
            world1[name] = dict(rc=rc, equal=not diff, max_abs=diff,
                                nccl="backend=nccl" in log)
            if rc != 0 or diff or "backend=nccl" not in log:
                fail(f"world-1 {name}: rc {rc}, differs from the single "
                     f"run by {diff}: {log[-3000:]}")
        emit("ddp_world1", card=card, runs=world1, seconds=world1_s,
             commands=["python -m torch.distributed.run --standalone "
                       "--nproc_per_node=1 -m nerf_tpu_torch.ddp_train "
                       "<train flags> [-t]",
                       "... -m nerf_tpu_torch.model_average <train flags> "
                       "--ma_epoch 2 --ma_method {all_reduce,broadcast,p2p}"])
        idx_path = os.path.join(tmp, "ckpt_term", "lego",
                                "term_chkpt_index.json")
        idx = None
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                idx = json.load(f)
        rcs = [rc for rc, _ in term_done]
        if rcs != [128 + signal.SIGTERM] * 2 or idx is None or (
                idx["step"], idx["epoch"], idx["count"]) != (3, 0, 1) \
                or "signal 15: checkpointed step 3, epoch 0" \
                not in term_done[0][1]:
            fail(f"ddp SIGTERM drill: rcs {rcs}, index {idx}: "
                 f"{term_done[0][1][-2000:]} {term_done[1][1][-2000:]}")

        t0 = time.perf_counter()
        drills = ["resume", "sharded_render", "ddp", "ddp_no_sync_prop",
                  "ma_all_reduce", "ma_broadcast"]
        suite = start_ranks(tmp, drills, "suite")
        suite_done = wait_all(suite, "the 2-rank drills")
        suite_s = time.perf_counter() - t0
        got = [torch.load(res, weights_only=False) if os.path.exists(res)
               else {} for _, _, res in suite]
        if any(rc != 0 for rc, _ in suite_done) or any(
                d not in got[r] for r in range(2) for d in drills):
            fail(f"2-rank drills: rcs {[rc for rc, _ in suite_done]}: "
                 f"{suite_done[0][1][-3000:]} {suite_done[1][1][-3000:]}")

        resume = [got[r]["resume"] for r in range(2)]
        resume_diff = [nets_diff(x["resumed"], x["straight"]) for x in resume]
        if any(resume_diff) or [x["restored"] for x in resume] != [[3, 0]] * 2:
            fail(f"ddp SIGTERM resume: restored "
                 f"{[x['restored'] for x in resume]}, 3 + 3 steps part "
                 f"from 6 straight by {resume_diff}")
        emit("ddp_sigterm", card=card, rcs=rcs, index=idx, restored=resume[0][
            "restored"], steps=[x["steps"] for x in resume],
            resume_equal=True)

        frame = sharded_frame()
        render = [got[r]["sharded_render"] for r in range(2)]
        equal = all(np.array_equal(x["rgb"].numpy(), frame) for x in render)
        if not equal or not any(render[0]["launches"].values()):
            fail(f"sharded frame: equal {equal}, launches "
                 f"{render[0]['launches']}")
        emit("sharded_render", card=card, equal=equal, hw=[400, 400], ranks=2,
             launches_rank0=render[0]["launches"],
             frame_s=[x["frame_s"] for x in render])

        oracle = ddp_oracle(tmp)
        ddp = [got[r]["ddp"] for r in range(2)]
        ddp_diff = [nets_diff(x["nets"], oracle) for x in ddp]
        nsp = [got[r]["ddp_no_sync_prop"]["nets"] for r in range(2)]
        nsp_diff = nets_diff(nsp[0], nsp[1])
        prop_only = bool(nsp_diff) and all(k.startswith("prop.")
                                           for k in nsp_diff)
        if any(ddp_diff) or not prop_only or not all(
                ddp[r]["launches"].get("vanilla_mlp_bwd") == 10
                for r in range(2)):
            fail(f"2-rank ddp: against the oracle {ddp_diff}; "
                 f"--no_sync_prop ranks part in {sorted(nsp_diff)}; "
                 f"launches {[x['launches'] for x in ddp]}")
        emit("ddp_two_ranks", card=card, equal_to_oracle=True,
             steps=ddp[0]["steps"],
             launches_rank0=ddp[0]["launches"],
             no_sync_prop_differ=sorted(nsp_diff)[:4] + ["..."],
             no_sync_prop_only_prop=prop_only,
             step_ms=[x["step_ms"] for x in ddp],
             host_issue_ms=[x["host_issue_ms"] for x in ddp],
             rays_per_s_rank=[x["rays_per_s_rank"] for x in ddp],
             grad_sync_device_ms=[x["grad_sync_device_ms"] for x in ddp],
             grad_sync_wall_ms=[x["grad_sync_wall_ms"] for x in ddp],
             grad_sync_kernels_rank0=ddp[0]["grad_sync_kernels"],
             seconds=suite_s)

        ma_res = {}
        p2p_got = [torch.load(res, weights_only=False).get("ma_p2p")
                   if os.path.exists(res) else None for _, _, res in p2p]
        for m in MA_METHODS:
            res = (p2p_got if m == "p2p"
                   else [got[r][f"ma_{m}"] for r in range(2)])
            if m == "p2p" and any(rc for rc, _ in p2p_done):
                ma_res[m] = dict(rcs=[rc for rc, _ in p2p_done],
                                 refused=gloo_refusal(p2p_done))
                continue
            w = res[0]["weights"]
            want = [{k: x[k].cuda() * w[0] + y[k].cuda() * w[1] for k in x}
                    for x, y in zip(res[0]["before"], res[1]["before"])]
            want = [{k: v.cpu() for k, v in n.items()} for n in want]
            diff = [nets_diff(x["nets"], want) for x in res]
            if any(diff):
                fail(f"ma {m}: the averaged nets part from w0 p0 + w1 p1 "
                     f"by {diff}")
            ma_res[m] = dict(equal=True, weights=w,
                             average_ms=[x["average_ms"] for x in res])
        emit("ma_two_ranks", card=card, methods=ma_res)

        emit("dist_readings", card=card, **world1_readings(tmp))


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
    t0 = time.perf_counter()
    native.load()          # the image loader's and the GIF coder's library
    native_build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in reports.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    mma = sass_mma_counts()
    if mma is not None:
        check_wgrad_mma(mma)
        check_tile_mma(mma)
    emit("build", seconds=build_s, native_seconds=native_build_s,
         sources=list(build.SOURCES), ptxas=ptxas,
         ptxas_wgrad=wgrad_ptxas(reports), ptxas_tile=tile_ptxas(reports),
         sass_mma=mma, delta_build=delta_build(reports, mma),
         frame_build=frame_build(reports, mma),
         wgrad_build=wgrad_build(reports, mma))

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {}
    for name in KERNELS:
        # the recompute kernels in phase 10, the rest in phases 12, 14-17
        if name in RECOMPUTE_KERNELS + PROP_RES_KERNELS + DISSECT_KERNELS \
                + ("wgrad_reduce", "dense_layer", "delta_layer"):
            continue
        for dtype in (torch.bfloat16, torch.float32):
            res = check_kernel(name, dtype, gen)
            checks[(name, dtype)] = res
            emit("ref_kernels" if name.startswith("ref") else "kernel", **res)
            torch.cuda.empty_cache()
    emit("spa_frame", **frame_checks())
    emit("dir_frame", **dir_frame_checks())
    # before the vanilla frame's width scan: a library notes the occupancy
    # of its first 32 (kernel, shared memory) pairs, and that scan's
    # launches fill fused_mlp's log
    emit("prop_frame", **prop_frame_checks())
    emit("vanilla_frame", **vanilla_frame_checks())
    emit("kernel_order_sensitivity", **order_sensitivity(gen))
    emit("backward_order_sensitivity", **backward_order_sensitivity())
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("ref_dir_fwd", "ref_dir_bwd"):
            for level, srgb in REF_DIR_VARIANTS:
                emit("ref_kernels", **check_kernel(
                    name, dtype, gen, timed=False, ide_level=level,
                    use_srgb=srgb))
                torch.cuda.empty_cache()

    # phase 4: the render path
    with tempfile.TemporaryDirectory() as tmp:
        render_launches, s_per_frame, _, render_bodies = run_path(tmp)
        emit("path", command="python -m nerf_tpu_torch -r -e -s -w",
             frames=N_FRAMES, hw=[400, 400], launches=render_launches,
             bodies=render_bodies, s_per_frame_entry=s_per_frame)
    diffs, depth_std = frame_check()
    emit("frame", f32_kernels_vs_plain_max_abs=diffs["rgb"], atol=FRAME_ATOL,
         depth_std=depth_std)
    emit("profile", **profile_frame())

    # phase 5: the Ref-NeRF render path
    with tempfile.TemporaryDirectory() as tmp:
        ref_launches, ref_s_per_frame, normal_std, ref_bodies = run_path(
            tmp, "ref")
        emit("ref_path", command="python -m nerf_tpu_torch -t -r -e -s -w "
             "--render_normal", frames=N_FRAMES, hw=[400, 400],
             launches=ref_launches,
             launches_per_frame={k: ref_launches[k] / N_FRAMES
                                 for k in REF_KERNELS},
             bodies=ref_bodies, s_per_frame_entry=ref_s_per_frame,
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
        train_nets = saved_nets(tmp, "model_1")
        emit("train", **train)
        emit("render_trained", **render_trained(tmp))
        emit("train_profile", **profile_trainer(tmp))
        ref_train = run_train(tmp, "ref")
        ref_nets = saved_nets(tmp, "ref_1")
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
    scaling_bodies = launched_bodies(scaling_launches,
                                     frame_launched(scaling_launches))
    emit("batch_scaling_done", seconds=time.perf_counter() - t0,
         launches=scaling_launches, bodies=scaling_bodies)
    for k in PROP_RES_KERNELS:
        if scaling_launches[k] == 0:
            fail(f"the batch-scaling sweep launched {k} no time")

    # phase 14: the directional kernels' dissection
    # (nerf_tpu_torch.tools.bench_ref_kernels --dissect --dissect_fwd)
    t0 = time.perf_counter()
    dissect, dissect_per = dissect_phase()
    emit("dissect", seconds=time.perf_counter() - t0, **dissect)

    # phase 15: the weight-grad pass alone at the default step's job lists
    t0 = time.perf_counter()
    wgrad = wgrad_phase(gen)
    emit("wgrad", seconds=time.perf_counter() - t0, **wgrad)

    # phase 16: the layer tile alone at the main paths' layer shapes
    t0 = time.perf_counter()
    dense = dense_phase(gen)
    emit("dense", seconds=time.perf_counter() - t0, **dense)

    # phase 17: the delta pass alone at the main paths' delta shapes
    t0 = time.perf_counter()
    delta = delta_phase(gen)
    emit("delta", seconds=time.perf_counter() - t0, **delta)
    emit("occupancy", kernels=delta_occupancy())
    # after the occupancy line: its ops.delta_layer calls at 512 and 600
    # wide run at one block an SM, which that line would fail
    emit("spa_bwd_frame", **spa_bwd_frame_checks())

    # phase 18: Mip-NeRF and the IPE mode, on a train split of their own
    mip_checks = mip_kernel_checks()
    emit("mip_step", **step_check("mip"))
    with tempfile.TemporaryDirectory() as tmp:
        write_train_split(tmp)
        mip_train = run_train(tmp, "mip")
        emit("mip_train", **mip_train)
        diffs, depth_std = frame_check("mip")
        emit("mip_path", trained=render_trained(tmp, "mip"),
             f32_kernels_vs_plain_max_abs=diffs["rgb"], atol=FRAME_ATOL,
             depth_std=depth_std, profile=profile_frame("mip"))
        emit("mip_train_profile", **profile_trainer(tmp, 5, "-m", "--name",
                                                    "mip_1"))
        ipe = ipe_train(tmp)
        emit("ipe_train", **ipe)
        emit("ipe_render_trained", **render_trained(tmp, "ipe"))
    memory["mip"] = step_memory("mip")
    emit("step_memory", model="mip", **memory["mip"])

    # phase 19: the trainer's operations shell
    for model in ("vanilla", "ref", "mip"):
        with tempfile.TemporaryDirectory() as tmp:
            emit("resume_step", **resume_step(tmp, model))
    with tempfile.TemporaryDirectory() as tmp:
        write_train_split(tmp)
        emit("sigterm", **sigterm_drill(tmp))
        emit("render_fallback", **render_fallback(tmp))
        emit("debug", **debug_run(tmp))
        emit("epoch_gap", **epoch_gap(tmp))

    # phase 20: the distributed modes, world size 1 through the CLI (NCCL)
    # and two gloo ranks on the card
    distributed_phase(train_nets, ref_nets, smi)

    # phase 21: data and observability: the native image decoder on a
    # 100-view split, a --trace run on 20 of its views, the MFU of the train
    # runs, the orbit GIF
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        emit("data_load", **data_load(tmp))
        emit("trace", **trace_run(tmp))
        for route in MFU_ROUTES:
            emit("mfu", **mfu_check(route))
        emit("orbit_gif", **orbit_gif(tmp))
    emit("data_observability_done", seconds=time.perf_counter() - t_phase)

    # phase 22: the kernels line, then the last line.  ``launches`` is each
    # kernel's count in its path's run: the vanilla train path (training
    # steps and the final eval render) for the vanilla kernels, the Ref-NeRF
    # render path for the Ref-NeRF eval forwards, the Ref-NeRF train path
    # for its training kernels, the hybrid train path for the spatial
    # recompute pair, the recompute steps of phase 10 (60 train_step calls
    # of each model) for the other two recompute backwards, the
    # batch-scaling sweep of phase 13 for the proposal net's residual pair,
    # the dissection run of phase 14 (bf16) for the dissection kernels, the
    # walks of phase 15 for the weight-grad pass's own entry, the calls
    # of phase 16 for the layer tile's and of phase 17 for the delta pass's;
    # ``launches_render``, ``launches_ref``, ``launches_ref_train``,
    # ``launches_recompute_steps``, ``launches_hybrid_train``,
    # ``launches_batch_scaling``, ``launches_mip_train`` and
    # ``launches_ipe_train`` its count in each of those runs; ``mip`` the
    # vanilla kernels' readings on the Mip-NeRF path's operands (phase 18);
    # ``bodies`` the launches by body that each kernel of BODY_KERNELS
    # reported in the run that ``launches`` counts (ops.BODIES: the frame,
    # or the 64-row tile where it does not fit).
    recompute_steps = {k: memory["vanilla"]["recompute"]["launches"][k]
                       + memory["ref"]["recompute"]["launches"][k]
                       for k in ops.LAUNCHES}
    kernels = []
    for name, meta in KERNELS.items():
        if name == "wgrad_reduce":
            kernels.append(wgrad_entry(name, meta, wgrad, train["launches"],
                                       ref_train["launches"]))
            continue
        if name == "dense_layer":
            kernels.append(dense_entry(name, meta, dense))
            continue
        if name == "delta_layer":
            kernels.append(delta_entry(name, meta, delta))
            continue
        if name in DISSECT_KERNELS:
            kernels.append(dissect_entry(name, meta, dissect["launches"][name],
                                         dissect_per, dissect["n"]))
            continue
        res = checks[(name, torch.bfloat16)]   # -s trains and renders in bf16
        f32 = checks[(name, torch.float32)]
        path, bodies = (
            (scaling_launches, scaling_bodies) if name in PROP_RES_KERNELS
            else (hybrid["launches"], hybrid["bodies"])
            if name in ("ref_spa_fwd_grad", "ref_spa_bwd_recompute")
            else (recompute_steps, None) if name in RECOMPUTE_KERNELS
            else (ref_train["launches"], ref_train["bodies"])
            if name in REF_TRAIN_KERNELS[1:-1]
            else (ref_launches, ref_bodies) if name.startswith("ref")
            else (train["launches"], train["bodies"]))
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=path[name],
            launches_render=render_launches[name],
            launches_ref=ref_launches[name],
            launches_ref_train=ref_train["launches"][name],
            launches_recompute_steps=recompute_steps[name],
            launches_hybrid_train=hybrid["launches"][name],
            launches_batch_scaling=scaling_launches[name],
            launches_mip_train=mip_train["launches"][name],
            launches_ipe_train=ipe["launches"][name],
            mip=[{k: c.get(k) for k in (
                "n", "dtype", "max_abs_err", "grad_rel_err", "act_rel_err",
                "tol", "ms", "plain_ms", "bound_ms")}
                for c in mip_checks if c["name"] == name],
            max_abs_err=res["max_abs_err"],
            rel_err=res.get("grad_rel_err", res.get("act_rel_err")),
            tol=res["tol"], n=res["n"], ms=res["ms"],
            plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None,
            **({"bodies": bodies[name]} if name in BODY_KERNELS else {}),
            f32=dict(rel_err=f32.get("grad_rel_err", f32.get("act_rel_err")),
                     **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by")})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:       # a rank of phase 20's drills
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
