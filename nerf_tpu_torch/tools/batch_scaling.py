"""Ray-batch scaling of the full training step (port of
tools/batch_scaling.py).

    python -m nerf_tpu_torch.tools.batch_scaling [--model vanilla|ref]
        [--batches 1024 4096 16384] [--axis pallas|residuals|prop_res]

For each ray batch R and each variant of the axis, ``measure`` trains on
the procedural scene (8 views at 400x400, ground truth from 64 samples a
ray) at the default step (64 coarse + 128 fine samples, 256-wide nets,
bf16, white background, the scaled base rate and the decay schedule):
``n_scan`` ``train_step`` calls issued back to back, then one
synchronize; the best of 3 such runs after a warm one, in rays/s, and the
peak device memory of the whole measurement.  A variant that runs out of
device memory at some R is reported as such and the sweep goes on: where
each backward form stops fitting is one of the things the sweep is for.

Axes:
- ``pallas``: the fused kernels against the ``nn.Module`` route;
- ``residuals``: the fine net's residual against its recompute backward,
  with the proposal net held in its default recompute form
  (``prop_store_residuals=False``): a fine-net-only A/B, as the JAX tool's
  axis has been since that default changed;
- ``prop_res``: the proposal net's residual against its recompute pair,
  with the fine net held residual.

``select``, ``tile``, ``pe`` and ``bufs`` were XLA and Mosaic knobs of the
JAX package (one-hot selection matmuls, the Pallas tile, angle-doubling PE,
pipeline buffer counts) with no counterpart here: they raise, as does
``--model mip`` (Mip-NeRF is not ported, ROADMAP.md A5).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.cli.flags import finalize_config
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.data.synthetic import make_synthetic_scene
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.train import schedule
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.step import (
    make_optimizer, sample_train_rays, train_step,
)

BATCHES = (1024, 4096, 16384)
# variant names of each offered axis, and the config each variant sets
AXES = {
    "pallas": {"kernels": dict(use_pallas=True),
               "module": dict(use_pallas=False)},
    "residuals": {"resid": dict(use_pallas=True, store_residuals=True),
                  "recompute": dict(use_pallas=True, store_residuals=False)},
    "prop_res": {"resid": dict(use_pallas=True, store_residuals=True,
                               prop_store_residuals=True),
                 "recompute": dict(use_pallas=True, store_residuals=True,
                                   prop_store_residuals=False)},
}
JAX_ONLY_AXES = {
    "select": "the one-hot selection matmuls of XLA's sampling",
    "tile": "the Pallas grid tile",
    "pe": "the angle-doubling positional encoding of the XLA path",
    "bufs": "the Mosaic pipeline buffer count of the backward kernels",
}


def config(model: str, ray_batch: int, **kw) -> PipelineConfig:
    """The default step's configuration at ``ray_batch`` rays."""
    return PipelineConfig(ray_batch=ray_batch, n_coarse=64, n_fine=128,
                          nerf_width=256, prop_width=256, white_bkg=True,
                          use_bf16=True, model=model, **kw)


def measure(cfg: PipelineConfig, n_scan: int = 100, device=None,
            train_set: Optional[BlenderDataset] = None) -> dict:
    """rays/s of ``cfg``'s training step: ``n_scan`` steps back to back,
    one synchronize, the best of 3 runs after a warm one.  Returns
    {"rays_per_s", "ms_per_step", "peak_bytes"}: the peak device memory
    from the models' creation to the last step (None on the CPU).
    ``train_set`` replaces the default scene (8 views at 400x400, 64
    samples a ray)."""
    dev = resolve_device(device)
    if train_set is None:
        train_set, _, _ = make_synthetic_scene(n_train=8, n_test=1,
                                               hw=(400, 400), seed=0,
                                               n_samples=64, device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    focal = train_set.focal()
    cfg = finalize_config(cfg, focal)
    pool = torch.as_tensor(train_set.pixel_pool(), device=dev)
    poses = torch.as_tensor(train_set.poses, device=dev)
    models = make_models(cfg, dev, torch.Generator().manual_seed(0))
    sched = schedule.decay_schedule(
        schedule.scaled_base_lr(1.5e-4, cfg.ray_batch), warmup_step=500)
    opt = make_optimizer(models)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = (np.arange(n_scan) % len(train_set)).tolist()
    step = 0

    def epoch():
        nonlocal step
        for img in order:
            rays, gt = sample_train_rays(pool, poses, img,
                                         train_set.image_hw, focal,
                                         cfg.ray_batch, generator=gen)
            train_step(models, opt, rays, gt, cfg, sched(step),
                       generator=gen, device=dev)
            step += 1
        if cuda:
            torch.cuda.synchronize()

    epoch()                                       # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        epoch()
        best = min(best, time.perf_counter() - t0)
    return {"rays_per_s": n_scan * cfg.ray_batch / best,
            "ms_per_step": best / n_scan * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m nerf_tpu_torch.tools.batch_scaling",
        description="rays/s and peak device memory of the training step "
                    "across ray batches")
    ap.add_argument("--model", default="vanilla",
                    choices=["vanilla", "ref", "mip"])
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--axis", default="prop_res",
                    choices=list(AXES) + list(JAX_ONLY_AXES),
                    help="'pallas': the fused kernels vs the nn.Module "
                         "route; 'residuals': the FINE net's residual vs "
                         "recompute backward, the proposal net held in its "
                         "default recompute form; 'prop_res': the proposal "
                         "net's residual vs recompute pair, the fine net "
                         "held residual.  'select', 'tile', 'pe' and "
                         "'bufs' were XLA/Mosaic knobs of the JAX package "
                         "and raise here")
    return ap


def main(argv=None, device=None) -> list:
    """Run the sweep; returns its rows as dicts (R, variant and
    ``measure``'s readings, or ``"oom": True``)."""
    args = get_parser().parse_args(argv)
    if args.model == "mip":
        raise NotImplementedError(
            "Mip-NeRF (-m) is not ported to nerf_tpu_torch yet; see "
            "ROADMAP.md A5")
    if args.axis in JAX_ONLY_AXES:
        raise NotImplementedError(
            f"--axis {args.axis} swept {JAX_ONLY_AXES[args.axis]}, an XLA or "
            f"Mosaic knob of the JAX package with no counterpart in "
            f"nerf_tpu_torch")
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}  model={args.model} axis={args.axis}",
          file=sys.stderr)
    rows = []
    for r in args.batches:
        for variant, kw in AXES[args.axis].items():
            cfg = config(args.model, r, **kw)
            try:
                row = dict(R=r, variant=variant, **measure(cfg, device=dev))
            except torch.cuda.OutOfMemoryError:
                row = dict(R=r, variant=variant, oom=True)
                torch.cuda.empty_cache()
            rows.append(row)
            print(_line(row), file=sys.stderr)
    print("\nsummary:", file=sys.stderr)
    for row in rows:
        print("  " + _line(row), file=sys.stderr)
    return rows


def _line(row: dict) -> str:
    head = f"R={row['R']:6d} {row['variant']:9s}"
    if row.get("oom"):
        return head + "  out of device memory"
    peak = row["peak_bytes"]
    return (head + f" {row['rays_per_s']:12,.0f} rays/s"
            + ("" if peak is None else f"  peak {peak / 1e9:7.3f} GB"))


if __name__ == "__main__":
    main()
