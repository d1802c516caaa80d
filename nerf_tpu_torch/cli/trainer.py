"""The single-device trainer (port of the single mode of
nerf_tpu/cli/trainer.py:46-650).

``python -m nerf_tpu_torch [-t] [-s] [-w] --epochs E ...`` trains the vanilla
model (Ref-NeRF under ``-t``) with proposal distillation on one CUDA
device:

- the train split's pixels (an (N, H*W, 3) pool) and poses stay on the
  device; every step picks ``--sample_ray_num`` pixels of one image, in a
  per-epoch shuffled image order, inside the center crop for the first
  ``--center_crop_iter`` steps;
- the models start from flax's initialization drawn from ``--seed``; Adam
  runs at the scaled base rate under the warmup-and-decay schedule;
- the step's metrics stay on the device and are read back once per epoch,
  for the console line (loss, PSNR, learning rate, rays/s, ETA) and the
  metrics log (``--log_dir``, every ``--eval_time`` steps; Ref-NeRF's
  normal and back-face losses too);
- every ``--output_time`` epochs and at the end it renders test views 1 and
  4 with their test loss and saves the image grid (with the normal map
  under ``--render_normal`` and the depth under ``--render_depth``) to
  ``--output_dir``;
- at the end it writes ``model/<name>_{mip,prop}.pt``, which
  ``python -m nerf_tpu_torch -r`` loads.

The JAX package's MFU against a TPU peak is not printed: the port's own
FLOP count comes with its bench (ROADMAP.md A4).  Flags of parts that are
not ported raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.cli.flags import config_from_args, finalize_config
from nerf_tpu_torch.cli.render import MODEL_DIR, frame_generator
from nerf_tpu_torch.core.rays import crop_bounds
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.data.sampler import epoch_image_order
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.train import schedule as schedule_lib
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.train.step import (
    make_optimizer, sample_train_rays, train_step,
)
from nerf_tpu_torch.utils.checkpoint import save_models
from nerf_tpu_torch.utils.image import save_image_grid
from nerf_tpu_torch.utils.metrics import MetricsWriter
from nerf_tpu_torch.utils.timer import Timer

DEFAULT_CKPT_DIR = "./check_points"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to nerf_tpu_torch yet; see ROADMAP.md {item}")


def check_trainer_flags(args) -> None:
    """Raise for every flag whose part of the trainer is not ported."""
    if args.load:
        raise _not_ported("-l/--load (resume from --ckpt_dir)", "A8")
    if args.ckpt_dir != DEFAULT_CKPT_DIR:
        raise _not_ported("the rotating --ckpt_dir checkpoints "
                          "(and the SIGTERM save)", "A8")
    if args.debug:
        raise _not_ported("-b/--debug (per-module NaN attribution)", "A10")
    if args.trace is not None:
        raise _not_ported("--trace (a profiler trace of one epoch)", "A4")
    if args.mip_nerf:
        raise _not_ported("-m/--mip_nerf (Mip-NeRF)", "A5")
    if args.use_ipe:
        raise _not_ported("--use_ipe (integrated positional encoding)", "A5")


class Trainer:
    """Owns the models, optimizer and data, and runs the epoch loop."""

    def __init__(self, args, device=None,
                 train_set: Optional[BlenderDataset] = None,
                 test_set: Optional[BlenderDataset] = None):
        self.dev = resolve_device(device)
        check_trainer_flags(args)
        self.args = args
        root = os.path.join(args.dataset_root, args.dataset_name)
        load = dict(img_scale=args.img_scale, scene_scale=args.scene_scale,
                    white_bkg=args.white_bkg)
        if train_set is None:
            train_set = BlenderDataset.load(root, "train", **load)
        if test_set is None:
            test_set = BlenderDataset.load(root, "test", **load)
        self.train_set, self.test_set = train_set, test_set
        self.pool = torch.as_tensor(train_set.pixel_pool(), device=self.dev)
        self.poses = torch.as_tensor(train_set.poses, device=self.dev)
        self.hw = self.train_set.image_hw
        self.focal = self.train_set.focal(legacy_square=args.legacy_focal)
        self.cfg = finalize_config(config_from_args(args), self.focal)
        # the reference evaluates test views 1 and 4 only (train.py:135-137)
        n_test = len(self.test_set)
        self.test_view_ids = [i for i in (1, 4) if i < n_test] or [0]

        self.models = make_models(
            self.cfg, self.dev, torch.Generator().manual_seed(args.seed))
        self.schedule = schedule_lib.decay_schedule(
            schedule_lib.scaled_base_lr(args.lr, args.sample_ray_num),
            min_ratio=args.min_ratio, decay_rate=args.decay_rate,
            decay_step=args.decay_step, warmup_step=args.warmup_step)
        self.optimizer = make_optimizer(self.models)
        self.crop_window = crop_bounds(
            *self.hw, (args.center_crop_x, args.center_crop_y))
        self.generator = torch.Generator(device=self.dev).manual_seed(
            args.seed)
        self.step = 0          # host mirror of the optimizer's step count
        self.losses = []       # per-step loss, fetched once per epoch
        self.train_timer, self.eval_timer = Timer(5), Timer(5)

    def run_epoch(self, ep: int):
        """One epoch of steps; returns its metrics stacked per step, still
        on the device."""
        order = epoch_image_order(len(self.train_set), ep, self.args.seed)
        collected = []
        for img in order.tolist():
            cropped = self.step < self.args.center_crop_iter
            rays, rgb_gt = sample_train_rays(
                self.pool, self.poses, img, self.hw, self.focal,
                self.cfg.ray_batch,
                crop_window=self.crop_window if cropped else None,
                generator=self.generator)
            collected.append(train_step(
                self.models, self.optimizer, rays, rgb_gt, self.cfg,
                self.schedule(self.step), grad_clip=self.args.grad_clip,
                generator=self.generator, device=self.dev))
            self.step += 1
        return {k: torch.stack([m[k] for m in collected])
                for k in collected[0]}

    def _log_epoch(self, ep: int, metrics, step_base: int, dt: float):
        """Console line and metrics log of one finished epoch; ``metrics``
        are host arrays."""
        args = self.args
        steps = len(metrics["loss"])
        for i in range(0, steps, max(1, args.eval_time)):
            self.writer.add_scalar("Train Loss", metrics["loss"][i],
                                   step_base + i)
            self.writer.add_scalar("PSNR", metrics["psnr"][i], step_base + i)
            for key, tag in (("normal_loss", "Normal Loss"),
                             ("bf_loss", "Backface Loss")):
                if key in metrics:
                    self.writer.add_scalar(tag, metrics[key][i],
                                           step_base + i)
            self.writer.add_scalar("Learning Rate",
                                   self.schedule(step_base + i),
                                   step_base + i)
        rays_s = steps * self.cfg.ray_batch / max(dt, 1e-9)
        self.writer.add_scalar("Time/epoch", dt, ep)
        print(f"Epoch {ep:4d} / {args.epochs:4d}\t"
              f"loss: {float(metrics['loss'][-1]):.4f}\t"
              f"PSNR: {float(metrics['psnr'][-1]):.3f}\t"
              f"lr: {self.schedule(step_base + steps):.7f}\t"
              f"{rays_s:,.0f} rays/s\t"
              f"ETA: {self.train_timer.eta_str(args.epochs - ep - 1)}",
              flush=True)

    def evaluate(self, ep: int) -> float:
        """Render the test views with their mean test loss; saves the grid
        ``result_ep<ep>.png``."""
        args = self.args
        self.eval_timer.tic()
        panels, test_loss = [], 0.0
        for vid in self.test_view_ids:
            out = render_image(
                self.models, self.test_set.poses[vid], self.hw, self.focal,
                self.cfg, sample_num=self.cfg.n_fine,
                render_depth=args.render_depth,
                render_normal=args.render_normal,
                generator=frame_generator(args.seed, 10_000 + vid, self.dev),
                chunk=args.eval_chunk, device=self.dev)
            test_loss += float(np.mean((out["rgb"] - self.test_set.images[vid])
                                       ** 2))
            panels.append(out["rgb"])
            if "normal" in out:
                panels.append(out["normal"])
            if "depth" in out:
                d = out["depth"]
                panels.append(d / max(float(d.max()), 1e-8))
        self.eval_timer.toc()
        test_loss /= len(self.test_view_ids)
        self.writer.add_scalar("Test Loss", test_loss, self.step)
        img_path = os.path.join(args.output_dir, f"result_ep{ep:04d}.png")
        save_image_grid(img_path, panels, nrow=len(panels)
                        // len(self.test_view_ids))
        print(f"Evaluation in epoch: {ep:4d} / {args.epochs:4d}\t"
              f"test loss: {test_loss:.4f}\t"
              f"avg eval time: {self.eval_timer.get_mean_time():.4f}s -> "
              f"{img_path}", flush=True)
        return test_loss

    def train(self):
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        self.writer = MetricsWriter(
            base_dir=args.log_dir, epochs=args.epochs, del_dir=args.del_dir,
            use_tensorboard=not args.no_tensorboard)
        print(f"Training: device={self.dev} images={len(self.train_set)} "
              f"hw={self.hw} focal=({self.focal[0]:.2f},{self.focal[1]:.2f}) "
              f"model={self.cfg.model} bf16={self.cfg.use_bf16} "
              f"kernels={self.cfg.use_pallas is not False}", flush=True)
        mark = time.perf_counter()
        for ep in range(args.epochs):
            step_base = self.step
            metrics = self.run_epoch(ep)
            # the one read-back of the epoch; it waits for its last step
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            now = time.perf_counter()
            dt, mark = now - mark, now
            self.train_timer.record(dt)
            self.losses.extend(metrics["loss"].tolist())
            self._log_epoch(ep, metrics, step_base, dt)
            if ((ep % args.output_time == 0) or ep == args.epochs - 1) \
                    and ep > 0:
                self.evaluate(ep)
                mark = time.perf_counter()   # eval time is not train time
        self.writer.close()
        save_models(MODEL_DIR, args.name, self.models, train_cnt=self.step,
                    epoch=args.epochs)
        print(f"Training completed. Final model -> {MODEL_DIR}/{args.name}"
              f"_{{mip,prop}}.pt", flush=True)
        return self


def train(args, device=None) -> Trainer:
    """Train with ``args`` (the CLI flags) on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    return Trainer(args, device).train()
