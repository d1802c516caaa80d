"""The single-device trainer (port of the single mode of
nerf_tpu/cli/trainer.py:46-650).

``python -m nerf_tpu_torch [-t|-m] [--use_ipe] [-s] [-w] --epochs E ...``
trains the vanilla model (Ref-NeRF under ``-t``; IPE features for its fine
net under ``--use_ipe``) with proposal distillation, or true Mip-NeRF
(``-m``: one net, coarse and fine IPE passes, no proposal net), on one
CUDA device:

- the train split's pixels (an (N, H*W, 3) pool) and poses stay on the
  device; every step picks ``--sample_ray_num`` pixels of one image, in a
  per-epoch shuffled image order, inside the center crop for the first
  ``--center_crop_iter`` steps;
- the models start from flax's initialization drawn from ``--seed``; Adam
  runs at the scaled base rate under the warmup-and-decay schedule;
- the step's metrics stay on the device; at the end of each epoch they
  are copied, without waiting, into pinned host memory behind a CUDA event,
  and read back one epoch late, after the next epoch is issued
  (nerf_tpu/cli/trainer.py:525-634), for the console line (loss, PSNR,
  learning rate, rays/s, ETA; ``Time/epoch`` runs from one epoch's
  read-back to the next) and the metrics log (``--log_dir``, every
  ``--eval_time`` steps; Ref-NeRF's normal and back-face losses and
  Mip-NeRF's coarse loss too); epochs that evaluate or stop are read back
  at once;
- every ``--output_time`` epochs and at the end it renders test views 1 and
  4 with their test loss, saves the image grid (with the normal map under
  ``--render_normal`` and the depth under ``--render_depth``) to
  ``--output_dir``, and writes the train state (nets, Adam, the generator,
  step and epoch) to the next slot of the rotating window under
  ``--ckpt_dir``/<dataset_name> (``--max_save`` slots,
  ``<name>_chkpt_<slot>.pt`` and ``<name>_chkpt_index.json``);
- ``-l`` resumes from the newest slot, the port's or ``nerf_tpu``'s
  (``.ckpt``, read through utils/msgpack.py): the nets, Adam's moments and
  step, the step counter, the generator (a ``nerf_tpu`` checkpoint has
  none: the generator is seeded from ``--seed`` and the step) and the
  epoch, which runs again, as in ``nerf_tpu``; with no checkpoint it says
  "Not loading" and starts afresh;
- SIGTERM or SIGINT is recorded by its handler, which touches neither the
  device nor a file; the loop finishes the epoch in flight, writes a slot
  with its step and epoch and exits with 128 + the signal number.  A
  second signal goes to the handler that was there before;
- ``-b`` trains and evaluates through the ``nn.Module`` route, f32, with
  a NaN hook on every submodule and autograd's anomaly mode
  (utils/debug.py): the first NaN raises ``FloatingPointError`` naming its
  module;
- at the end it writes ``model/<name>_{mip,prop}.pt`` (``-m``:
  ``model/<name>_mip.pt`` alone), which ``python -m nerf_tpu_torch -r``
  loads with the same model flags.

The JAX package's MFU against a TPU peak is not printed: the port's own
FLOP count comes with its bench (ROADMAP.md A4), and so does ``--trace``,
which raises ``NotImplementedError`` naming that item.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.bridge import load_flax_train_state
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
from nerf_tpu_torch.utils.checkpoint import (
    CheckpointManager, is_nerf_tpu_checkpoint, load_checkpoint,
    load_nerf_tpu_checkpoint, save_models,
)
from nerf_tpu_torch.utils.debug import check_finite, nan_attribution
from nerf_tpu_torch.utils.image import save_image_grid
from nerf_tpu_torch.utils.metrics import MetricsWriter
from nerf_tpu_torch.utils.timer import Timer

STOP_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def check_trainer_flags(args) -> None:
    """Raise for every flag whose part of the trainer is not ported."""
    if args.trace is not None:
        raise NotImplementedError(
            "--trace (a profiler trace of one epoch) is not ported to "
            "nerf_tpu_torch yet; see ROADMAP.md A4")


def resume_seed(seed: int, step: int) -> int:
    """The generator's seed for a run resumed at ``step`` from a checkpoint
    without a generator state (``nerf_tpu`` keys its draws on the
    step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


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
        if args.debug:
            # the eval renders go through the modules too: a NaN hook cannot
            # see inside a kernel
            self.cfg = self.cfg.replace(eval_use_pallas=self.cfg.use_pallas)
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
        self.ckpt = CheckpointManager(
            os.path.join(args.ckpt_dir, args.dataset_name),
            max_save=args.max_save, prefix=f"{args.name}_chkpt")
        self.epoch_start = 0
        self._stop_signal = None
        if args.load:
            path = self.ckpt.latest_path()
            if path is None:
                print(f"Not loading: no checkpoint under "
                      f"{self.ckpt.directory}")
            else:
                self.step, self.epoch_start = self.restore(path)
                print(f"Resumed from {path}: step {self.step}, epoch "
                      f"{self.epoch_start}.", flush=True)

    def restore(self, path: str):
        """Load the train state of a slot, the port's or ``nerf_tpu``'s;
        returns (step, epoch)."""
        if not is_nerf_tpu_checkpoint(path):
            return load_checkpoint(path, self.models, self.optimizer,
                                   self.generator)
        ckpt = load_nerf_tpu_checkpoint(path)
        load_flax_train_state(self.models, self.optimizer, ckpt["state"])
        self.generator.manual_seed(resume_seed(self.args.seed, ckpt["step"]))
        return ckpt["step"], ckpt["epoch"]

    def save(self, ep: int) -> str:
        """Write the train state after epoch ``ep`` to the next slot."""
        return self.ckpt.save(self.models, self.optimizer, self.generator,
                              step=self.step, epoch=ep)

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

    def _stage(self, metrics) -> tuple:
        """Start the copy of an epoch's stacked metrics to the host: into
        pinned memory, without waiting, behind a CUDA event (on the CPU
        they are there already).  Returns (keys, host tensor, event)."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k] for k in keys])
        if stacked.device.type != "cuda":
            return keys, stacked, None
        host = torch.empty(stacked.shape, dtype=stacked.dtype,
                           pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return keys, host, event

    def _finish(self, ep: int, step_base: int, staged: tuple) -> None:
        """Wait for an epoch's metrics copy, then its console line and
        metrics log; the epoch's time runs from the previous read-back."""
        keys, host, event = staged
        if event is not None:
            event.synchronize()
        metrics = dict(zip(keys, host.numpy()))
        now = time.perf_counter()
        dt, self._epoch_mark = now - self._epoch_mark, now
        self.train_timer.record(dt)
        if self.args.debug:
            check_finite(metrics, f"the metrics of epoch {ep}")
        self.losses.extend(metrics["loss"].tolist())
        self._log_epoch(ep, metrics, step_base, dt)

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
                             ("bf_loss", "Backface Loss"),
                             ("coarse_loss", "Coarse Loss")):
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

    def _on_signal(self, signum, frame):
        """Record the first stop signal; the loop acts on it between
        epochs.  The second goes to the handler that was there before."""
        if self._stop_signal is None:
            self._stop_signal = signum
            return
        self._restore_handlers()
        os.kill(os.getpid(), signum)

    def _restore_handlers(self):
        for sig, handler in self._old_handlers.items():
            signal.signal(sig, handler)
        self._old_handlers = {}

    def train(self):
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        self.writer = MetricsWriter(
            base_dir=args.log_dir, epochs=args.epochs, del_dir=args.del_dir,
            use_tensorboard=not args.no_tensorboard)
        print(f"Training: device={self.dev} images={len(self.train_set)} "
              f"hw={self.hw} focal=({self.focal[0]:.2f},{self.focal[1]:.2f}) "
              f"model={self.cfg.model} ipe={self.cfg.use_ipe} "
              f"bf16={self.cfg.use_bf16} "
              f"kernels={self.cfg.use_pallas is not False}", flush=True)
        self._old_handlers = {}
        for sig in STOP_SIGNALS:
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                pass    # not the main thread
        try:
            with nan_attribution(self.models, enable=args.debug):
                self._epochs()
        finally:
            self._restore_handlers()
            self.writer.close()
        paths = save_models(MODEL_DIR, args.name, self.models,
                            train_cnt=self.step, epoch=args.epochs)
        print(f"Training completed. Final model -> {', '.join(paths)}",
              flush=True)
        if self._stop_signal is not None:     # came after the last epoch
            raise SystemExit(128 + self._stop_signal)
        return self

    def _epochs(self):
        """The epoch loop, one epoch deep: epoch N's metrics are read back
        after epoch N + 1 is issued, so the host's read-back, logging and
        printing overlap the device's work."""
        args = self.args
        pending = None        # (ep, step_base, staged) not read back yet
        self._epoch_mark = time.perf_counter()
        for ep in range(self.epoch_start, args.epochs):
            step_base = self.step
            staged = self._stage(self.run_epoch(ep))
            if pending is not None:
                self._finish(*pending)
                pending = None
            if self._stop_signal is not None:
                self._finish(ep, step_base, staged)
                path = self.save(ep)
                print(f"signal {self._stop_signal}: checkpointed step "
                      f"{self.step}, epoch {ep} -> {path}", flush=True)
                raise SystemExit(128 + self._stop_signal)
            if ((ep % args.output_time == 0) or ep == args.epochs - 1) \
                    and ep > self.epoch_start:
                self._finish(ep, step_base, staged)
                self.evaluate(ep)
                self.save(ep)
                self._epoch_mark = time.perf_counter()  # not train time
            else:
                pending = (ep, step_base, staged)
        if pending is not None:
            self._finish(*pending)


def train(args, device=None) -> Trainer:
    """Train with ``args`` (the CLI flags) on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    return Trainer(args, device).train()
