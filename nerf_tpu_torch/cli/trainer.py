"""The trainer (port of nerf_tpu/cli/trainer.py:46-650): the single-device
mode and the distributed modes ``ddp`` (data parallel) and ``ma`` (model
averaging), one process per rank on torch.distributed (parallel/).

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
  learning rate, rays/s, MFU, ETA; ``Time/epoch`` runs from one epoch's
  completion on the device to the next's, timed by CUDA events) and the
  metrics log (``--log_dir``, every ``--eval_time`` steps; Ref-NeRF's
  normal and back-face losses and Mip-NeRF's coarse loss too); epochs
  that evaluate, average or stop are read back at once;
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

The distributed modes (``python -m nerf_tpu_torch.ddp_train`` and ``python
-m nerf_tpu_torch.model_average`` under torchrun) run the same loop on every
rank of an (n_replica x n_data) grid (parallel/mesh.py), each rank on its
own device with its own generator (parallel/dp.py ``rank_seed``):

- ``ddp``: one replica, every rank a data rank; each step's grads are
  averaged over the ranks before clipping and Adam (``--no_sync_prop``
  leaves the proposal net's local); an epoch's images are cut to a multiple
  of the ranks (the leftovers are dropped, :263-292);
- ``ma``: ``--num_replicas`` replicas (all ranks by default), each on its own
  division of the images (``-div``: ``transforms_train_div.json``; else an
  equal split; ``LocalShuffleSampler``), data parallel over its share of the
  remaining ranks (capped by the smallest division; the rest are idle and
  exit at once, :117-150); every ``--ma_epoch`` epochs the replicas'
  parameters are averaged with the division weights (``--ma_method``,
  ``Time/communication``);
- the epoch's metrics are averaged over the grid on the device, the eval
  renders rank 0's nets sharded over every rank, a slot holds every rank's
  generator (and under ``ma`` every replica's nets and Adam, stacked), and
  ``-l`` restores each rank's row at the same layout;
- only rank 0 prints, writes files and the metrics log; rays/s counts every
  rank's rays;
- the stop is cooperative: once an epoch every rank joins an all_reduce
  (MAX) of its stop flag on the gloo control group, a host-side exchange
  that does not wait for the device, so a signal to one rank stops every
  rank after the same epoch, with one collective save.

Each epoch line and the metrics log (``MFU``) carry the model FLOPs
utilization of one device: its rays/s over the analytic FLOP count of a
step (utils/flops.py) against the H100's dense bf16 peak
(nerf_tpu/cli/trainer.py:294-316).  ``--trace DIR`` records the run's second
epoch with torch.profiler (CPU and CUDA activities on the card) and writes
one Chrome trace, ``DIR/rank<r>.pt.trace.json``, per rank
(nerf_tpu/cli/trainer.py:579-588); a one-epoch run traces nothing.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch import parallel
from nerf_tpu_torch.bridge import load_flax_train_state
from nerf_tpu_torch.cli.flags import config_from_args, finalize_config
from nerf_tpu_torch.cli.render import MODEL_DIR, frame_generator
from nerf_tpu_torch.core.rays import crop_bounds
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.data.sampler import LocalShuffleSampler, epoch_image_order
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.train import schedule as schedule_lib
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.train.step import (
    make_optimizer, sample_train_rays, train_step,
)
from nerf_tpu_torch.utils.checkpoint import (
    CheckpointManager, is_nerf_tpu_checkpoint, load_checkpoint,
    load_nerf_tpu_checkpoint, save_models, stack_states, train_state,
)
from nerf_tpu_torch.utils.debug import check_finite, nan_attribution
from nerf_tpu_torch.utils.flops import H100_BF16_PEAK, train_step_flops
from nerf_tpu_torch.utils.image import save_image_grid
from nerf_tpu_torch.utils.metrics import MetricsWriter
from nerf_tpu_torch.utils.timer import Timer

STOP_SIGNALS = (signal.SIGTERM, signal.SIGINT)
MODES = ("single", "ddp", "ma")


def resume_seed(seed: int, step: int) -> int:
    """The generator's seed for a run resumed at ``step`` from a checkpoint
    without a generator state (``nerf_tpu`` keys its draws on the
    step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def grid_layout(mode: str, world: int, n_images: int, division=None,
                num_replicas: Optional[int] = None) -> tuple:
    """(n_replica, n_data) of ``mode`` on ``world`` ranks
    (nerf_tpu/cli/trainer.py:117-165): ``single`` 1 x 1; ``ddp`` one replica
    over every rank; ``ma`` ``num_replicas`` (every rank by default), each
    data parallel over its share of the rest, capped by the smallest
    division: every rank of a replica takes one of its images a step.
    Raises for more replicas than ranks, and for a division whose groups
    are not the replicas."""
    if mode == "single":
        return 1, 1
    if mode == "ddp":
        return 1, world
    n_replica = int(num_replicas or world)
    if n_replica > world:
        raise ValueError(f"--num_replicas {n_replica} > {world} ranks")
    if division is None:
        min_div = max(1, n_images // n_replica)
    else:
        n_div = int(np.max(division)) + 1
        if n_div != n_replica:
            raise ValueError(
                f"dataset division has {n_div} groups but the grid has "
                f"{n_replica} replicas (ranks); re-run tools/pose_division.py "
                f"for {n_replica} groups or drop -div")
        counts = np.bincount(np.asarray(division, np.int64))
        min_div = int(counts[counts > 0].min())
    return n_replica, max(1, min(world // n_replica, min_div))


def epoch_indices(mode: str, n_images: int, ep: int, seed: int,
                  n_data: int = 1, samplers=None) -> np.ndarray:
    """Image visit order of epoch ``ep`` (nerf_tpu/cli/trainer.py:263-292):
    single (steps,) int32; ddp and ma (steps, n_replica, n_data), one image
    per rank a step.  ``ddp`` drops the leftover images; ``ma`` takes the
    samplers' stacked rows, reshaped over the data ranks."""
    if mode == "single":
        return epoch_image_order(n_images, ep, seed)
    if mode == "ddp":
        order = epoch_image_order(n_images, ep, seed)
        steps = len(order) // n_data
        if steps == 0:
            raise ValueError(f"{len(order)} train images < {n_data} ranks")
        return order[:steps * n_data].reshape(steps, 1, n_data)
    rows = LocalShuffleSampler.stacked_epoch_indices(samplers, ep)
    if n_data == 1:
        return rows.T[:, :, None]
    steps = rows.shape[1] // n_data
    if steps == 0:
        raise ValueError(f"division of {rows.shape[1]} images < n_data="
                         f"{n_data} ranks per replica")
    rows = rows[:, :steps * n_data]
    return rows.reshape(len(samplers), steps, n_data).transpose(1, 0, 2)


class Trainer:
    """Owns the models, optimizer and data, and runs the epoch loop of one
    rank (``mode`` single, ddp or ma)."""

    def __init__(self, args, device=None,
                 train_set: Optional[BlenderDataset] = None,
                 test_set: Optional[BlenderDataset] = None,
                 mode: str = "single", backend: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"unknown trainer mode {mode!r}; expected one "
                             f"of {MODES}")
        self.mode = mode
        if mode == "single":
            self.dev = resolve_device(device)
        else:
            self.dev = parallel.rank_device(device)
            parallel.init_process_group(
                self.dev, backend, getattr(args, "coordinator", None),
                getattr(args, "num_processes", None),
                getattr(args, "process_id", None))
        self.args = args
        root = os.path.join(args.dataset_root, args.dataset_name)
        load = dict(img_scale=args.img_scale, scene_scale=args.scene_scale,
                    white_bkg=args.white_bkg)
        if train_set is None:
            train_set = BlenderDataset.load(
                root, "train", use_div=mode == "ma" and getattr(
                    args, "div", False), **load)
        if test_set is None:
            test_set = BlenderDataset.load(root, "test", **load)
        self.train_set, self.test_set = train_set, test_set
        self.samplers, self.ma_epoch = None, 0
        self.grid = (parallel.Grid(1, 1, 0, self.dev) if mode == "single"
                     else self._make_grid())
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
            parallel.rank_seed(args.seed, self.rank))
        # a mean over one data rank is the identity: no sync at all
        self.grad_sync = None if self.grid.n_data == 1 else parallel.GradSync(
            self.models, self.grid.data_group, self.grid.n_data,
            sync_prop=not getattr(args, "no_sync_prop", False))
        self._eval_nets = None
        self._flops_per_step = None
        self.step = 0          # host mirror of the optimizer's step count
        self.losses = []       # per-step loss, fetched once per epoch
        self.train_timer, self.eval_timer = Timer(5), Timer(5)
        self.ckpt = CheckpointManager(
            os.path.join(args.ckpt_dir, args.dataset_name),
            max_save=args.max_save, prefix=f"{args.name}_chkpt")
        self.epoch_start = 0
        self._stop_signal = None
        if args.load and self.active:
            path = self.ckpt.latest_path()
            if path is None:
                self._print(f"Not loading: no checkpoint under "
                            f"{self.ckpt.directory}")
            else:
                self.step, self.epoch_start = self.restore(path)
                self._print(f"Resumed from {path}: step {self.step}, epoch "
                            f"{self.epoch_start}.")

    def _make_grid(self):
        """The (replica, data) grid of the process group
        (nerf_tpu/cli/trainer.py:117-183), and under ``ma`` the samplers
        and the averaging weights."""
        args, train_set = self.args, self.train_set
        world = dist.get_world_size()
        division = train_set.division
        n_replica, n_data = grid_layout(
            self.mode, world, len(train_set), division,
            getattr(args, "num_replicas", None))
        grid = parallel.make_grid(n_replica, n_data, self.dev)
        if grid.size < world and grid.is_main:
            print(f"warning: {world} ranks, using {n_replica}x{n_data} grid "
                  f"({world - grid.size} idle); pick --num_replicas dividing "
                  f"{world} to use all", flush=True)
        if self.mode != "ma":
            return grid
        self.samplers = [
            LocalShuffleSampler(
                len(train_set), division if division is not None
                else n_replica, rank=r, seed=args.seed,
                allow_imbalance=getattr(args, "allow_imbalanced", False))
            for r in range(n_replica)]
        self.ma_weights = parallel.normalized_weights(train_set.weights,
                                                      n_replica)
        self.ma_method = getattr(args, "ma_method", "all_reduce")
        parallel.check_strategy(self.ma_method)
        self.ma_epoch = int(getattr(args, "ma_epoch", 0) or 0)
        return grid

    @property
    def rank(self) -> int:
        """This rank's grid position (0 for the single-device trainer)."""
        return self.grid.rank

    @property
    def active(self) -> bool:
        return self.grid.active

    @property
    def is_main(self) -> bool:
        return self.grid.is_main

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

    def restore(self, path: str):
        """Load this rank's train state from a slot, the port's or
        ``nerf_tpu``'s; returns (step, epoch)."""
        grid = self.grid
        if not is_nerf_tpu_checkpoint(path):
            return load_checkpoint(path, self.models, self.optimizer,
                                   self.generator, replica=grid.replica,
                                   rank=grid.rank,
                                   layout=(grid.n_replica, grid.n_data))
        ckpt = load_nerf_tpu_checkpoint(path)
        load_flax_train_state(self.models, self.optimizer, ckpt["state"],
                              replica=grid.replica)
        self.generator.manual_seed(parallel.rank_seed(
            resume_seed(self.args.seed, ckpt["step"]), self.rank))
        return ckpt["step"], ckpt["epoch"]

    def save(self, ep: int) -> Optional[str]:
        """Write the train state after epoch ``ep`` to the next slot (the
        distributed modes: a collective gather, written by rank 0, which
        returns the path)."""
        if self.mode == "single":
            return self.ckpt.save(self.models, self.optimizer,
                                  self.generator, step=self.step, epoch=ep)
        grid = self.grid
        mine = (train_state(self.models, self.optimizer)
                if grid.data == 0 else None, self.generator.get_state())
        gathered = [None] * grid.size if grid.is_main else None
        dist.gather_object(mine, gathered, dst=0, group=grid.control_group)
        if not grid.is_main:
            return None
        states = [state for state, _ in gathered if state is not None]
        payload = dict(
            stack_states(states) if self.mode == "ma" else states[0],
            generator=gathered[0][1], generator_device=self.dev.type,
            generators=[gen for _, gen in gathered],
            layout={"mode": self.mode, "n_replica": grid.n_replica,
                    "n_data": grid.n_data},
            step=self.step, epoch=ep)
        return self.ckpt.write(payload, self.step, ep)

    def epoch_order(self, ep: int) -> np.ndarray:
        """This rank's image order of epoch ``ep``."""
        grid = self.grid
        idx = epoch_indices(self.mode, len(self.train_set), ep,
                            self.args.seed, grid.n_data, self.samplers)
        return idx.reshape(len(idx), grid.n_replica,
                           grid.n_data)[:, grid.replica, grid.data]

    def run_epoch(self, ep: int):
        """One epoch of steps; returns its metrics stacked per step, still
        on the device."""
        collected = []
        for img in self.epoch_order(ep).tolist():
            cropped = self.step < self.args.center_crop_iter
            rays, rgb_gt = sample_train_rays(
                self.pool, self.poses, img, self.hw, self.focal,
                self.cfg.ray_batch,
                crop_window=self.crop_window if cropped else None,
                generator=self.generator)
            collected.append(train_step(
                self.models, self.optimizer, rays, rgb_gt, self.cfg,
                self.schedule(self.step), grad_clip=self.args.grad_clip,
                generator=self.generator, device=self.dev,
                grad_sync=self.grad_sync))
            self.step += 1
        return {k: torch.stack([m[k] for m in collected])
                for k in collected[0]}

    def _traced_epoch(self, ep: int):
        """``run_epoch`` under torch.profiler, its device work waited for
        inside the profiled block; writes this rank's Chrome trace into
        ``--trace``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            metrics = self.run_epoch(ep)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        os.makedirs(self.args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.args.trace, f"rank{self.rank}.pt.trace.json"))
        self._print(f"profiler trace written to {self.args.trace}")
        return metrics

    def _stage(self, metrics) -> tuple:
        """Start the copy of an epoch's stacked metrics to the host: into
        pinned memory, without waiting, behind a CUDA event (on the CPU
        they are there already).  A grid of more than one rank first
        averages them over its ranks, on the device.  Returns (keys, host
        tensor, the epoch's end on the clock of ``_mark``)."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k] for k in keys])
        if self.grid.size > 1:
            dist.all_reduce(stacked, group=self.grid.grid_group)
            stacked.div_(self.grid.size)
        if stacked.device.type != "cuda":
            return keys, stacked, self._mark()
        host = torch.empty(stacked.shape, dtype=stacked.dtype,
                           pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        return keys, host, self._mark()

    def _mark(self):
        """A point of the epoch clock: on the card a timed CUDA event, which
        completes when the work issued before it does; on the CPU, where
        the work is done once it is issued, the host's clock."""
        if self.dev.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _finish(self, ep: int, step_base: int, staged: tuple) -> None:
        """Wait for an epoch's metrics copy, then its console line and
        metrics log.  The epoch's time runs from the previous epoch's
        completion (or the end of a pause: an eval, an averaging) to its
        own, on the device's clock: the host that issues the next epoch
        before this read-back does not move it."""
        keys, host, end = staged
        if isinstance(end, float):
            dt = end - self._epoch_mark
        else:
            end.synchronize()
            dt = self._epoch_mark.elapsed_time(end) / 1e3
        self._epoch_mark = end
        metrics = dict(zip(keys, host.numpy()))
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
        # every rank trains ray_batch rays a step (:563-565)
        rays_s = steps * self.grid.size * self.cfg.ray_batch / max(dt, 1e-9)
        mfu = self._mfu(rays_s / self.grid.size)
        self.writer.add_scalar("Time/epoch", dt, ep)
        self.writer.add_scalar("MFU", mfu, ep)
        self._print(f"Epoch {ep:4d} / {args.epochs:4d}\t"
                    f"loss: {float(metrics['loss'][-1]):.4f}\t"
                    f"PSNR: {float(metrics['psnr'][-1]):.3f}\t"
                    f"lr: {self.schedule(step_base + steps):.7f}\t"
                    f"{rays_s:,.0f} rays/s\t"
                    f"MFU: {mfu * 100:.1f}%\t"
                    f"ETA: {self.train_timer.eta_str(args.epochs - ep - 1)}")

    def _mfu(self, rays_per_sec: float) -> float:
        """Model FLOPs utilization of one device at ``rays_per_sec``; the
        step's FLOP count is taken once, from the weights' shapes."""
        if self._flops_per_step is None:
            try:
                self._flops_per_step = train_step_flops(self.cfg, self.models)
            except (AttributeError, TypeError, ValueError) as e:
                # a model the count does not know: say so once instead of
                # reporting 0.0% without a word
                self._print(f"warning: FLOPs model failed "
                            f"({type(e).__name__}: {e}); MFU will report "
                            f"0.0%")
                self._flops_per_step = 0.0
        steps_s = rays_per_sec / self.cfg.ray_batch
        return steps_s * self._flops_per_step / H100_BF16_PEAK

    @torch.no_grad()
    def eval_models(self):
        """The nets the eval renders: rank 0's (replica 0's), broadcast to
        every rank of the grid (:388-420)."""
        if self.grid.size == 1:
            return self.models
        if self._eval_nets is None:
            self._eval_nets = (self.models if self.grid.is_main
                               else make_models(self.cfg, self.dev))
        for src, dst in zip(self.models, self._eval_nets):
            if src is None:
                continue
            params = list(dst.parameters())
            flat = torch.cat([p.reshape(-1) for p in src.parameters()])
            dist.broadcast(flat, src=0, group=self.grid.grid_group)
            if dst is src:
                continue
            for p, v in zip(params, flat.split([p.numel() for p in params])):
                p.copy_(v.view_as(p))
        return self._eval_nets

    def evaluate(self, ep: int) -> float:
        """Render the test views with their mean test loss; saves the grid
        ``result_ep<ep>.png``.  Sharded over the grid in the distributed
        modes."""
        args = self.args
        self.eval_timer.tic()
        models = self.eval_models()
        group = self.grid.grid_group if self.grid.size > 1 else None
        panels, test_loss = [], 0.0
        for vid in self.test_view_ids:
            out = render_image(
                models, self.test_set.poses[vid], self.hw, self.focal,
                self.cfg, sample_num=self.cfg.n_fine,
                render_depth=args.render_depth,
                render_normal=args.render_normal,
                generator=frame_generator(args.seed, 10_000 + vid, self.dev),
                chunk=args.eval_chunk, device=self.dev, group=group)
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
        if self.is_main:
            save_image_grid(img_path, panels, nrow=len(panels)
                            // len(self.test_view_ids))
        self._print(f"Evaluation in epoch: {ep:4d} / {args.epochs:4d}\t"
                    f"test loss: {test_loss:.4f}\t"
                    f"avg eval time: {self.eval_timer.get_mean_time():.4f}s "
                    f"-> {img_path}")
        return test_loss

    def average(self, ep: int) -> float:
        """Average the replicas' parameters with the division weights
        (``--ma_method``); returns its seconds, device work included
        (``Time/communication``)."""
        t0 = time.perf_counter()
        parallel.average_models_(self.models, self.ma_weights,
                                 self.grid.replica, self.grid.replica_group,
                                 self.ma_method)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        seconds = time.perf_counter() - t0
        self.writer.add_scalar("Time/communication", seconds, ep)
        return seconds

    def _sync_stop(self) -> bool:
        """Whether any rank was signalled (:318-336): one all_reduce (MAX)
        of a host flag on the gloo control group an epoch, which does not
        wait for the device; a rank that learns of a peer's signal stops
        as if it had had SIGTERM."""
        local = self._stop_signal is not None
        if self.grid.size == 1:
            return local
        flag = torch.tensor([int(local)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                        group=self.grid.control_group)
        if int(flag) and self._stop_signal is None:
            self._stop_signal = signal.SIGTERM
        return bool(int(flag))

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
        if not self.active:     # an idle rank of the grid
            return self
        if self.is_main:
            os.makedirs(args.output_dir, exist_ok=True)
            self.writer = MetricsWriter(
                base_dir=args.log_dir, epochs=args.epochs,
                del_dir=args.del_dir, use_tensorboard=not args.no_tensorboard)
        else:
            self.writer = MetricsWriter(enabled=False)
        grid = ("" if self.mode == "single" else
                f"mode={self.mode} ranks={dist.get_world_size()} "
                f"backend={dist.get_backend()} "
                f"grid=({self.grid.n_replica}x{self.grid.n_data}) ")
        self._print(f"Training: {grid}device={self.dev} "
                    f"images={len(self.train_set)} hw={self.hw} "
                    f"focal=({self.focal[0]:.2f},{self.focal[1]:.2f}) "
                    f"model={self.cfg.model} ipe={self.cfg.use_ipe} "
                    f"bf16={self.cfg.use_bf16} "
                    f"kernels={self.cfg.use_pallas is not False}")
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
        if self.is_main:
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
        self._epoch_mark = self._mark()
        for ep in range(self.epoch_start, args.epochs):
            step_base = self.step
            if args.trace is not None and ep == self.epoch_start + 1:
                # the second epoch, past the first launches' set-up
                if pending is not None:
                    self._finish(*pending)
                    pending = None
                staged = self._stage(self._traced_epoch(ep))
            else:
                staged = self._stage(self.run_epoch(ep))
            if pending is not None:
                self._finish(*pending)
                pending = None
            if self._sync_stop():
                self._finish(ep, step_base, staged)
                path = self.save(ep)
                self._print(f"signal {self._stop_signal}: checkpointed step "
                            f"{self.step}, epoch {ep} -> {path}")
                raise SystemExit(128 + self._stop_signal)
            is_ma = self.mode == "ma" and self.ma_epoch \
                and (ep + 1) % self.ma_epoch == 0
            is_eval = ((ep % args.output_time == 0) or ep == args.epochs - 1) \
                and ep > self.epoch_start
            if is_ma or is_eval:
                self._finish(ep, step_base, staged)
                if is_ma:
                    self.average(ep)
                if is_eval:
                    self.evaluate(ep)
                    self.save(ep)
                self._epoch_mark = self._mark()  # not train time
            else:
                pending = (ep, step_base, staged)
        if pending is not None:
            self._finish(*pending)


def train(args, device=None, mode: str = "single",
          backend: Optional[str] = None) -> Trainer:
    """Train with ``args`` (the CLI flags) on ``device`` (``cuda`` unless
    ``device="cpu"``; the distributed modes: this rank's, ``cuda:LOCAL_RANK``
    by default) in ``mode``; ``backend`` overrides the distributed modes'
    (NCCL on CUDA, gloo on the CPU)."""
    return Trainer(args, device, mode=mode, backend=backend).train()
