"""Render-only mode (-r): test-pose evaluation or the orbit (port of
nerf_tpu/cli/render.py:31-134).

Loads the model from the first of these that exists
(nerf_tpu/cli/render.py:31-51, with the port's own files first):
1. ``model/<name>_mip.pt`` and ``model/<name>_prop.pt`` (under ``-m``,
   Mip-NeRF's ``model/<name>_mip.pt`` alone); one of them without the
   other raises, naming the missing file;
2. ``nerf_tpu``'s final ``model/<name>.ckpt``;
3. the newest slot of the rotating window under
   ``--ckpt_dir``/<dataset_name>, the port's ``.pt`` or ``nerf_tpu``'s
   ``.ckpt``.
``nerf_tpu``'s msgpack checkpoints are read by the port's own reader
(utils/msgpack.py), their leading replica axis (ddp, ma) dropped; with
none of the three it raises ``FileNotFoundError`` naming them.  Renders the
test poses (-e) with per-frame MSE and PSNR against the ground truth, or
the 120-pose orbit; writes ``output/{given|sphere}/result_%03d.png`` grids
with nrow = 1 + render_depth + render_normal (+ the ground-truth panel under
-e), the normal panel (--render_normal) for Ref-NeRF (-t) only, and the
orbit's frames as ``output/sphere/orbit.gif`` (50 ms a frame, looped;
utils/gif.py, no Pillow).
"""

from __future__ import annotations

import os
import numpy as np
import torch

from nerf_tpu_torch.bridge import load_flax_variables
from nerf_tpu_torch.cli.flags import config_from_args, finalize_config
from nerf_tpu_torch.core.rays import orbit_poses
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.utils.checkpoint import (
    CheckpointManager, is_nerf_tpu_checkpoint, load_checkpoint,
    load_model_files, load_nerf_tpu_checkpoint, model_files,
)
from nerf_tpu_torch.utils.gif import write_gif
from nerf_tpu_torch.utils.image import save_image_grid, to_uint8

MODEL_DIR = "model"


def frame_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of frame ``index``'s noise, on ``device``."""
    state = np.random.SeedSequence([seed, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def load_trained_models(args, cfg, device):
    """(models, path(s) loaded, step, epoch) from the first source that
    exists: the port's ``.pt`` files, ``nerf_tpu``'s final ``.ckpt``, the
    newest rotating slot."""
    models = make_models(cfg, device)
    files = model_files(MODEL_DIR, args.name, models)
    if any(os.path.exists(path) for _, path in files):
        step, epoch = load_model_files(files)
        return models, ", ".join(path for _, path in files), step, epoch
    final = os.path.join(MODEL_DIR, f"{args.name}.ckpt")
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, args.dataset_name),
                            max_save=args.max_save,
                            prefix=f"{args.name}_chkpt")
    path = final if os.path.exists(final) else mgr.latest_path()
    if path is None:
        raise FileNotFoundError(
            f"no trained model: none of {', '.join(p for _, p in files)}, "
            f"{final} or a checkpoint under {mgr.directory}")
    if not is_nerf_tpu_checkpoint(path):
        step, epoch = load_checkpoint(path, models)
        return models, path, step, epoch
    ckpt = load_nerf_tpu_checkpoint(path)
    state = ckpt["state"]
    load_flax_variables(models, state["params"] if "params" in state
                        else state)
    return models, path, ckpt["step"], ckpt["epoch"]


def render_only(args, device=None):
    """Render with a trained model; returns the mean PSNR under -e."""
    dev = resolve_device(device)
    cfg = config_from_args(args)
    root = os.path.join(args.dataset_root, args.dataset_name)
    testset = BlenderDataset.load(root, "test", img_scale=args.img_scale,
                                  scene_scale=args.scene_scale,
                                  white_bkg=args.white_bkg)
    print(f"Loaded {len(testset)} test images with {testset.decoder}")
    hw = testset.image_hw
    focal = testset.focal(legacy_square=args.legacy_focal)
    cfg = finalize_config(cfg, focal)
    models, paths, step, epoch = load_trained_models(args, cfg, dev)
    print(f"Loaded {paths} (step {step}, epoch {epoch}) on {dev.type}")

    if args.eval_poses:
        poses = testset.poses
        out_dir = os.path.join(args.output_dir, "given")
    else:
        poses = orbit_poses(120, phi_deg=-30.0, radius=4.0)[:, :3, :].copy()
        poses[:, :, 3] *= args.scene_scale
        out_dir = os.path.join(args.output_dir, "sphere")
    os.makedirs(out_dir, exist_ok=True)

    psnrs, frames = [], []
    for i, pose in enumerate(poses):
        out = render_image(
            models, pose, hw, focal, cfg, sample_num=cfg.n_fine,
            render_depth=args.render_depth, render_normal=args.render_normal,
            generator=frame_generator(args.seed, i, dev),
            chunk=args.eval_chunk, device=dev)
        panels = [out["rgb"]]
        if "normal" in out:
            panels.append(out["normal"])
        if "depth" in out:
            d = out["depth"]
            panels.append(d / max(float(d.max()), 1e-8))
        if args.eval_poses:
            gt = testset.images[i]
            mse = float(np.mean((out["rgb"] - gt) ** 2))
            psnr = -10.0 * np.log10(max(mse, 1e-12))
            psnrs.append(psnr)
            print(f"Image loss:{mse:.6f}\tPSNR:{psnr:.4f}")
            panels.append(gt)
        save_image_grid(os.path.join(out_dir, f"result_{i:03d}.png"),
                        panels, nrow=len(panels))
        if not args.eval_poses:
            frames.append(to_uint8(out["rgb"]))
    if frames:
        gif = write_gif(os.path.join(out_dir, "orbit.gif"), frames,
                        duration_ms=50, loop=0)
        print(f"Orbit animation -> {gif}")
    if psnrs:
        print(f"Mean PSNR over {len(psnrs)} test poses: {np.mean(psnrs):.4f}")
    print(f"Output completed -> {out_dir}")
    return float(np.mean(psnrs)) if psnrs else None
