"""The training step (port of nerf_tpu/train/step.py:40-180, 241).

The JAX package compiles pixel picks, ray generation, the render, the loss
and the optimizer update into one program per step.  Here they are eager
PyTorch on the device, with the same arithmetic:

- ``sample_train_rays``: uniform pixel picks with replacement, inside the
  crop window while it is active, and one flat gather from the on-device
  pixel pool;
- ``compute_loss``: MSE of the fine render plus the proposal loss over the
  detached fine weights; for Ref-NeRF also the weighted normal loss against
  the detached density-gradient normals, the back-face loss and, under
  ``--prop_normal``, the proposal net's normal loss at the coarse samples;
  the distortion and ray-entropy regularizers under their weights;
- Adam(0.9, 0.999, eps 1e-8), its rate set to ``schedule(step)`` before each
  update (optax evaluates its schedule at the update's own count, so the
  first update uses ``schedule(0)``), after optax's global-norm clipping
  when ``grad_clip > 0``.

``train_step`` reads no value back from the device: the metrics it returns
stay there until the caller fetches a whole epoch of them at once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from nerf_tpu_torch.core import rays as rays_lib
from nerf_tpu_torch.device import check_device, resolve_device
from nerf_tpu_torch.train import losses
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import render_rays_train

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def sample_train_rays(pixel_pool: torch.Tensor, poses: torch.Tensor,
                      img_idx: int, hw, focal, ray_num: int,
                      crop_window: Optional[Tuple[int, int, int, int]] = None,
                      generator: Optional[torch.Generator] = None,
                      picks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Pick ``ray_num`` random pixels of image ``img_idx`` and build rays.

    pixel_pool (N, H*W, 3) and poses (N, 3, 4) lie on the device.  Rows and
    columns are drawn uniformly, with replacement, inside ``crop_window``
    (x_lb, x_ub, y_lb, y_ub) when given; ``picks`` = (row, col) int tensors
    (ray_num,) replaces the draw.  Returns (rays (ray_num, 6), rgb_gt
    (ray_num, 3)).
    """
    h, w = hw
    x_lb, x_ub, y_lb, y_ub = crop_window if crop_window else (0, w, 0, h)
    dev = pixel_pool.device
    if picks is None:
        row = torch.randint(y_lb, y_ub, (ray_num,), generator=generator,
                            device=dev)
        col = torch.randint(x_lb, x_ub, (ray_num,), generator=generator,
                            device=dev)
    else:
        row, col = (t.to(dev, torch.int64) for t in picks)
    pix = row * w + col
    rgb_gt = pixel_pool.reshape(-1, 3)[img_idx * (h * w) + pix]
    coords = torch.stack((col - w // 2, h // 2 - row), dim=-1)
    rays = rays_lib.rays_from_coords(coords, poses[img_idx], focal)
    return rays, rgb_gt


def legacy_coarse_positions(coarse_pos: torch.Tensor,
                            last_fine_pos: torch.Tensor) -> torch.Tensor:
    """The merged positions that the reference's coarse_grad_select reads
    (ref_model.py:108-117, nerf_tpu/train/step.py:65-87): the last fine
    sample's position inserted into the sorted positions of coarse samples
    0..C-2.  coarse_pos (R, C), last_fine_pos (R,) -> (R, C) int64."""
    n_c = coarse_pos.shape[1]
    rc = coarse_pos[:, :n_c - 1].to(torch.int64)
    t = last_fine_pos[:, None].to(torch.int64)
    m = torch.sum(rc < t, dim=1, keepdim=True)
    k = torch.arange(n_c, device=coarse_pos.device)[None, :]
    shift = torch.clamp(torch.where(k < m, k, k - 1), 0, max(n_c - 2, 0))
    return torch.where(k == m, t, torch.gather(rc, 1, shift))


def _coarse_normal_loss(out, cfg: PipelineConfig) -> torch.Tensor:
    """The proposal net's normal loss: the fine density-gradient normals,
    gathered back to the coarse samples' merged positions, against the
    proposal's own.  By default the dropped largest coarse sample is masked
    out; ``legacy_coarse_select`` reads the reference's off-by-one
    positions instead."""
    dgrad = out["density_grad"]
    n_kept = dgrad.shape[1]
    cp = out["coarse_pos"].to(torch.int64)
    if cfg.legacy_coarse_select:
        lfp = torch.clamp_max(out["last_fine_pos"], n_kept - 1)
        q, valid = legacy_coarse_positions(cp, lfp), 1.0
    else:
        valid = (cp < n_kept).to(torch.float32)
        q = torch.clamp_max(cp, n_kept - 1)
    target = torch.gather(dgrad, 1, q[..., None].expand(-1, -1, 3))
    return losses.weighted_normal_loss(out["prop_weights"] * valid,
                                       target.detach(), out["coarse_grad"])


def compute_loss(models, rays: torch.Tensor, rgb_gt: torch.Tensor,
                 cfg: PipelineConfig, noise=None,
                 generator: Optional[torch.Generator] = None, device=None):
    """(loss, metrics) for one ray batch: the proposal loss over the
    detached fine weights plus the MSE of the fine render, and for Ref-NeRF
    ``normal_loss_w`` (normal loss + ``coarse_normal_rel_w`` coarse normal
    loss) + ``backface_w`` back-face loss; ``distortion_w`` times the
    reference's distortion loss over the fine weights and depths (Ref-NeRF:
    the merged ones) and ``entropy_w`` times the ray-entropy loss, where
    they are positive.  ``metrics`` holds img_loss,
    prop_loss, psnr and loss (Ref-NeRF: also normal_loss and bf_loss), as
    device tensors."""
    out = render_rays_train(models, rays, cfg, noise=noise,
                            generator=generator, device=device)
    img_loss = losses.mse(out["fine_rgb"], rgb_gt)
    prop_loss = losses.proposal_loss(out["bounds"], out["weights"].detach())
    loss = prop_loss + img_loss
    metrics = {"img_loss": img_loss, "prop_loss": prop_loss,
               "psnr": losses.mse_to_psnr(img_loss)}
    if cfg.model == "ref":
        normal_loss = losses.weighted_normal_loss(
            out["weights"], out["density_grad"], out["pred_normal"])
        bf_loss = losses.backface_loss(out["weights"], out["pred_normal"],
                                       out["fine_dirs"])
        coarse = (_coarse_normal_loss(out, cfg) if cfg.prop_normal
                  else 0.0)
        loss = loss + cfg.normal_loss_w * (
            normal_loss + cfg.coarse_normal_rel_w * coarse) \
            + cfg.backface_w * bf_loss
        metrics.update(normal_loss=normal_loss, bf_loss=bf_loss)
    if cfg.distortion_w > 0.0:
        z = out["z_merged"] if "z_merged" in out else out["z_fine"]
        loss = loss + cfg.distortion_w * losses.reference_distortion_loss(
            out["weights"], z)
    if cfg.entropy_w > 0.0:
        loss = loss + cfg.entropy_w * losses.ray_entropy_loss(
            out["weights"], cfg.entropy_acc_threshold)
    metrics["loss"] = loss
    return loss, metrics


def train_parameters(models) -> list:
    """The trained parameters: the fine net's, then the proposal net's."""
    return [p for m in models for p in m.parameters()]


def make_optimizer(models, lr: float = 0.0) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8) over both nets (train.py:118-121 of the
    reference); ``train_step`` sets the rate before every update."""
    return torch.optim.Adam(train_parameters(models), lr=lr,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every grad scaled by
    max_norm / norm where the global norm is not below ``max_norm``
    (``where(norm < max, g, g / norm * max)``; no epsilon).  Returns the
    norm, on the device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def train_step(models, optimizer: torch.optim.Optimizer, rays: torch.Tensor,
               rgb_gt: torch.Tensor, cfg: PipelineConfig, lr: float,
               grad_clip: float = -1.0, noise=None,
               generator: Optional[torch.Generator] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """One update of both nets: loss, grads, optional clipping, Adam at
    rate ``lr``.  Returns the step's metrics, detached, on the device."""
    dev = resolve_device(device)
    check_device(rays, dev, "rays")
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = compute_loss(models, rays, rgb_gt, cfg, noise=noise,
                                 generator=generator, device=dev)
    loss.backward()
    if grad_clip > 0.0:
        clip_by_global_norm_([p.grad for g in optimizer.param_groups
                              for p in g["params"]], grad_clip)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}
