"""Full-image eval renderer (port of nerf_tpu/train/renderer.py:25-195),
with the depth and (Ref-NeRF) normal maps, on one device or sharded over a
process group.

The frame's rays go through ``render_rays_eval`` in chunks of ``chunk`` rays
(``--eval_chunk``).  Noise is drawn for the whole frame at the unpadded pixel
count and padded with 0.5, so the render does not depend on the chunk size.
Sharded over a group of ``n`` ranks, the frame is padded to a grid of
``chunk * n`` rays (``:119-121``); each rank renders its contiguous share of
the chunks and an all_gather joins them, so the frame equals the
single-process frame bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.core import rays as rays_lib
from nerf_tpu_torch.core.sampling import sorted_uniforms
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import render_rays_eval


def _pad_noise(jitter: torch.Tensor, u: torch.Tensor, pad: int):
    """Pad per-pixel noise rows with 0.5 (a valid sorted row) to the
    chunked length; padded rows are sliced away after the render."""
    return (torch.cat([jitter, jitter.new_full((pad, jitter.shape[1]), 0.5)]),
            torch.cat([u, u.new_full((pad, u.shape[1]), 0.5)]))


@torch.no_grad()
def render_image(models, c2w, hw, focal, cfg: PipelineConfig,
                 sample_num: Optional[int] = None, render_depth: bool = False,
                 render_normal: bool = False,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 chunk: int = 4096, device=None,
                 group=None) -> Dict[str, np.ndarray]:
    """Render a full frame; returns numpy images in [0, 1].

    ``c2w`` is a (3, 4) or (4, 4) camera-to-world pose.  ``noise`` =
    (jitter (H*W, n_coarse), or (H*W, n_coarse + 1) for Mip-NeRF's coarse
    edges, sorted uniforms (H*W, sample_num + 1)) replaces the draws from
    ``generator`` (a generator on ``device``).
    ``render_normal`` adds the normal map along the camera axis c2w[:, 2];
    it is honoured only for the ref model.  With ``group`` (a process
    group that every rank of it calls this with, on the same inputs) each
    rank renders its share of the chunks.
    """
    dev = resolve_device(device)
    sample_num = cfg.n_fine if sample_num is None else int(sample_num)
    h, w = int(hw[0]), int(hw[1])
    c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :], device=dev)
    rays = rays_lib.full_image_rays(h, w, c2w, (float(focal[0]),
                                                float(focal[1])))
    n_pix = h * w
    ranks, rank = ((dist.get_world_size(group), dist.get_rank(group))
                   if group is not None else (1, 0))
    pad = (-n_pix) % (chunk * ranks)
    rays = torch.cat([rays, rays.new_ones((pad, 6))])
    if noise is None:
        n_strat = cfg.n_coarse + (1 if cfg.model == "mip" else 0)
        jitter = torch.rand((n_pix, n_strat), generator=generator,
                            device=dev)
        u = sorted_uniforms((n_pix, sample_num + 1), generator, device=dev)
    else:
        jitter, u = (t.to(dev, torch.float32) for t in noise)
    jitter, u = _pad_noise(jitter, u, pad)
    normal_cam_dir = (c2w[:, 2] if render_normal and cfg.model == "ref"
                      else None)

    share = (n_pix + pad) // ranks
    chunks = {"rgb": [], "depth": [], "normal": []}
    for s in range(rank * share, (rank + 1) * share, chunk):
        out, extras = render_rays_eval(
            models, rays[s:s + chunk], cfg, sample_num=sample_num,
            render_depth=render_depth, normal_cam_dir=normal_cam_dir,
            noise=(jitter[s:s + chunk], u[s:s + chunk]), device=dev)
        chunks["rgb"].append(out)
        for k, v in extras.items():
            chunks[k].append(v)
    shapes = {"rgb": (h, w, 3), "depth": (h, w), "normal": (h, w)}
    out = {k: torch.cat(v) for k, v in chunks.items() if v}
    if group is not None:
        for k, v in out.items():
            parts = [torch.empty_like(v) for _ in range(ranks)]
            dist.all_gather(parts, v, group=group)
            out[k] = torch.cat(parts)
    return {k: v[:n_pix].reshape(shapes[k]).cpu().numpy()
            for k, v in out.items()}
