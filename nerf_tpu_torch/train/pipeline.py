"""The render pipeline, train and eval: proposal -> importance sampling ->
fine model (port of nerf_tpu/train/pipeline.py: the vanilla branch of
``render_rays_train`` :483-577, and the vanilla and Ref-NeRF branches of
``render_rays_eval`` :580-671 with ``_ref_fine_forward``'s eval route
:263-326, :393-451).

Models are ``nn.Module``s holding their weights, so where the JAX functions
take ``(models, variables, ..., key)`` these take ``(models, ...)`` and an
optional ``torch.Generator``.  ``noise=(jitter, u)`` injects the draws, as in
the JAX package.

Training runs the MLPs through the fused kernels' autograd Functions
(``ops.PropMLP``, ``ops.VanillaMLP``) unless ``cfg.use_pallas`` is False,
which selects the ``nn.Module`` forward with autograd: the oracle.  Eval runs
them through the forward-only kernels unless ``cfg.eval_use_pallas`` is
False.  (The JAX package renders vanilla eval through XLA by default; that
choice rested on one TPU measurement and does not carry over.)  Ref-NeRF
renders (the proposal kernel, then the spatial and directional kernels of
``ops/ref_fused.py``, or ``RefNeRF``); its training is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_tpu_torch.core import render as render_lib
from nerf_tpu_torch.core import sampling
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.device import check_device, resolve_device
from nerf_tpu_torch.models import ProposalNetwork, RefNeRF, VanillaNeRF
from nerf_tpu_torch.models.mlp import init_flax_
from nerf_tpu_torch.ops import (
    PropMLP, VanillaMLP, prop_mlp_fwd, ref_fine_fwd, vanilla_mlp_fwd,
)
from nerf_tpu_torch.ops.ref_fused import softplus
from nerf_tpu_torch.train.config import PipelineConfig

_NOT_PORTED = ("the {} path is not ported to nerf_tpu_torch yet; see "
               "ROADMAP.md (section A) for the order of the remaining slices")


def _require_ported(cfg: PipelineConfig, train: bool = False) -> None:
    """Raise for the paths not ported yet: Mip-NeRF, IPE and Ref-NeRF
    training."""
    if cfg.model == "mip":
        raise NotImplementedError(_NOT_PORTED.format("Mip-NeRF (-m, _mip_pass)"))
    if cfg.model not in ("vanilla", "ref"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.use_ipe:
        raise NotImplementedError(_NOT_PORTED.format("IPE (--use_ipe)"))
    if train and cfg.model == "ref":
        raise NotImplementedError(_NOT_PORTED.format(
            "Ref-NeRF training (-t without -r; ROADMAP.md A6)"))


def make_models(cfg: PipelineConfig, device=None,
                generator: Optional[torch.Generator] = None):
    """(VanillaNeRF or RefNeRF, ProposalNetwork) on ``device`` with
    flax-initialized weights drawn from ``generator`` (a CPU generator;
    seed 0 if None)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if cfg.model == "ref":
        nerf = RefNeRF(ide_level=cfg.ide_level, hidden=cfg.nerf_width,
                       use_srgb=cfg.use_srgb, dtype=dtype)
    else:
        nerf = VanillaNeRF(hidden=cfg.nerf_width, dtype=dtype)
    nerf = init_flax_(nerf, generator)
    prop = init_flax_(ProposalNetwork(hidden=cfg.prop_width, dtype=dtype),
                      generator)
    return nerf.to(dev).eval(), prop.to(dev).eval()


def init_variables(cfg: PipelineConfig,
                   generator: Optional[torch.Generator] = None):
    """{"nerf": state_dict, "prop": state_dict} of freshly initialized
    models, on the CPU."""
    nerf, prop = make_models(cfg, "cpu", generator)
    return {"nerf": nerf.state_dict(), "prop": prop.state_dict()}


def _use_kernels(cfg: PipelineConfig, train: bool) -> bool:
    if not train:
        return cfg.eval_use_pallas is not False
    if cfg.use_pallas is False:
        return False
    # the shipped training variants (nerf_tpu/train/config.py:93,102) are
    # the ported ones; the others raise rather than run something else
    if not cfg.store_residuals:
        raise NotImplementedError(_NOT_PORTED.format(
            "recompute vanilla backward (store_residuals=False, "
            "_vanilla_bwd_kernel; ROADMAP.md B2)"))
    prop_res = (cfg.store_residuals if cfg.prop_store_residuals is None
                else cfg.prop_store_residuals)
    if prop_res:
        raise NotImplementedError(_NOT_PORTED.format(
            "residual proposal pair (prop_store_residuals=True, "
            "_prop_fwd_res_kernel/_prop_bwd_res_kernel; ROADMAP.md B1)"))
    return True


def _ray_dir_encoding(nerf: VanillaNeRF, ray_dirs: torch.Tensor,
                      n_samples: int) -> torch.Tensor:
    """Per-ray [d/|d|, PE(d/|d|, 4)] (R, 27) broadcast to (R, P, 27).

    Encoding per ray and broadcasting the finished rows gives the same bits
    as encoding per point."""
    enc = nerf.encode_dirs(ray_dirs)
    return enc[:, None, :].expand(-1, n_samples, -1)


def _apply_vanilla(nerf: VanillaNeRF, pos: torch.Tensor,
                   ray_dirs: torch.Tensor, cfg: PipelineConfig, dev,
                   train: bool = False):
    """Fine net on points (R, P, 3) -> (rgb3 (3, R, P), raw sigma (R, P)).

    In training the kernel route is ``VanillaMLP`` over the f32 parameters;
    the points carry no gradient (their depths come from detached weights)."""
    r, p = pos.shape[:2]
    enc_d = _ray_dir_encoding(nerf, ray_dirs, p)
    if not _use_kernels(cfg, train):
        rgb, sigma = nerf(pos, None, enc_d=enc_d)
        return rgb.permute(2, 0, 1), sigma
    cd = nerf.dtype
    enc_x = cat_pos_pe(pos.detach().reshape(r * p, 3), nerf.pos_levels, cd)
    enc_d = enc_d.reshape(r * p, -1).to(cd).contiguous()
    if train:
        rgb3, sigma = VanillaMLP.apply(dev, enc_x, enc_d,
                                       *nerf.kernel_params())
    else:
        rgb3, sigma = vanilla_mlp_fwd(nerf.kernel_weights(), enc_x, enc_d,
                                      device=dev)
    return rgb3.reshape(3, r, p), sigma.reshape(r, p)


def _apply_prop(prop: ProposalNetwork, pts: torch.Tensor,
                cfg: PipelineConfig, dev, train: bool = False) -> torch.Tensor:
    """Proposal net on points (R, P, 3) -> raw density (R, P)."""
    if not _use_kernels(cfg, train):
        return prop(pts)
    r, p = pts.shape[:2]
    enc = cat_pos_pe(pts.detach().reshape(r * p, 3), prop.pos_levels,
                     prop.dtype)
    if train:
        return PropMLP.apply(dev, enc, *prop.kernel_params()).reshape(r, p)
    return prop_mlp_fwd(prop.kernel_weights(), enc, device=dev).reshape(r, p)


def _identity(x):
    return x


def _ref_fine_forward(nerf: RefNeRF, pos: torch.Tensor,
                      ray_dirs: torch.Tensor, cfg: PipelineConfig, dev):
    """Ref-NeRF on points (R, P, 3) of rays with directions (R, 3), eval:
    (rgb (R, P, 3), raw density (R, P), normal (R, P, 3)), f32.

    The kernel route is ``_ref_fine_forward_allkernel`` without the density
    gradient and with zero noise (``ops.ref_fine_fwd``); with
    ``eval_use_pallas=False`` the ``RefNeRF`` module runs, the oracle."""
    r, p = pos.shape[:2]
    if not _use_kernels(cfg, train=False):
        return nerf(pos, ray_dirs[:, None, :].expand(r, p, 3))
    if cfg.ref_kernels != "all":
        raise NotImplementedError(_NOT_PORTED.format(
            f"ref_kernels={cfg.ref_kernels!r} (_ref_fine_forward_fused; "
            "ROADMAP.md B5)"))
    enc = cat_pos_pe(pos.reshape(r * p, 3), nerf.pos_levels, nerf.dtype)
    spa_ws, dir_ws = nerf.kernel_weights()
    rgb, density, normal = ref_fine_fwd(
        spa_ws, dir_ws, enc, ray_dirs.to(torch.float32).contiguous(), p,
        ide_level=nerf.ide_level, use_srgb=nerf.use_srgb, device=dev)
    return (rgb.reshape(r, p, 3), density.reshape(r, p),
            normal.reshape(r, p, 3))


def _proposal_weights(prop: ProposalNetwork, rays: torch.Tensor,
                      c_z: torch.Tensor, cfg: PipelineConfig, dev,
                      train: bool = False):
    """Proposal weights, max-blurred.  Training applies softplus to the raw
    density before the transmittance; eval applies relu inside it (the
    reference's eval path never applies softplus).  Depths scaled by |d|."""
    c_pts = render_lib.lengths_to_points(rays, c_z)
    density = _apply_prop(prop, c_pts, cfg, dev, train)
    if train:
        density = torch.nn.functional.softplus(density)
    w_raw = render_lib.transmittance_weights(
        density, c_z, ray_dirs=rays[..., 3:],
        density_act=(lambda x: x) if train else torch.relu)
    return sampling.max_blur_filter(w_raw, cfg.max_blur_alpha)


def render_rays_train(models, rays: torch.Tensor, cfg: PipelineConfig,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      device=None):
    """Training forward for a ray batch rays (R, 6): a dict with fine_rgb
    (R, 3), weights (R, P), prop_weights (R, n_coarse), bounds (R, P),
    bounds_idx (R, P + 1) and z_fine (R, P), P = n_fine.

    ``noise`` = (stratified jitter (R, n_coarse), sorted inverse-CDF uniforms
    (R, n_fine + 1)) replaces the draws from ``generator``.  ``device``
    defaults to ``cuda``; ``rays`` must lie there.
    """
    _require_ported(cfg, train=True)
    dev = resolve_device(device)
    check_device(rays, dev, "rays")
    nerf, prop = models
    jitter, u = (None, None) if noise is None else noise
    c_z = sampling.stratified_samples(rays.shape[0], cfg.n_coarse, cfg.near,
                                      cfg.far, jitter=jitter,
                                      generator=generator, device=rays.device)
    w_blur = _proposal_weights(prop, rays, c_z, cfg, dev, train=True)
    f_z, below = sampling.inverse_sample(w_blur, c_z, cfg.n_fine + 1, u=u,
                                         generator=generator)
    z_fine = f_z[..., :-1]
    pos = render_lib.lengths_to_points(rays, z_fine)
    rgb3, sigma = _apply_vanilla(nerf, pos, rays[:, 3:], cfg, dev, train=True)
    fine_rgb, weights = render_lib.composite_rl(rgb3, sigma, z_fine,
                                                rays[:, 3:])
    return {"fine_rgb": fine_rgb, "weights": weights, "prop_weights": w_blur,
            "bounds": sampling.weight_bounds(w_blur, below),
            "bounds_idx": below, "z_fine": z_fine}


@torch.no_grad()
def render_rays_eval(models, rays: torch.Tensor, cfg: PipelineConfig,
                     sample_num: Optional[int] = None,
                     render_depth: bool = False,
                     normal_cam_dir: Optional[torch.Tensor] = None,
                     noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """Eval forward for a ray batch rays (R, 6).  Returns (rgb (R, 3), extras).

    Ref-NeRF composites the merged coarse and fine depths with
    softplus(raw + 0.5) as the density; ``normal_cam_dir`` (3,) adds its
    normal map extra (ignored for the vanilla model).  ``noise`` =
    (stratified jitter (R, n_coarse), sorted inverse-CDF uniforms
    (R, sample_num + 1)) replaces the draws from ``generator``.  ``device``
    defaults to ``cuda``; ``rays`` must lie there.
    """
    _require_ported(cfg)
    dev = resolve_device(device)
    check_device(rays, dev, "rays")
    nerf, prop = models
    sample_num = cfg.n_fine if sample_num is None else sample_num
    jitter, u = (None, None) if noise is None else noise
    n_rays = rays.shape[0]

    c_z = sampling.stratified_samples(n_rays, cfg.n_coarse, cfg.near, cfg.far,
                                      jitter=jitter, generator=generator,
                                      device=rays.device)
    w_blur = _proposal_weights(prop, rays, c_z, cfg, dev)
    f_z, _ = sampling.inverse_sample(w_blur, c_z, sample_num + 1, u=u,
                                     generator=generator)
    normal_info = None
    if cfg.model == "ref":
        z_vals = sampling.merge_coarse_fine(c_z, f_z)
        pos = render_lib.lengths_to_points(rays, z_vals)
        rgb, raw_density, normal = _ref_fine_forward(nerf, pos, rays[:, 3:],
                                                     cfg, dev)
        density = softplus(raw_density + 0.5)
        act = _identity
        if normal_cam_dir is not None:
            normal_info = (normal, normal_cam_dir)
    else:
        z_vals = f_z[..., :-1]
        pos = render_lib.lengths_to_points(rays, z_vals)
        rgb3, density = _apply_vanilla(nerf, pos, rays[:, 3:], cfg, dev)
        rgb, act = rgb3.permute(1, 2, 0), torch.relu
    rgb_out, _, extras = render_lib.composite(
        rgb, density, z_vals, rays[:, 3:], white_bkg=cfg.white_bkg,
        density_act=act,
        depth_bounds=(cfg.near, cfg.far) if render_depth else None,
        normal_info=normal_info)
    return rgb_out, extras
