"""The render pipeline, train and eval: proposal -> importance sampling ->
fine model (port of nerf_tpu/train/pipeline.py: the vanilla and Ref-NeRF
branches of ``render_rays_train`` :483-577 and ``render_rays_eval``
:580-671, ``_proposal_weights`` :202-242 and ``_ref_fine_forward`` with its
all-kernel and hybrid routes :263-390, :393-451).

Models are ``nn.Module``s holding their weights, so where the JAX functions
take ``(models, variables, ..., key)`` these take ``(models, ...)`` and an
optional ``torch.Generator``.  ``noise=(jitter, u)`` injects the draws, as in
the JAX package.

Training runs the MLPs through the fused kernels' autograd Functions
(``ops.PropMLP``, ``ops.VanillaMLP``, ``ops.RefSpatialMLP`` and
``ops.RefDirectionalMLP``; with ``cfg.store_residuals=False`` their
recompute forms ``ops.VanillaMLPRecompute``, ``ops.RefSpatialMLPRecompute``
and ``ops.RefDirectionalMLPRecompute``, which hold no activation from the
forward to the backward; the proposal net's residual form ``ops.PropMLPRes``
where ``prop_store_residuals`` resolves to True) unless ``cfg.use_pallas``
is False, which selects the ``nn.Module`` forward with autograd: the
oracle.
``cfg.ref_kernels="hybrid"`` runs Ref-NeRF's spatial net through its kernel
(the recompute pair in training) and the directional net through
``RefNeRF.directional``.  Ref-NeRF's normal target d(density)/d(pos) comes
from the spatial kernel on the kernel route and from
``torch.autograd.grad`` on the module route, which is also taken for
``second_order_normals`` and, for the proposal net, ``--prop_normal``.
Eval runs the MLPs through the forward-only kernels unless
``cfg.eval_use_pallas`` is False.  (The JAX package renders vanilla eval
through XLA by default; that choice rested on one TPU measurement and does
not carry over.)
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
    PropMLP, PropMLPRes, RefDirectionalMLP, RefDirectionalMLPRecompute,
    RefSpatialMLP, RefSpatialMLPRecompute, VanillaMLP, VanillaMLPRecompute,
    prop_mlp_fwd, ref_fine_fwd, ref_spa_fwd, vanilla_mlp_fwd,
)
from nerf_tpu_torch.ops.ref_fused import normal_target, softplus
from nerf_tpu_torch.train.config import PipelineConfig

_NOT_PORTED = ("the {} path is not ported to nerf_tpu_torch yet; see "
               "ROADMAP.md (section A) for the order of the remaining slices")


def _require_ported(cfg: PipelineConfig) -> None:
    """Raise for the paths not ported yet: Mip-NeRF and IPE."""
    if cfg.model == "mip":
        raise NotImplementedError(_NOT_PORTED.format(
            "Mip-NeRF (-m, _mip_pass; ROADMAP.md A5)"))
    if cfg.model not in ("vanilla", "ref"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.use_ipe:
        raise NotImplementedError(_NOT_PORTED.format(
            "IPE (--use_ipe; ROADMAP.md A5)"))


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
                       use_srgb=cfg.use_srgb,
                       perturb_bottleneck=cfg.bottleneck_noise, dtype=dtype)
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
    return cfg.use_pallas is not False


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

    In training the kernel route is ``VanillaMLP`` (``VanillaMLPRecompute``
    with ``store_residuals=False``) over the f32 parameters; the points
    carry no gradient (their depths come from detached weights)."""
    r, p = pos.shape[:2]
    enc_d = _ray_dir_encoding(nerf, ray_dirs, p)
    if not _use_kernels(cfg, train):
        rgb, sigma = nerf(pos, None, enc_d=enc_d)
        return rgb.permute(2, 0, 1), sigma
    cd = nerf.dtype
    enc_x = cat_pos_pe(pos.detach().reshape(r * p, 3), nerf.pos_levels, cd)
    enc_d = enc_d.reshape(r * p, -1).to(cd).contiguous()
    if train:
        fn = VanillaMLP if cfg.store_residuals else VanillaMLPRecompute
        rgb3, sigma = fn.apply(dev, enc_x, enc_d, *nerf.kernel_params())
    else:
        rgb3, sigma = vanilla_mlp_fwd(nerf.kernel_weights(), enc_x, enc_d,
                                      device=dev)
    return rgb3.reshape(3, r, p), sigma.reshape(r, p)


def _apply_prop(prop: ProposalNetwork, pts: torch.Tensor,
                cfg: PipelineConfig, dev, train: bool = False) -> torch.Tensor:
    """Proposal net on points (R, P, 3) -> raw density (R, P).

    In training the kernel route is ``PropMLP`` (the recompute pair), or
    ``PropMLPRes`` where the proposal net's form resolves to residual: it
    follows ``store_residuals`` when ``prop_store_residuals`` is None
    (nerf_tpu/train/pipeline.py:193-198)."""
    if not _use_kernels(cfg, train):
        return prop(pts)
    r, p = pts.shape[:2]
    enc = cat_pos_pe(pts.detach().reshape(r * p, 3), prop.pos_levels,
                     prop.dtype)
    if train:
        res = (cfg.store_residuals if cfg.prop_store_residuals is None
               else cfg.prop_store_residuals)
        fn = PropMLPRes if res else PropMLP
        return fn.apply(dev, enc, *prop.kernel_params()).reshape(r, p)
    return prop_mlp_fwd(prop.kernel_weights(), enc, device=dev).reshape(r, p)


def _identity(x):
    return x


def _ref_kernel_route(cfg: PipelineConfig, train: bool) -> bool:
    if cfg.ref_kernels not in ("all", "hybrid"):
        raise ValueError(f"unknown ref_kernels {cfg.ref_kernels!r}")
    return _use_kernels(cfg, train)


def _normal_target(g: torch.Tensor, second_order: bool) -> torch.Tensor:
    """The normal target of g, detached unless ``second_order``."""
    target = normal_target(g)
    return target if second_order else target.detach()


def _ref_fine_forward(nerf: RefNeRF, pos: torch.Tensor,
                      ray_dirs: torch.Tensor, cfg: PipelineConfig, dev):
    """Ref-NeRF on points (R, P, 3) of rays with directions (R, 3), eval:
    (rgb (R, P, 3), raw density (R, P), normal (R, P, 3)), f32.

    The kernel route is ``_ref_fine_forward_allkernel`` without the density
    gradient and with zero noise (``ops.ref_fine_fwd``), or under
    ``ref_kernels="hybrid"`` ``_ref_fine_forward_hybrid``; with
    ``eval_use_pallas=False`` the ``RefNeRF`` module runs, the oracle."""
    r, p = pos.shape[:2]
    if not _ref_kernel_route(cfg, train=False):
        return nerf(pos, ray_dirs[:, None, :].expand(r, p, 3))
    if cfg.ref_kernels == "hybrid":
        return _ref_fine_forward_hybrid(nerf, pos, ray_dirs, cfg, dev)[:3]
    enc = cat_pos_pe(pos.reshape(r * p, 3), nerf.pos_levels, nerf.dtype)
    spa_ws, dir_ws = nerf.kernel_weights()
    rgb, density, normal = ref_fine_fwd(
        spa_ws, dir_ws, enc, ray_dirs.to(torch.float32).contiguous(), p,
        ide_level=nerf.ide_level, use_srgb=nerf.use_srgb, device=dev)
    return (rgb.reshape(r, p, 3), density.reshape(r, p),
            normal.reshape(r, p, 3))


def _ref_fine_forward_train(nerf: RefNeRF, pos: torch.Tensor,
                            ray_dirs: torch.Tensor, cfg: PipelineConfig, dev,
                            generator: Optional[torch.Generator] = None):
    """Ref-NeRF on points (R, P, 3), training: (rgb (R, P, 3), raw density
    (R, P), normal (R, P, 3), normal target (R, P, 3)), f32.

    Kernel route (``_ref_fine_forward_allkernel``): ``RefSpatialMLP`` gives
    the heads and the detached normal target, ``RefDirectionalMLP`` the rgb,
    normal and density (their recompute forms with
    ``store_residuals=False``), with the bottleneck noise
    ``bottleneck_noise * N(0, 1)`` drawn from ``generator`` in the compute
    dtype (its values differ from the JAX package's draw, as the JAX
    package's own two routes differ).  ``ref_kernels="hybrid"``:
    ``_ref_fine_forward_hybrid``.  Module route (``use_pallas=False`` or
    ``second_order_normals``): ``RefNeRF.spatial`` on points that require
    grad, the target from ``torch.autograd.grad`` of the density."""
    r, p = pos.shape[:2]
    n = r * p
    second_order = cfg.second_order_normals
    if second_order or not _ref_kernel_route(cfg, train=True):
        pts = pos.detach().requires_grad_()
        spa = nerf.spatial(pts)
        (g,) = torch.autograd.grad(spa["density"].sum(), pts,
                                   retain_graph=True,
                                   create_graph=second_order)
        rgb = nerf.directional(spa, ray_dirs[:, None, :].expand(r, p, 3),
                               train=True, generator=generator)
        return (rgb, spa["density"], spa["normal"],
                _normal_target(g, second_order))
    if cfg.ref_kernels == "hybrid":
        return _ref_fine_forward_hybrid(nerf, pos, ray_dirs, cfg, dev,
                                        generator, train=True)
    cd = nerf.dtype
    pos_f = pos.detach().reshape(n, 3).to(torch.float32).contiguous()
    enc = cat_pos_pe(pos_f, nerf.pos_levels, cd)
    noise = None
    if nerf.perturb_bottleneck > 0:
        noise = nerf.perturb_bottleneck * torch.randn(
            (n, nerf.bottleneck_dim), dtype=cd, generator=generator,
            device=pos.device)
    spa_params, dir_params = nerf.kernel_params()
    spa_fn, dir_fn = (
        (RefSpatialMLP, RefDirectionalMLP) if cfg.store_residuals
        else (RefSpatialMLPRecompute, RefDirectionalMLPRecompute))
    heads, dgrad = spa_fn.apply(dev, cfg.pallas_tile, enc, pos_f, *spa_params)
    rgb, normal, density = dir_fn.apply(
        dev, cfg.pallas_tile, heads,
        ray_dirs.detach().to(torch.float32).contiguous(), noise, p,
        nerf.ide_level, nerf.use_srgb, cd, *dir_params)
    return (rgb.reshape(r, p, 3), density.reshape(r, p),
            normal.reshape(r, p, 3), dgrad.reshape(r, p, 3))


def _ref_fine_forward_hybrid(nerf: RefNeRF, pos: torch.Tensor,
                             ray_dirs: torch.Tensor, cfg: PipelineConfig, dev,
                             generator: Optional[torch.Generator] = None,
                             train: bool = False):
    """``_ref_fine_forward_fused`` (nerf_tpu/train/pipeline.py:329-390), the
    ``ref_kernels="hybrid"`` route: the spatial net through its kernel, then
    ``RefNeRF.directional`` on the heads.  (rgb (R, P, 3), raw density
    (R, P), normal (R, P, 3), and in training the detached normal target
    (R, P, 3), else None), f32.

    Training runs ``RefSpatialMLPRecompute`` (the recompute pair, whatever
    ``store_residuals`` says, as ``_make_spa_fused``'s default does), eval
    the forward-only ``ops.ref_spa_fwd``.  The heads go through the
    post-processing of ``RefNeRF.spatial`` as the JAX route writes it: the
    normal -h / (|h| + 1e-7) in f32; softplus(rho - 1), diffuse, tint and
    the bottleneck cast to the compute dtype.  Gradients reach the spatial
    weights through the heads; the bottleneck noise is the directional
    module's, drawn from ``generator``."""
    r, p = pos.shape[:2]
    n = r * p
    cd = nerf.dtype
    pos_f = pos.detach().reshape(n, 3).to(torch.float32).contiguous()
    enc = cat_pos_pe(pos_f, nerf.pos_levels, cd)
    target = None
    if train:
        heads, dgrad = RefSpatialMLPRecompute.apply(
            dev, cfg.pallas_tile, enc, pos_f, *nerf.kernel_params()[0])
        target = dgrad.reshape(r, p, 3)
    else:
        heads = ref_spa_fwd(nerf.kernel_weights()[0], enc, device=dev)
    n_raw = heads[:, 2:5]
    normal = -n_raw / (torch.linalg.vector_norm(n_raw, dim=-1, keepdim=True)
                       + 1e-7)
    spatial_out = {
        "density": heads[:, 1].reshape(r, p),
        "normal": normal.reshape(r, p, 3),
        "roughness": softplus(heads[:, 0:1] - 1.0).to(cd).reshape(r, p, 1),
        "diffuse": heads[:, 5:8].to(cd).reshape(r, p, 3),
        "tint": heads[:, 8:11].to(cd).reshape(r, p, 3),
        "bottleneck": heads[:, 11:].to(cd).reshape(r, p, -1),
    }
    rgb = nerf.directional(spatial_out, ray_dirs[:, None, :].expand(r, p, 3),
                           train=train, generator=generator)
    return rgb, spatial_out["density"], spatial_out["normal"], target


def _proposal_weights(prop: ProposalNetwork, rays: torch.Tensor,
                      c_z: torch.Tensor, cfg: PipelineConfig, dev,
                      train: bool = False, with_grad: bool = False):
    """(proposal weights, max-blurred, and with ``with_grad`` the coarse
    normals -g / max(1e-5, |g|) (R, C, 3) of the density's gradient g, else
    None).  Training applies softplus to the raw density before the
    transmittance; eval applies relu inside it (the reference's eval path
    never applies softplus).  Depths scaled by |d|.  ``with_grad`` runs the
    ``ProposalNetwork`` module, whose input gradient the kernel does not
    give (pipeline.py:213-228)."""
    c_pts = render_lib.lengths_to_points(rays, c_z)
    coarse_grad = None
    if with_grad:
        c_pts = c_pts.detach().requires_grad_()
        density = prop(c_pts)
        (g,) = torch.autograd.grad(density.sum(), c_pts, retain_graph=True,
                                   create_graph=cfg.second_order_normals)
        coarse_grad = _normal_target(g, cfg.second_order_normals)
    else:
        density = _apply_prop(prop, c_pts, cfg, dev, train)
    if train:
        density = torch.nn.functional.softplus(density)
    w_raw = render_lib.transmittance_weights(
        density, c_z, ray_dirs=rays[..., 3:],
        density_act=_identity if train else torch.relu)
    return sampling.max_blur_filter(w_raw, cfg.max_blur_alpha), coarse_grad


def render_rays_train(models, rays: torch.Tensor, cfg: PipelineConfig,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      device=None):
    """Training forward for a ray batch rays (R, 6): a dict with fine_rgb
    (R, 3), weights (R, P), prop_weights (R, n_coarse), bounds (R, P) and
    bounds_idx (R, P + 1).  Vanilla: z_fine (R, P), P = n_fine.  Ref-NeRF
    (P = n_coarse + n_fine - 1 merged samples): pred_normal and
    density_grad (R, P, 3), fine_dirs (R, 3), coarse_pos (R, n_coarse),
    z_merged (R, P), and under ``--prop_normal`` coarse_grad (R, n_coarse,
    3) and last_fine_pos (R,).

    ``noise`` = (stratified jitter (R, n_coarse), sorted inverse-CDF uniforms
    (R, n_fine + 1)) replaces the draws from ``generator``, which also draws
    the bottleneck noise.  ``device`` defaults to ``cuda``; ``rays`` must lie
    there.
    """
    _require_ported(cfg)
    dev = resolve_device(device)
    check_device(rays, dev, "rays")
    nerf, prop = models
    ref = cfg.model == "ref"
    jitter, u = (None, None) if noise is None else noise
    c_z = sampling.stratified_samples(rays.shape[0], cfg.n_coarse, cfg.near,
                                      cfg.far, jitter=jitter,
                                      generator=generator, device=rays.device)
    prop_grad = ref and cfg.prop_normal
    w_blur, coarse_grad = _proposal_weights(prop, rays, c_z, cfg, dev,
                                            train=True, with_grad=prop_grad)
    f_z, below = sampling.inverse_sample(w_blur, c_z, cfg.n_fine + 1, u=u,
                                         generator=generator)
    out = {"prop_weights": w_blur}
    if ref:
        z_merged, coarse_pos, idx_full = sampling.merge_coarse_fine(
            c_z, f_z, below)
        pos = render_lib.lengths_to_points(rays, z_merged)
        rgb, raw_density, pred_normal, density_grad = \
            _ref_fine_forward_train(nerf, pos, rays[:, 3:], cfg, dev,
                                    generator)
        fine_rgb, weights, _ = render_lib.composite(
            rgb, softplus(raw_density + 0.5), z_merged, rays[:, 3:],
            density_act=_identity)
        out.update(fine_rgb=fine_rgb, weights=weights, bounds_idx=idx_full,
                   pred_normal=pred_normal, density_grad=density_grad,
                   fine_dirs=rays[:, 3:], coarse_pos=coarse_pos,
                   z_merged=z_merged)
        if prop_grad:
            # the merged position of the last fine sample, which the
            # reference's off-by-one coarse selection reads as coarse
            out["coarse_grad"] = coarse_grad
            out["last_fine_pos"] = cfg.n_fine + sampling.count_lt(
                c_z, f_z[:, -1:])[:, 0]
    else:
        z_fine = f_z[..., :-1]
        pos = render_lib.lengths_to_points(rays, z_fine)
        rgb3, sigma = _apply_vanilla(nerf, pos, rays[:, 3:], cfg, dev,
                                     train=True)
        fine_rgb, weights = render_lib.composite_rl(rgb3, sigma, z_fine,
                                                    rays[:, 3:])
        out.update(fine_rgb=fine_rgb, weights=weights, bounds_idx=below,
                   z_fine=z_fine)
    out["bounds"] = sampling.weight_bounds(w_blur, out["bounds_idx"])
    return out


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
    w_blur, _ = _proposal_weights(prop, rays, c_z, cfg, dev)
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
