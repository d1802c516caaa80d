"""The Ref-NeRF directional kernels taken apart: wrappers of
``csrc/ref_dissect.cu`` and one plain version per stage and per mode.

Two kernels, CUDA C++ for ``sm_90a``, each replacing a Pallas
microbenchmark of tools/bench_ref_kernels.py (the JAX package's):

``ref_dir_fwd_dissect``
    ``_dissect_dir_fwd`` (:145): ``ref_dir_fwd`` stopped after one of five
    cumulative stages (``DIR_STAGES``): "trunk" (the IDE and d.n columns of
    the trunk input taken from ``rows`` (2C + 1, N) f32, the normal output
    the ray directions), "reflect" (+ the normal, d.n, the reflection and
    the roughness, added to the first 4 IDE rows), "vander" (+ the
    z-powers @ mat and the attenuation, in both IDE halves), "polar" (+ the
    complex powers: the full glue) and "full" (+ the rgb tail: the shipped
    kernel).  Below "full" rgb is sigmoid(z8 @ wh + bh).
``ref_dir_bwd_dissect``
    ``_dissect_dir_bwd`` (:45): ``ref_dir_bwd_recompute`` in one of four
    modes (``BWD_MODES``): "recompute" (the forward rebuild only; d(heads)
    holds rgb, normal and density in its first 7 columns, zeros after, the
    grads are zero), "dheads" (+ the delta pass and the glue's pullback:
    d(heads), zero grads), "wgrads" (+ the trunk's deltas, the weight-grad
    pass and its reduction: the grads, zero d(heads)) and "full" (the
    shipped kernel).

Each stage and mode is the shipped kernel's own code with a compile-time
switch, so stage "full" equals ``ref_dir_fwd`` and mode "full"
``ref_dir_bwd_recompute`` bit for bit, and the time between two stages or
modes is the cost of the part between them.  sRGB is off, as in the TPU
version.  ``LAUNCHES`` counts each wrapper call that launches, whatever its
stage or mode.  On the CPU a wrapper is its plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.ops.launch import (
    I64, INT, INTP, PTR, U64P, check_tensor, launch, pointers, register,
)
from nerf_tpu_torch.ops.ref_fused import (
    DIR_STAGES, F32, TILE, _check_dir, _dense, _dir_glue,
    _dir_trunk, _ide_operands, check_dir_bwd_operands,
    launch_dir_bwd_recompute, ref_dir_bwd_recompute_plain, ref_dir_plain,
)

# the modes of the directional backward (ref_dir_recompute.cuh's
# BWD_RECOMPUTE .. BWD_FULL)
BWD_MODES = ("recompute", "dheads", "wgrads", "full")

register({
    "ref_dir_fwd_dissect": ("ref_dissect", [
        INT, PTR, PTR, PTR, I64, PTR, PTR, PTR, U64P, I64, INTP, PTR, PTR,
        PTR]),
    "ref_dir_bwd_dissect": ("ref_dissect", [
        INT, PTR, PTR, PTR, I64, PTR, PTR, PTR, PTR, PTR, U64P, I64, INTP,
        PTR, U64P, U64P, PTR, PTR, PTR, I64, I64, U64P]),
})


def _stage_index(stage: str) -> int:
    if stage not in DIR_STAGES:
        raise ValueError(f"stage must be one of {DIR_STAGES}, got {stage!r}")
    return DIR_STAGES.index(stage)


def _mode_index(mode: str) -> int:
    if mode not in BWD_MODES:
        raise ValueError(f"mode must be one of {BWD_MODES}, got {mode!r}")
    return BWD_MODES.index(mode)


def ref_dir_fwd_dissect_plain(ws, heads, dirs, per_ray: int, stage: str,
                              noise=None, rows=None, ide_level: int = 4):
    """Stage ``stage`` of the directional forward in plain PyTorch, on
    ``ref_fused``'s plain glue and trunk: (rgb (N, 3), normal (N, 3),
    density (N,)) f32."""
    if stage == "full":
        return ref_dir_plain(ws, heads, dirs, per_ray, noise, ide_level)
    heads = heads.to(F32)
    x, normal, _, _ = _dir_glue(heads, dirs, per_ray, noise, ide_level,
                                False, ws[0].dtype, stage, rows)
    z8 = _dir_trunk(ws, x)[7]
    return (torch.sigmoid(_dense(z8, ws[17], ws[18])), normal,
            heads[:, 1].contiguous())


def ref_dir_bwd_dissect_plain(ws, heads, dirs, per_ray: int, noise, g_rgb,
                              g_normal, g_density, mode: str,
                              ide_level: int = 4, tile: int = TILE,
                              acts=None):
    """Mode ``mode`` of the recompute-form directional backward in plain
    PyTorch, on ``ref_dir_bwd_recompute_plain``: (d(heads) (N, 11 + NB),
    the 19 grads), f32, with zeros where the mode computes nothing.
    ``acts`` gives the trunk's activations, as for the full backward's
    plain version."""
    _mode_index(mode)
    heads = heads.to(F32)
    if mode == "recompute":
        rgb, normal, density = ref_dir_plain(ws, heads, dirs, per_ray, noise,
                                             ide_level)
        dheads = torch.zeros_like(heads)
        dheads[:, :3], dheads[:, 3:6], dheads[:, 6] = rgb, normal, density
        return dheads, tuple(torch.zeros(w.shape, dtype=F32,
                                         device=heads.device) for w in ws)
    dheads, grads = ref_dir_bwd_recompute_plain(
        ws, heads, dirs, per_ray, noise, g_rgb, g_normal, g_density,
        ide_level, False, tile, acts=acts)
    if mode == "dheads":
        grads = tuple(torch.zeros_like(g) for g in grads)
    elif mode == "wgrads":
        dheads = torch.zeros_like(dheads)
    return dheads, grads


def ref_dir_fwd_dissect(ws, heads: torch.Tensor, dirs: torch.Tensor,
                        per_ray: int, stage: str, noise=None, rows=None,
                        ide_level: int = 4, device=None):
    """``ref_dir_fwd`` (sRGB off) stopped after stage ``stage``: (rgb (N,
    3), normal (N, 3), density (N,)) f32.  "trunk" and "reflect" take
    ``rows`` (2C + 1, N) f32, the trunk input's IDE and d.n rows.  On the
    CPU this is ``ref_dir_fwd_dissect_plain``."""
    dev = resolve_device(device)
    index = _stage_index(stage)
    n, nb, h, o, l_max, n_ch, cd = _check_dir(ws, heads, dirs, per_ray,
                                              noise, ide_level, dev)
    if index <= DIR_STAGES.index("reflect"):
        if rows is None:
            raise ValueError(f"stage {stage!r} takes the input rows")
        check_tensor(rows, (2 * n_ch + 1, n), F32, dev, "rows")
    if dev.type == "cpu":
        return ref_dir_fwd_dissect_plain(ws, heads, dirs, per_ray, stage,
                                         noise, rows, ide_level)
    like = dict(dtype=F32, device=heads.device)
    rgb, normal = torch.empty((n, 3), **like), torch.empty((n, 3), **like)
    density = torch.empty(n, **like)
    if n > 0:
        mat, sigma = _ide_operands(ide_level, heads.device)
        dims = (ctypes.c_int * 6)(nb, h, o, l_max, n_ch, 0)
        launch("ref_dir_fwd_dissect", cd, heads.device, index,
               heads.data_ptr(), None if noise is None else noise.data_ptr(),
               dirs.data_ptr(), per_ray,
               None if rows is None else rows.data_ptr(), mat.data_ptr(),
               sigma.data_ptr(), pointers(ws), n, dims, rgb.data_ptr(),
               normal.data_ptr(), density.data_ptr())
    return rgb, normal, density


def ref_dir_bwd_dissect(ws, heads: torch.Tensor, dirs: torch.Tensor,
                        per_ray: int, noise, g_rgb: torch.Tensor,
                        g_normal: torch.Tensor, g_density: torch.Tensor,
                        mode: str, ide_level: int = 4, tile: int = TILE,
                        device=None):
    """``ref_dir_bwd_recompute`` (sRGB off) in mode ``mode``: (d(heads) (N,
    11 + NB), the 19 grads), f32, zero where the mode computes nothing.  On
    the CPU this is ``ref_dir_bwd_dissect_plain``."""
    dev = resolve_device(device)
    index = _mode_index(mode)
    check_dir_bwd_operands(ws, heads, dirs, per_ray, noise, g_rgb, g_normal,
                           g_density, ide_level, dev)
    if dev.type == "cpu":
        return ref_dir_bwd_dissect_plain(ws, heads, dirs, per_ray, noise,
                                         g_rgb, g_normal, g_density, mode,
                                         ide_level, tile)
    return launch_dir_bwd_recompute(
        "ref_dir_bwd_dissect", (index,), ws, heads, dirs, per_ray, noise,
        g_rgb, g_normal, g_density, ide_level, False, tile)

