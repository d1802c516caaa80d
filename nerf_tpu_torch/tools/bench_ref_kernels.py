"""Time the fused Ref-NeRF kernels alone on the card (port of
tools/bench_ref_kernels.py).

    python -m nerf_tpu_torch.tools.bench_ref_kernels [--n 197632]
        [--dtype bf16|f32] [--spatial] [--no_dir] [--dissect] [--dissect_fwd]

By default it times the directional kernels, with ``--spatial`` also the
spatial ones, each forward and forward+backward in the residual form
(``RefSpatialMLP``, ``RefDirectionalMLP``) and the recompute form
(``RefSpatialMLPRecompute``, ``RefDirectionalMLPRecompute``).  With
``--dissect_fwd`` and ``--dissect`` it times instead the directional
kernels taken apart (``ops.ref_dissect``): the forward's five cumulative
stages (trunk, reflect, vander, polar, full) and the recompute backward's
four modes (recompute, dheads, wgrads, full), so that the difference of two
stages or modes is the time of the glue between them.

The inputs are seeded: RefNeRF's flax initialization at width 256 (IDE
level 4, bottleneck 128) in the compute dtype, heads N(0, 1), bottleneck
noise N(0, 0.02^2), one camera-like ray direction per point (|d| from 1 to
1.12), the dissection's input rows N(0, 0.1^2) and cotangents N(0, 1e-6).
Each time is the median of 20 CUDA-event timings after a warm-up, in ms.

The JAX tool's TPU layout and tiling A/Bs (``--tiles``, ``--spa_bwd_tile``,
the T-major glue and ``ide_vjp="auto"`` variants, ``--ab_bwd_cd``) have no
counterpart here and raise; its ``--ab_store`` A/B is this tool's default,
which times both backward forms.  Its ``bwd_cd=False`` rule is reachable
only through that A/B, not from ``PipelineConfig``.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from nerf_tpu_torch import ops
from nerf_tpu_torch.core.encoding import cat_pos_pe, ide_tables
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.ops.ref_dissect import BWD_MODES
from nerf_tpu_torch.ops.ref_fused import DIR_STAGES, TILE
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models

N_DEFAULT = 1024 * 193
N_ITERS = 20
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
JAX_ONLY_FLAGS = {
    "tiles": "the Pallas grid tile of the TPU kernels",
    "spa_bwd_tile": "the Pallas tile of the TPU spatial backward",
    "ab_bwd_cd": "the TPU kernels' jax.vjp cotangent-dtype rule",
    "ab_store": "the residual against the recompute backward, which this "
                "tool times side by side by default",
}


def time_ms(fn, reps: int = N_ITERS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(n: int = N_DEFAULT, dtype=torch.bfloat16, seed: int = 0,
              device=None) -> dict:
    """The seeded operands of the timings (module docstring) for ``n``
    points: the f32 parameters and kernel weights of both nets, enc and pos
    of the spatial net, heads, noise, dirs (one per point), rows and the
    directional cotangents."""
    dev = resolve_device(device)
    cfg = PipelineConfig(model="ref", nerf_width=256, prop_width=256,
                         use_bf16=dtype == torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    nerf, _ = make_models(cfg, dev, gen)
    spa_params, dir_params = (tuple(p.detach() for p in ps)
                              for ps in nerf.kernel_params())
    spa_ws, dir_ws = nerf.kernel_weights()
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    pos = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = randn(n, 3)
    scale = 1.0 + 0.12 * torch.rand((n, 1), generator=g, device=dev)
    n_ch = ide_tables(nerf.ide_level)["n_ch"]
    return dict(
        n=n, dtype=dtype, ide_level=nerf.ide_level, spa_params=spa_params,
        dir_params=dir_params, spa_ws=spa_ws, dir_ws=dir_ws, pos=pos,
        enc=cat_pos_pe(pos, nerf.pos_levels, dtype),
        heads=randn(n, 11 + nerf.bottleneck_dim),
        noise=randn(n, nerf.bottleneck_dim, scale=0.02).to(dtype),
        dirs=d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) * scale,
        rows=randn(2 * n_ch + 1, n, scale=0.1),
        g_rgb=randn(n, 3, scale=1e-3), g_normal=randn(n, 3, scale=1e-3),
        g_density=randn(n, scale=1e-3))


def dissect_fwd_call(case: dict, stage: str):
    """The call that ``dissect_fwd`` times for ``stage``."""
    return lambda: ops.ref_dir_fwd_dissect(
        case["dir_ws"], case["heads"], case["dirs"], 1, stage, case["noise"],
        case["rows"], case["ide_level"], device=case["heads"].device.type)


def dissect_bwd_call(case: dict, mode: str):
    """The call that ``dissect_bwd`` times for ``mode``."""
    return lambda: ops.ref_dir_bwd_dissect(
        case["dir_ws"], case["heads"], case["dirs"], 1, case["noise"],
        case["g_rgb"], case["g_normal"], case["g_density"], mode,
        case["ide_level"], TILE, device=case["heads"].device.type)


def dissect_fwd(case: dict) -> dict:
    """ms of each stage of the directional forward."""
    return {s: time_ms(dissect_fwd_call(case, s)) for s in DIR_STAGES}


def dissect_bwd(case: dict) -> dict:
    """ms of each mode of the recompute-form directional backward."""
    return {m: time_ms(dissect_bwd_call(case, m)) for m in BWD_MODES}


def _fwd_bwd(fn, outs_of, cotangents, params):
    """forward then backward through an autograd Function: ``fn()`` runs
    the forward, ``outs_of`` picks its differentiable outputs."""
    def run():
        outs = outs_of(fn())
        torch.autograd.backward(outs, cotangents(outs))
        for p in params:
            p.grad = None
    return run


def shipped(case: dict, spatial: bool, directional: bool) -> dict:
    """ms of the shipped kernels' forward and forward+backward, in the
    residual and the recompute form, through their autograd Functions."""
    dev_arg = case["heads"].device.type
    out = {}
    for form, (spa_fn, dir_fn) in {
            "res": (ops.RefSpatialMLP, ops.RefDirectionalMLP),
            "recompute": (ops.RefSpatialMLPRecompute,
                          ops.RefDirectionalMLPRecompute)}.items():
        if spatial:
            params = [p.clone().requires_grad_() for p in case["spa_params"]]

            def spa(params=params, spa_fn=spa_fn):
                return spa_fn.apply(dev_arg, TILE, case["enc"], case["pos"],
                                    *params)

            with torch.no_grad():
                out[f"spa fwd ({form})"] = time_ms(spa)
            out[f"spa fwd+bwd ({form})"] = time_ms(_fwd_bwd(
                spa, lambda o: o[0], lambda o: 1e-3 * torch.ones_like(o),
                params))
        if directional:
            params = [p.clone().requires_grad_() for p in case["dir_params"]]
            heads = case["heads"].clone().requires_grad_()

            def dr(params=params, dir_fn=dir_fn):
                return dir_fn.apply(dev_arg, TILE, heads, case["dirs"],
                                    case["noise"], 1, case["ide_level"],
                                    False, case["dtype"], *params)

            with torch.no_grad():
                out[f"dir fwd ({form})"] = time_ms(dr)
            gs = (case["g_rgb"], case["g_normal"], case["g_density"])
            out[f"dir fwd+bwd ({form})"] = time_ms(_fwd_bwd(
                dr, lambda o: o, lambda o: gs, params + [heads]))
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m nerf_tpu_torch.tools.bench_ref_kernels",
        description="time the fused Ref-NeRF kernels alone, or the "
                    "directional kernels stage by stage")
    ap.add_argument("--n", type=int, default=N_DEFAULT)
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    ap.add_argument("--spatial", action="store_true",
                    help="also time the spatial kernels")
    ap.add_argument("--no_dir", action="store_true",
                    help="skip the directional kernels")
    ap.add_argument("--dissect", action="store_true",
                    help="time the directional backward mode by mode")
    ap.add_argument("--dissect_fwd", action="store_true",
                    help="time the directional forward stage by stage")
    for flag, what in JAX_ONLY_FLAGS.items():
        ap.add_argument(f"--{flag}", nargs="*", default=None,
                        help=f"JAX package only ({what}); raises here")
    return ap


def main(argv=None, device=None) -> dict:
    """Run the timings; returns {"fwd_stages": {stage: ms}, "bwd_modes":
    {mode: ms}} with the dissections, else {name: ms}."""
    args = get_parser().parse_args(argv)
    for flag, what in JAX_ONLY_FLAGS.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag} A/Bs {what}: a TPU layout or tiling choice of the "
                f"JAX package with no counterpart in nerf_tpu_torch")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_ref_kernels times the CUDA kernels and "
                           "needs a card")
    case = make_case(args.n, DTYPES[args.dtype], device=dev)
    print(f"device: {torch.cuda.get_device_name(dev)}  n={args.n} "
          f"dtype={args.dtype}", file=sys.stderr)
    if args.dissect or args.dissect_fwd:
        res = {}
        if args.dissect_fwd:
            res["fwd_stages"] = dissect_fwd(case)
        if args.dissect:
            res["bwd_modes"] = dissect_bwd(case)
        for kind, times in res.items():
            for name, ms in times.items():
                print(f"dir {kind[:3]} dissect[{name}]  {ms:8.3f} ms",
                      file=sys.stderr)
        return res
    res = shipped(case, args.spatial, not args.no_dir)
    for name, ms in res.items():
        print(f"{name:<28s} {ms:8.3f} ms", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
