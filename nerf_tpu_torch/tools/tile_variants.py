"""The forward layer tile's design alternatives, measured on the card.

    python -m nerf_tpu_torch.tools.tile_variants [--variants shipped chain ...]

Each variant is the shipped tile (``ops/csrc/mlp_tile.cuh``'s dense_tile)
with one change, made to a copy of the package under
``build/tile_variants/<variant>/``:

    shipped  the tile as it is
    chain    the k-steps summed through the tensor cores' accumulator,
             without the f32 add of each k-step's product
    divide   the weight stage's pieces found by a division each k-step
    ring3    three ring slots instead of two
    slot32   slots of two k-steps (one barrier per 32 rows of W)
    full     a second, unpredicated copy of the k-step for passes whose
             warps hold all 16 n-tiles
    pad      activation rows padded by 16 bytes, so that an ldmatrix of
             the A operand meets no bank conflict (the tile's own entry
             only: the fused kernels' other readers are not changed)

The copies build their libraries (``dense``, and ``ref_fused`` for the
variants that keep the fused kernels right) in parallel; then, one variant
at a time, a process run from the copy reports ptxas's registers and
spills of the patched bf16 kernels, the tile alone's ms (``ops.dense_layer``,
median of 20 CUDA-event timings) at four layer shapes of an eval chunk
(786,432 rows: 256 -> 256, 63 -> 256, 167 + 256 -> 256, 256 -> 128), the
ms of ``ref_spa_fwd`` and ``ref_dir_fwd`` at one chunk
(``bench_ref_kernels``' seeded operands), and the share of a 256 -> 256
layer's bf16 outputs (131,072 rows) that differ from the layer summed in
f64 and then rounded, beside the plain version's share.  One JSON line per
variant.  Card only: the variants are compiled by nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
WORK = PACKAGE.parent / "build" / "tile_variants"
TILE, ENTRY = "ops/csrc/mlp_tile.cuh", "ops/csrc/dense.cu"

_KSTEP = ("    kstep_mma(acc, af, stage + (s % DSTAGES) * DSLOT + boff, "
          "pc.nt_n);")
# variant -> (whether the fused kernels stay right, [(file, old, new)])
VARIANTS = {
    "shipped": (True, []),
    "chain": (True, [(TILE, """  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(part, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];""", "  mma_bf16(acc, a, b);")]),
    "divide": (True, [(TILE, """  for (int r = m.r0; r < DK; r += m.rstep) {
    bf16_t* d = slot + r * DLD + m.c;
    const int k = kb + r;
    const bf16_t* src = w + (size_t)k * n_out + c0 + m.c;""", """  const int pieces = THREADS / m.rstep;
  for (int idx = threadIdx.x; idx < DK * pieces; idx += THREADS) {
    const int r = idx / pieces, cc = (idx - r * pieces) * 8;
    bf16_t* d = slot + r * DLD + cc;
    const int k = kb + r;
    const bf16_t* src = w + (size_t)k * n_out + c0 + cc;""")]),
    "ring3": (True, [(TILE, "constexpr int DSTAGES = 2;",
                      "constexpr int DSTAGES = 3;")]),
    "slot32": (True, [
        (TILE, "constexpr int DK = 16; ", "constexpr int DK = 32; "),
        (TILE, "    uint32_t af[4];\n    load_a(af, a, k_dim, m0, kb, al);\n"
         + _KSTEP, """    for (int ks = 0; ks < DK; ks += 16) {
      if (kb + ks >= k_dim) break;
      uint32_t af[4];
      load_a(af, a, k_dim, m0, kb + ks, al);
      kstep_mma(acc, af, stage + (s % DSTAGES) * DSLOT + ks * DLD + boff,
                pc.nt_n);
    }""")]),
    "full": (True, [
        (TILE, "__device__ __forceinline__ void kstep_mma(",
         "template <bool FULL>\n__device__ __forceinline__ void kstep_mma("),
        (TILE, "    if (2 * p < nt_n) {", "    if (FULL || 2 * p < nt_n) {"),
        (TILE, "      if (2 * p + 1 < nt_n) step_mma",
         "      if (FULL || 2 * p + 1 < nt_n) step_mma"),
        (TILE, _KSTEP, """    if (pc.nt_n == 16)
      kstep_mma<true>(acc, af, stage + (s % DSTAGES) * DSLOT + boff, 16);
    else
      kstep_mma<false>(acc, af, stage + (s % DSTAGES) * DSLOT + boff,
                       pc.nt_n);""")]),
    "pad": (False, [
        (TILE, "template <typename T>\ninline bool tile_widths_ok(",
         "__host__ __device__ constexpr int pld(int w) {\n"
         "  return w % 8 == 0 ? w + 8 : w;\n}\n\n"
         "template <typename T>\ninline bool tile_widths_ok("),
        (TILE, "a + (m0 + (lane & 15)) * k_dim + kk",
         "a + (m0 + (lane & 15)) * pld(k_dim) + kk"),
        (TILE, "const bf16_t* ra = a + (m0 + g) * k_dim;",
         "const bf16_t* ra = a + (m0 + g) * pld(k_dim);"),
        (TILE, "const bf16_t* rb = ra + 8 * k_dim;",
         "const bf16_t* rb = ra + 8 * pld(k_dim);"),
        (TILE, "out + (m0 + g + 8 * h) * n_out + c)",
         "out + (m0 + g + 8 * h) * pld(n_out) + c)"),
        (TILE, "const bf16_t* src = out + (m0 + rr) * n_out + c;",
         "const bf16_t* src = out + (m0 + rr) * pld(n_out) + c;"),
        (TILE, "to_f(out[r * n_out + c]) > 0.f",
         "to_f(out[r * pld(n_out) + c]) > 0.f"),
        (TILE, "  int done = 0;\n", """  int done = 0;
  if (width % 8 == 0) {                 // padded rows, 16 bytes a piece
    const int pieces = width / 8;
    for (int j = threadIdx.x; j < TM * pieces; j += THREADS) {
      const int r = j / pieces, c = (j - r * pieces) * 8;
      if (r < valid)
        cp_async16(dst + r * pld(width) + c, base + r * width + c);
      else
        *reinterpret_cast<uint4*>(dst + r * pld(width) + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }
"""),
        (ENTRY, "  T* xs1 = xs0 + TM * k0;\n  T* ys = xs1 + TM * k1;\n"
         "  uint32_t* mb = reinterpret_cast<uint32_t*>(ys + TM * n_out);",
         "  T* xs1 = xs0 + TM * pld(k0);\n  T* ys = xs1 + TM * pld(k1);\n"
         "  uint32_t* mb = reinterpret_cast<uint32_t*>(ys + TM * pld(n_out));"),
        (ENTRY, """  for (int j = threadIdx.x; j < count / PER; j += THREADS)
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(ys)[j];
  for (int idx = count / PER * PER + threadIdx.x; idx < count; idx += THREADS)
    dst[idx] = ys[idx];""", """  for (int j = threadIdx.x; j < count / PER; j += THREADS) {
    const int r = j / (n_out / PER), c = (j - r * (n_out / PER)) * PER;
    reinterpret_cast<uint4*>(dst)[j] =
        *reinterpret_cast<const uint4*>(ys + r * pld(n_out) + c);
  }"""),
        (ENTRY, "(size_t)TM * (k0 + k1 + n_out) * sizeof(T)",
         "(size_t)TM * (pld(k0) + pld(k1) + pld(n_out)) * sizeof(T)")]),
}
DENSE_SHAPES = (((256,), 256), ((63,), 256), ((167, 256), 256),
                ((256,), 128))
ROWS = 786_432            # one eval chunk of Ref-NeRF's merged points
ROUNDING_ROWS = 131_072
TILE_KERNELS = ("dense_layer_kernel", "ref_spa_fwd_kernel",
                "ref_dir_fwd_kernel")


def patched_sources(name: str, root: Path) -> None:
    """Apply variant ``name``'s changes to the package copy at ``root``;
    raise if a change no longer finds its text exactly once."""
    for rel, old, new in VARIANTS[name][1]:
        path = root / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {rel} holds its text "
                             f"{text.count(old)} times, not once")
        path.write_text(text.replace(old, new))


def libraries(name: str) -> tuple:
    return ("dense", "ref_fused") if VARIANTS[name][0] else ("dense",)


def prepare(name: str) -> Path:
    """A fresh copy of the package with variant ``name``'s changes; returns
    the directory to run it from."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / "nerf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patched_sources(name, root / "nerf_tpu_torch")
    return root


def ptxas_summary(reports: dict) -> dict:
    """Registers and spills of each bf16 entry function of TILE_KERNELS in
    ptxas's reports, by mangled name."""
    out, func = {}, None
    for log in reports.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                func = m.group(1)
                continue
            if not func or "__nv_bfloat16" not in func or not any(
                    k in func for k in TILE_KERNELS):
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                out.setdefault(func, {})["spill_bytes"] = [
                    int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out.setdefault(func, {})["registers"] = int(m.group(1))
    return out


def report_path(name: str) -> Path:
    """Where a copy keeps its build's ptxas report (beside its package)."""
    return PACKAGE.parent / f"{name}.ptxas.json"


def build_variant(name: str) -> None:
    """Run from the copy: build its libraries, keep ptxas's report."""
    from nerf_tpu_torch.ops import build
    reports = build.build(libraries(name))
    report_path(name).write_text(json.dumps(reports))


def measure(name: str) -> dict:
    """Run from the copy: the readings of the module docstring."""
    import torch

    from nerf_tpu_torch import ops
    from nerf_tpu_torch.tools.bench_ref_kernels import make_case, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(n, ks, n_out):
        acts = [(torch.rand((n, k), generator=gen, device="cuda") * 2 - 1)
                .to(bf16) for k in ks]
        ws = [(torch.randn((k, n_out), generator=gen, device="cuda")
               * (2.0 / sum(ks)) ** 0.5).to(bf16) for k in ks]
        return acts, ws, torch.randn(n_out, generator=gen,
                                     device="cuda") * 0.5

    def layer(fn, acts, ws, b):
        return fn(acts[0], ws[0], b, *(acts[1:] + ws[1:]))[0]

    out = {"variant": name, "device": torch.cuda.get_device_name(0),
           "ptxas": ptxas_summary(json.loads(
               report_path(name).read_text())),
           "dense_ms": {}}
    for ks, n_out in DENSE_SHAPES:
        acts, ws, b = operands(ROWS, ks, n_out)
        got = layer(ops.dense_layer, acts, ws, b)
        want = layer(ops.dense_layer_plain, acts, ws, b)
        err = float((got.float() - want.float()).abs().max())
        key = f"{'+'.join(map(str, ks))}->{n_out}"
        out["dense_ms"][key] = dict(
            ms=time_ms(lambda: layer(ops.dense_layer, acts, ws, b)),
            max_abs_err=err)
        del acts, ws, got, want
        torch.cuda.empty_cache()
    acts, ws, b = operands(ROUNDING_ROWS, (256,), 256)
    exact = torch.relu(acts[0].double() @ ws[0].double() + b.double())
    rounded = exact.float().to(bf16)
    out["rounding_share"] = {
        "kernel": float((layer(ops.dense_layer, acts, ws, b) != rounded)
                        .float().mean()),
        "plain": float((layer(ops.dense_layer_plain, acts, ws, b)
                        != rounded).float().mean())}
    if VARIANTS[name][0]:
        case = make_case(ROWS)
        out["ref_spa_fwd_ms"] = time_ms(
            lambda: ops.ref_spa_fwd(case["spa_ws"], case["enc"]))
        out["ref_dir_fwd_ms"] = time_ms(
            lambda: ops.ref_dir_fwd(case["dir_ws"], case["heads"],
                                    case["dirs"], 1, None,
                                    case["ide_level"]))
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--build", help=argparse.SUPPRESS)
    p.add_argument("--measure", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.build:
        build_variant(args.build)
        return []
    if args.measure:
        res = measure(args.measure)
        print(json.dumps(res), flush=True)
        return [res]
    roots = {v: prepare(v) for v in args.variants}

    def run(v, flag, **kw):
        return subprocess.Popen(
            [sys.executable, "-m", "nerf_tpu_torch.tools.tile_variants",
             flag, v], cwd=roots[v], env=dict(os.environ), **kw)

    builds = {v: run(v, "--build") for v in args.variants}
    failed = [v for v, proc in builds.items() if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"the build of {failed} failed")
    results = []
    for v in args.variants:
        proc = run(v, "--measure", stdout=subprocess.PIPE, text=True)
        stdout = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"measuring {v} failed")
        results.append(json.loads(stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
