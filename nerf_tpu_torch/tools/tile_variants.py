"""The layer tile's and the delta pass's design alternatives, measured on
the card.

    python -m nerf_tpu_torch.tools.tile_variants [--variants shipped chain ...]

Each variant is the shipped code with one change, made to a copy of the
package (and of ``chip_smoke.py`` and ``loop_ab.py``, whose checks it
reads) under ``build/tile_variants/<variant>/``.  The forward layer tile
(``ops/csrc/mlp_tile.cuh``'s dense_tile: wgmma m64n32k16 from a TMA-fed
ring of weight slots, each k-step summed from zero by the tensor cores and
then added to an f32 sum):

    shipped  the code as it is
    chain    every k-step of a pass summed through the tensor cores'
             accumulator, with no f32 add (the fault that the rounding
             gate must catch)
    g2, g4   groups of 2 and 4 k-steps chained in the tensor cores before
             each f32 add (mma_pass's k-loop replaced by a grouped one; g4
             with a ring of 5 slots: a group needs one slot more than its
             k-steps, and a ring of fewer slots keeps groups of
             STAGES - 1)
    ring2,   a ring of 2 and 4 slots instead of DSTAGES (the forwards';
    ring4    the Ref-NeRF rebuilds keep RSTAGES; 4 slots cost the largest
             forwards their second block an SM)
    pad      activation rows padded by 16 bytes, so that an ldmatrix of
             the A operand meets no bank conflict (the tile's own entry
             only: the fused kernels' other readers are not changed)

The backwards' delta pass (delta_tile: each k-step's product summed from
zero by the tensor cores and added to an f32 sum in the order of k):

    dchain   every k-step of a pass summed through the tensor cores'
             accumulator, with no f32 add, in the trunk passes (wgmma)
             and the heads (mma.sync): the fault that the delta phase's
             rounding gate must catch (the backwards' order limit,
             BWD_ORDER_FACTOR, let it pass on the Ref-NeRF backwards)
    dring3   a delta ring of 3 slots instead of TSTAGES' 2 (the Ref-NeRF
             recompute backwards' stage grows by a slot)
    dlate    the delta ring's slot refilled after the k-step's products
             (as the layer tile's mma_pass does) instead of before them

The backwards' weight-grad pass (``ops/csrc/wgrad.cuh``'s
wgrad_mma_kernel: wgmma with both operands from a TMA-fed ring, each
k-step summed from zero by the tensor cores and added to an f32 sum):

    wgrad    the pass as shipped, its readings alone
    wchain   every k-step of a split summed through the tensor cores'
             accumulator, with no f32 add: the fault that the wgrad
             phase's rounding gate must catch (the mma.sync body that the
             pass replaced did this)
    wg2      groups of 2 k-steps chained in the tensor cores before each
             f32 add
    wn128    one wgmma of 128 columns a k-step in place of two of 64 (the
             A operand read from shared memory once)
    wring2   a ring of 2 slots instead of WSTAGES

The bf16 spatial and directional forwards' persistent frame
(``ops/csrc/spa_frame.cuh``, ``ops/csrc/dir_frame.cuh``: 128-point tiles,
two consumer warpgroups, a producer that streams every layer's weights
through one ring that is never drained):

    frame    the frame as shipped, its readings alone
    fstatic  the consumer count (and so the tile height) a compile-time
             constant, one instantiation of each form for each count, in
             place of the count read from the layout at launch
    slayer   the ring drained at every layer, as the 64-row frame drained
             its own: the producer starts a layer's loads only once every
             slot filled so far is released
    stm64    one consumer warpgroup and tiles of 64 points at every width
             (each weight box feeds 64 rows, as in the 64-row frame; 256
             threads, no setmaxnreg: the frame's own choice where two
             activation buffers of 128 rows do not fit)
    n32      ref_spa_fwd's products 32 columns a wgmma, as in the training
             forms, instead of 64
    fnoheads the narrow heads skipped, and
    fnoepi   every epilogue skipped (the products' f32 sums then dead):
             what the rest costs (their outputs are wrong by design)

each with ptxas's registers and spills of the frame, the ms of
``ref_spa_fwd`` and ``ref_dir_fwd`` (786,432 points), ``ref_spa_fwd_res``,
``ref_spa_fwd_grad`` and ``ref_dir_fwd_res`` (196,608;
``chip_smoke.kernel_case``'s operands), the sha1 of each one's outputs
(equal digests, equal bits) and the frame's identities at 129 and 50,689
points (``chip_smoke.frame_identities``, ``dir_frame_identities``), which
every variant but fnoheads and fnoepi keeps: they change no sum.
``--variants frame slayer stm64`` builds ``ref_fused``, ``ref_dissect``
and ``dense`` alone.

The copies build their libraries (``dense``, ``ref_fused`` for the
variants that keep the fused kernels right, ``wgrad`` alone for the
weight-grad variants, and for ``shipped`` and the delta variants every
library but the dissection's) in parallel; then, one
variant at a time (each variant's build seconds printed beside its
readings), a process run from the copy reports ptxas's registers
and spills of the patched bf16 kernels, the tile alone's ms
(``ops.dense_layer``, median of 20 CUDA-event timings) at four layer shapes
of an eval chunk (786,432 rows: 256 -> 256, 63 -> 256, 167 + 256 -> 256,
256 -> 128), the ms of ``ref_spa_fwd`` and ``ref_dir_fwd`` at one chunk
(``bench_ref_kernels``' seeded operands), and the rounding gate's reading
at its two shapes (256 -> 256 and 167 + 256 -> 256, 131,072 rows): the
share of the tile's bf16 outputs that differ from the layer summed in f64
and then rounded, beside the share of the f32 sum in the order of k
(``ops.dense.dense_layer_in_order``) and of the plain version, and the
ratio that the gate holds at 1.0.  ``shipped`` and the delta variants also
report the delta pass alone's ms (``ops.delta_layer`` 256 -> 256 masked at
a Ref-NeRF step's 196,608 rows), the ms of each fused kernel that runs it
(``DELTA_KERNELS``, bf16, ``chip_smoke.kernel_case``'s operands), the
delta phase's rounding gate
(``chip_smoke.delta_gate_readings``: 256 -> 256 and 256 -> 167, the
ratio held at 1.0) and every bf16 backward's distance from its plain
chain with f64 delta sums over the plain f32 chain's
(``chip_smoke.order_readings`` over ``ORDER_SEEDS``: the ratio that
``BWD_ORDER_FACTOR`` holds at 1.25).  The weight-grad variants report
instead ptxas's registers and spills of wgrad_mma_kernel, the wgrad
phase's rounding gate (``chip_smoke.wgrad_gate_readings``: the 256 x 256
and 63 x 256 jobs, the ratio held at 1.0) and the pass's ms
(``chip_smoke.cuda_device_ms``) at each job list of
``chip_smoke.wgrad_lists`` beside ``torch.mm``'s.  One JSON line per
variant (a variant that fails or runs over MEASURE_TIMEOUT reads as its
error).
Card only: the variants are compiled by nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
WORK = PACKAGE.parent / "build" / "tile_variants"
ROOT = PACKAGE.parent
TILE, ENTRY = "ops/csrc/mlp_tile.cuh", "ops/csrc/dense.cu"
WGRAD = "ops/csrc/wgrad.cuh"
FRAME = "ops/csrc/spa_frame.cuh"
DIR_FRAME = "ops/csrc/dir_frame.cuh"

# mma_pass's k-loop as shipped: one k-step a partial
LOOP = """  for (int k = 0; k < R.per; ++k) {
    const int g = g0 + k;
    const bool on1 = k >= R.s0;
    uint32_t af[4];
    load_a(af, on1 ? a1 : a0, on1 ? k1 : k0, m0,
           (on1 ? k - R.s0 : k) * DK, on1 ? al1 : al0);
    mbar_wait(R.full_bar(g), (g / STAGES) & 1);
#pragma unroll
    for (int sub = 0; sub < PASS / 64; ++sub) {
      if (sub < nsub) {
        wgmma_fence();
        wgmma_m64n32k16(part, af,
                        wgmma_desc_sw128(R.slot(g) + boff
                                         + (sub >> 1) * DK * DATOM * 2
                                         + (sub & 1) * DATOM,
                                         DK * DATOM * 2, 8 * DATOM * 2),
                        0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
        wgmma_hold(af);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * sub + t][e] += part[t][e];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty_bar(g));
    if (threadIdx.x == 0 && g >= 1) {
      const RingLoader L = *loader_of(R);
      if (g - 1 + STAGES < L.total) {
        mbar_wait(R.empty_bar(g - 1), ((g - 1) / STAGES) & 1);
        ring_load(R, L, g - 1 + STAGES);
      }
    }
  }
"""


def grouped_loop(group: int) -> str:
    """mma_pass's k-loop with groups of ``group`` k-steps (at most STAGES -
    1) chained in the tensor cores (scale-d 0 on a group's first) before
    each f32 add; a short last group multiplies zero A fragments by its
    last k-step's slot."""
    return """  constexpr int G = %d < STAGES - 1 ? %d : STAGES - 1;
  for (int k = 0; k < R.per; k += G) {
    const int n = R.per - k < G ? R.per - k : G;   // k-steps in the group
    uint32_t af[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < n) {
        const bool on1 = k + j >= R.s0;
        load_a(af[j], on1 ? a1 : a0, on1 ? k1 : k0, m0,
               (on1 ? k + j - R.s0 : k + j) * DK, on1 ? al1 : al0);
        const int g = g0 + k + j;
        mbar_wait(R.full_bar(g), (g / STAGES) & 1);
      } else {
        af[j][0] = af[j][1] = af[j][2] = af[j][3] = 0u;
      }
    }
#pragma unroll
    for (int sub = 0; sub < PASS / 64; ++sub) {
      if (sub < nsub) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int g = g0 + k + (j < n ? j : n - 1);
          wgmma_m64n32k16(part, af[j],
                          wgmma_desc_sw128(R.slot(g) + boff
                                           + (sub >> 1) * DK * DATOM * 2
                                           + (sub & 1) * DATOM,
                                           DK * DATOM * 2, 8 * DATOM * 2),
                          j > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
#pragma unroll
        for (int j = 0; j < G; ++j) wgmma_hold(af[j]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * sub + t][e] += part[t][e];
      }
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const int g = g0 + k + j;
      if (lane == 0) mbar_arrive(R.empty_bar(g));
      if (threadIdx.x == 0 && g >= 1) {
        const RingLoader L = *loader_of(R);
        if (g - 1 + STAGES < L.total) {
          mbar_wait(R.empty_bar(g - 1), ((g - 1) / STAGES) & 1);
          ring_load(R, L, g - 1 + STAGES);
        }
      }
    }
  }
""" % (group, group)


# variant -> (whether the fused kernels stay right, [(file, old, new)])
VARIANTS = {
    "shipped": (True, []),
    "chain": (True, [
        (TILE, "        wgmma_m64n32k16(part, af,",
         "        wgmma_m64n32k16("
         "*reinterpret_cast<float(*)[4][4]>(acc[4 * sub]), af,"),
        (TILE, "DK * DATOM * 2, 8 * DATOM * 2),\n                        0);",
         "DK * DATOM * 2, 8 * DATOM * 2),\n                        1);"),
        (TILE, "acc[4 * sub + t][e] += part[t][e];", "(void)part[t][e];")]),
    "g2": (True, [(TILE, LOOP, grouped_loop(2))]),
    "g4": (True, [(TILE, LOOP, grouped_loop(4)),
                  (TILE, "constexpr int DSTAGES = 3;",
                   "constexpr int DSTAGES = 5;")]),
    "ring2": (True, [(TILE, "constexpr int DSTAGES = 3;",
                      "constexpr int DSTAGES = 2;")]),
    "ring4": (True, [(TILE, "constexpr int DSTAGES = 3;",
                      "constexpr int DSTAGES = 4;")]),
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
# the delta variants: dchain chains the tensor-core sums of the pass's
# k-steps, on wgmma (the trunk passes, ring_pass_t) and on mma.sync (the
# heads, step_mma)
VARIANTS["dchain"] = (True, [
    (TILE, "        wgmma_m64n32k16<0>(part, af,",
     "        wgmma_m64n32k16<0>("
     "*reinterpret_cast<float(*)[4][4]>(acc[4 * blk]), af,"),
    (TILE, "8 * TK * 2),\n                           0);",
     "8 * TK * 2),\n                           1);"),
    (TILE, "acc[4 * blk + t][e] += part[t][e];", "(void)part[t][e];"),
    (TILE, """  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(part, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];""", "  mma_bf16(acc, a, b);")])
# dring3: the delta pass's ring of 3 slots instead of TSTAGES (the Ref-NeRF
# recompute backwards' stage grows with it)
VARIANTS["dring3"] = (True, [(TILE, "constexpr int TSTAGES = 2;",
                              "constexpr int TSTAGES = 3;")])
# dlate: ring_pass_t's thread 0 refills a slot after its products of the
# k-step, as the layer tile's mma_pass does, instead of before them
DREFILL = """    if (threadIdx.x == 0 && g >= 1) {
      const RingLoader L = *loader_of(R);
      if (g - 1 + STAGES < L.total) {
        mbar_wait(R.empty_bar(g - 1), ((g - 1) / STAGES) & 1);
        tring_load(R, L, g - 1 + STAGES);
      }
    }
"""
VARIANTS["dlate"] = (True, [
    (TILE, DREFILL + "    uint32_t af[4];\n    load_a(af, a, k_dim, m0, k * TK, al);",
     "    uint32_t af[4];\n    load_a(af, a, k_dim, m0, k * TK, al);"),
    (TILE, "    if (lane == 0) mbar_arrive(R.empty_bar(g));\n  }\n}\n\n// The bf16 body of delta_tile",
     "    if (lane == 0) mbar_arrive(R.empty_bar(g));\n" + DREFILL
     + "  }\n}\n\n// The bf16 body of delta_tile")])
# the weight-grad variants: the consumers' k-step as shipped (each half's
# product summed from zero into ``part``, then added), chained (wchain),
# grouped by two (wg2) or one wgmma of 128 columns (wn128)
WPRODUCT = """            wgmma_fence();
            wgmma_ss<1, 1>(part, da,
                           wgmma_desc_sw128(d + ks + h * ATOM_BYTES,
                                            ATOM_BYTES, 8 * WATOM * 2), 0);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_hold(part);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[h][e] += part[e];
"""
WLOOP = """#pragma unroll
      for (int s = 0; s < MR / 16; ++s) {
        const uint32_t ks = s * 16 * WATOM * 2;   // the k-step's 16 rows
        const uint64_t da = wgmma_desc_sw128(a + ks, ATOM_BYTES,
                                             8 * WATOM * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < halves) {
""" + WPRODUCT + """          }
        }
      }
"""
VARIANTS["wgrad"] = (True, [])
VARIANTS["wchain"] = (True, [(WGRAD, WPRODUCT, """\
            wgmma_fence();
            wgmma_ss<1, 1>(acc[h], da,
                           wgmma_desc_sw128(d + ks + h * ATOM_BYTES,
                                            ATOM_BYTES, 8 * WATOM * 2), 1);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_hold(acc[h]);
            (void)part;
""")])
VARIANTS["wg2"] = (True, [(WGRAD, WLOOP, """#pragma unroll
      for (int s = 0; s < MR / 16; s += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < halves) {
            wgmma_fence();
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const uint32_t ks = (s + t) * 16 * WATOM * 2;
              wgmma_ss<1, 1>(part, wgmma_desc_sw128(a + ks, ATOM_BYTES,
                                                    8 * WATOM * 2),
                             wgmma_desc_sw128(d + ks + h * ATOM_BYTES,
                                              ATOM_BYTES, 8 * WATOM * 2), t);
            }
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_hold(part);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[h][e] += part[e];
          }
        }
      }
""")])
VARIANTS["wn128"] = (True, [
    (WGRAD, "  float part[32];\n  for (int c = 0; c < chunks; ++c) {",
     "  float part[64];\n  for (int c = 0; c < chunks; ++c) {"),
    (WGRAD, WLOOP, """#pragma unroll
      for (int s = 0; s < MR / 16; ++s) {
        const uint32_t ks = s * 16 * WATOM * 2;   // the k-step's 16 rows
        wgmma_fence();
        wgmma_ss<1, 1>(part, wgmma_desc_sw128(a + ks, ATOM_BYTES,
                                              8 * WATOM * 2),
                       wgmma_desc_sw128(d + ks, ATOM_BYTES, 8 * WATOM * 2),
                       0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e / 32][e % 32] += part[e];
      }
""")])
VARIANTS["wring2"] = (True, [(WGRAD, "constexpr int WSTAGES = 3;",
                              "constexpr int WSTAGES = 2;")])
WGRAD_VARIANTS = ("wgrad", "wchain", "wg2", "wn128", "wring2")
# the bf16 spatial forwards' persistent frame: as shipped (frame), its ring
# drained at every layer as the 64-row frame drained its own (slayer: the
# producer waits at a layer's start until every slot filled so far is
# released), one consumer warpgroup and 64-row tiles at every width
# (stm64: each weight box feeds 64 rows; the frame's own choice above 256
# wide where two buffers of 128 rows do not fit)
FRAME_DRAIN = """  {   // every slot filled so far released: the ring drained
    const int prev = R.slot == 0 ? R.stages - 1 : R.slot - 1;
    mbar_wait(R.bars + 8 * (R.stages + prev),
              R.slot == 0 ? R.phase ^ 1u : R.phase);
  }
"""
FWD_BEGIN = """  const int s0 = (k0 + DK - 1) / DK, per = s0 + (k1 + DK - 1) / DK;
  for (int c0 = 0; c0 < n_out; c0 += FCOLS) {
    const int np = n_out - c0 < FCOLS ? n_out - c0 : FCOLS;
    const int boxes"""
T_BEGIN = """  const int per = (k_dim + TK - 1) / TK;
  const uint32_t bytes"""
VARIANTS["frame"] = (True, [])
# fstatic: each frame kernel templated on its consumer count, one
# instantiation of each form for each count, the launcher picking the one
# of the layout's count
VARIANTS["fstatic"] = (True, [
    change for path, kernel in ((FRAME, "spa_frame_kernel"),
                                (DIR_FRAME, "dir_frame_kernel"))
    for change in (
        (path, "template <int FORM>\n__global__ void __launch_bounds__(384, "
         f"1)\n{kernel}(", "template <int FORM, int CONS>\n__global__ void "
         f"__launch_bounds__(384, 1)\n{kernel}("),
        (path, "cons = L.cons;\n", "cons = CONS;\n"),
        (path, f"  const auto kernel = {kernel}<FORM>;\n",
         f"  const auto kernel = L.cons == 2 ? {kernel}<FORM, 2>\n"
         f"                                   : {kernel}<FORM, 1>;\n"))])
VARIANTS["slayer"] = (True, [(FRAME, FWD_BEGIN, FRAME_DRAIN + FWD_BEGIN),
                             (FRAME, T_BEGIN, FRAME_DRAIN + T_BEGIN)])
VARIANTS["stm64"] = (True, [(FRAME, "  int cons = 2;   ", "  int cons = 1;   ")])
# n32: ref_spa_fwd's products 32 columns a wgmma instead of FWG_EVAL's 64
# (the sums stay the shipped frame's: the tensor cores' sum of a column
# does not depend on the product's width, which the identities read)
VARIANTS["n32"] = (True, [(FRAME, "constexpr int FWG_EVAL = 64;",
                           "constexpr int FWG_EVAL = 32;")])
# what paces the frame, read by taking a part out (their outputs are not
# right, and the identities say so): fnoheads skips the narrow heads,
# fnoepi every epilogue (the products' sums are then dead and dropped, so
# it reads the products' issue and wgmma round trips alone)
VARIANTS["fnoheads"] = (True, [(FRAME, (
    "    spa_frame_narrow(cur, lda, o, HeadW{cb, C.whead, p.wrt, p.wnct},\n"
    "                     cb + C.heads_b, heads, HEAD_FIXED + nb, r0, n);\n"),
    "")])
VARIANTS["fnoepi"] = (True, [
    (FRAME, "      if (t >= nt) break;\n" + after,
     "      if (t >= 0) break;\n" + after)
    for after in ("      uint32_t u[4];",
                  "      const int c = c0 + 8 * t + 2 * q;\n      const float2",
                  "      if ((t & 3) == 0) {",
                  "      const int c = c0 + 8 * t + 2 * q;\n#pragma unroll")])
FRAME_VARIANTS = ("frame", "fstatic", "slayer", "stm64", "n32", "fnoheads",
                  "fnoepi")
# the kernels that run the frame, timed at their main-path shapes
FRAME_TIMED = ("ref_spa_fwd", "ref_spa_fwd_res", "ref_spa_fwd_grad",
               "ref_dir_fwd", "ref_dir_fwd_res")
# the variants that report the delta pass's readings, and build every
# library of the backwards
DELTA_VARIANTS = ("shipped", "dchain", "dring3", "dlate")
# the fused kernels whose ms the delta variants report (kernel_ab.py's
# DELTA_PASS_KERNELS but the dissection)
DELTA_KERNELS = ("vanilla_mlp_bwd", "vanilla_mlp_bwd_recompute",
                 "prop_mlp_bwd", "prop_mlp_bwd_res", "ref_spa_fwd_res",
                 "ref_spa_fwd_grad", "ref_spa_bwd", "ref_spa_bwd_recompute",
                 "ref_dir_bwd", "ref_dir_bwd_recompute")
DELTA_LIBRARIES = ("fused_mlp", "fused_mlp_bwd", "fused_mlp_recompute",
                   "ref_fused", "ref_fused_bwd", "ref_fused_recompute",
                   "wgrad", "dense", "delta")
DELTA_ROWS = 196_608      # a Ref-NeRF step's merged points
DENSE_SHAPES = (((256,), 256), ((63,), 256), ((167, 256), 256),
                ((256,), 128))
ROWS = 786_432            # one eval chunk of Ref-NeRF's merged points
# the rounding gate of chip_smoke.py's dense phase: its shapes and rows
GATE_SHAPES = (((256,), 256), ((167, 256), 256))
GATE_ROWS = 131_072
MEASURE_TIMEOUT = 600     # seconds; the tile's readings take about 11
TILE_KERNELS = ("dense_layer_kernel", "ref_spa_fwd_kernel",
                "ref_dir_fwd_kernel", "delta_layer_kernel",
                "vanilla_delta_kernel", "prop_delta_kernel",
                "vanilla_recompute_kernel", "ref_spa_fwd_res_kernel",
                "ref_spa_delta_kernel", "ref_dir_delta_kernel",
                "ref_spa_recompute_kernel", "ref_dir_recompute_kernel",
                "spa_frame_kernel", "dir_frame_kernel")


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
    if name in WGRAD_VARIANTS:
        return ("wgrad",)
    if name in FRAME_VARIANTS:
        return ("ref_fused", "ref_dissect", "dense")
    if name in DELTA_VARIANTS:
        return DELTA_LIBRARIES
    return ("dense", "ref_fused") if VARIANTS[name][0] else ("dense",)


def prepare(name: str) -> Path:
    """A fresh copy of the package with variant ``name``'s changes; returns
    the directory to run it from."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / "nerf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patched_sources(name, root / "nerf_tpu_torch")
    for script in ("chip_smoke.py", "loop_ab.py"):
        shutil.copy(ROOT / script, root / script)
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
    from nerf_tpu_torch.ops import dense as dense_lib
    from nerf_tpu_torch.tools.bench_ref_kernels import make_case, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    if name in WGRAD_VARIANTS:
        return wgrad_readings(name)
    if name in FRAME_VARIANTS:
        return frame_readings(name)
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
        return fn(acts[0], ws[0], b, *(acts[1:] + ws[1:]))

    out = {"variant": name, "device": torch.cuda.get_device_name(0),
           "ptxas": ptxas_summary(json.loads(
               report_path(name).read_text())),
           "dense_ms": {}}
    for ks, n_out in DENSE_SHAPES:
        acts, ws, b = operands(ROWS, ks, n_out)
        got = layer(ops.dense_layer, acts, ws, b)[0]
        want = layer(ops.dense_layer_plain, acts, ws, b)[0]
        err = float((got.float() - want.float()).abs().max())
        key = f"{'+'.join(map(str, ks))}->{n_out}"
        out["dense_ms"][key] = dict(
            ms=time_ms(lambda: layer(ops.dense_layer, acts, ws, b)[0]),
            max_abs_err=err)
        del acts, ws, got, want
        torch.cuda.empty_cache()
    out["rounding_gate"] = {}
    for ks, n_out in GATE_SHAPES:
        acts, ws, b = operands(GATE_ROWS, ks, n_out)
        exact = layer(dense_lib.dense_layer_f64, acts, ws, b)
        got = {"kernel": layer(ops.dense_layer, acts, ws, b)[0],
               "in_order": layer(dense_lib.dense_layer_in_order, acts, ws,
                                 b),
               "plain": layer(ops.dense_layer_plain, acts, ws, b)[0]}
        shares = {key: dense_lib.rounding_share(v, exact)
                  for key, v in got.items()}
        shares["ratio"] = shares["kernel"] / shares["in_order"]
        out["rounding_gate"][f"{'+'.join(map(str, ks))}->{n_out}"] = shares
        del acts, ws, exact, got
    if VARIANTS[name][0]:
        case = make_case(ROWS)
        out["ref_spa_fwd_ms"] = time_ms(
            lambda: ops.ref_spa_fwd(case["spa_ws"], case["enc"]))
        out["ref_dir_fwd_ms"] = time_ms(
            lambda: ops.ref_dir_fwd(case["dir_ws"], case["heads"],
                                    case["dirs"], 1, None,
                                    case["ide_level"]))
        del case
        torch.cuda.empty_cache()
    if name in DELTA_VARIANTS:
        out.update(delta_readings())
    return out


def delta_readings() -> dict:
    """Run from the copy: the delta pass's readings of the module
    docstring, through the copy's chip_smoke.py."""
    import torch

    import chip_smoke as cs
    from nerf_tpu_torch import ops
    from nerf_tpu_torch.tools.bench_ref_kernels import time_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = cs.delta_operands(gen, DELTA_ROWS, 256, 256, "act", torch.bfloat16)
    kw["store"] = None
    out = {"delta_ms": time_ms(lambda: ops.delta_layer(**kw)[0])}
    del kw
    out["kernel_ms"] = {}
    for name in DELTA_KERNELS:
        args, kernel = cs.kernel_case(name, torch.bfloat16, gen)[:2]
        out["kernel_ms"][name] = time_ms(lambda: kernel(*args))
        del args
        torch.cuda.empty_cache()
    out["delta_gate"] = cs.delta_gate_readings()
    order = cs.order_readings(cs.ORDER_SEEDS)
    out["order"] = {name: dict(max_ratio=max(r["ratio"] for r in rs),
                               ratios=[r["ratio"] for r in rs],
                               all_met=all(r["met"] for r in rs))
                    for name, rs in order.items()}
    return out


def wgrad_readings(name: str) -> dict:
    """Run from the copy: the weight-grad variants' readings of the module
    docstring, through the copy's chip_smoke.py."""
    import torch

    import chip_smoke as cs
    from nerf_tpu_torch import ops

    reports = json.loads(report_path(name).read_text())
    out = {"variant": name, "device": torch.cuda.get_device_name(0),
           "ptxas": cs.wgrad_build(reports, None),
           "wgrad_gate": cs.wgrad_gate_readings(), "wgrad_ms": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for lst, (jobs, rows, rnd, chunk) in cs.wgrad_lists(gen):
        pieces = cs.wgrad_walk(jobs, chunk)
        lib = [(a, d.to(torch.bfloat16)) for a, d, _ in jobs]
        out["wgrad_ms"][lst] = dict(
            ms=cs.cuda_device_ms(lambda: cs.wgrad_call(
                pieces, rows, rnd, ops.wgrad_reduce), 20),
            mm_ms=cs.cuda_device_ms(lambda: [torch.mm(a.T, d)
                                             for a, d in lib], 20))
        del jobs, pieces, lib
        torch.cuda.empty_cache()
    return out


def frame_readings(name: str) -> dict:
    """Run from the copy: the frame variants' readings of the module
    docstring, through the copy's chip_smoke.py."""
    import hashlib

    import torch

    import chip_smoke as cs
    from nerf_tpu_torch.core.encoding import ide_tables

    bf16 = torch.bfloat16
    out = {"variant": name, "device": torch.cuda.get_device_name(0),
           "ptxas": ptxas_summary(json.loads(report_path(name).read_text())),
           "ms": {}, "sha1": {}, "identities": {}, "dir_identities": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k in FRAME_TIMED:
        args, kernel = cs.kernel_case(k, bf16, gen)[:2]
        out["ms"][k] = cs.cuda_ms(lambda: kernel(*args), 20)
        out["sha1"][k] = sha1_of(kernel(*args), hashlib.sha1()).hexdigest()
        del args
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(19)
    ws = cs.random_weights(cs.ref_spa_shapes(), gen, bf16, gain=cs.REF_GAIN)
    for n in (129, 50_689):
        pos, x = cs.ref_points(gen, bf16, n)
        out["identities"][n] = cs.frame_identities(ws, x, pos)
    n_ch = ide_tables(4)["n_ch"]
    ws = cs.random_weights(cs.ref_dir_shapes(n_ch), gen, bf16,
                           gain=cs.REF_GAIN)
    for n, per_ray in ((129, 3), (50_689, 173)):
        heads = torch.randn((n, 139), generator=gen, device="cuda")
        dirs = cs.camera_dirs(gen, n // per_ray)
        out["dir_identities"][n] = cs.dir_frame_identities(
            ws, heads, dirs, per_ray, None, 4, False)
    return out


def sha1_of(t, h):
    """h updated with the bytes of every tensor in t (nested tuples)."""
    import torch

    if isinstance(t, (tuple, list)):
        for u in t:
            sha1_of(u, h)
    else:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h


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

    t0 = time.perf_counter()
    builds = {v: run(v, "--build") for v in args.variants}
    build_s = {}
    while len(build_s) < len(builds):
        for v, proc in builds.items():
            if v not in build_s and proc.poll() is not None:
                build_s[v] = time.perf_counter() - t0
        time.sleep(0.5)
    failed = [v for v, proc in builds.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"the build of {failed} failed")
    print(f"built {len(builds)} variants in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    results = []
    for v in args.variants:
        t0 = time.perf_counter()
        proc = run(v, "--measure", stdout=subprocess.PIPE, text=True)
        try:
            stdout = proc.communicate(timeout=MEASURE_TIMEOUT)[0]
            res = (json.loads(stdout.strip().splitlines()[-1])
                   if proc.returncode == 0
                   else {"variant": v, "error": f"exit {proc.returncode}"})
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            res = {"variant": v, "error": f"over {MEASURE_TIMEOUT} s"}
        results.append(dict(res, seconds=time.perf_counter() - t0,
                            build_seconds=build_s[v]))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
