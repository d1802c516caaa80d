// Split-K weight grads and their ordered reduction, shared by the backward
// kernels (fused_mlp_bwd.cu, fused_mlp_recompute.cu, ref_fused_bwd.cu,
// ref_fused_recompute.cu and ref_dir_recompute.cuh, which ref_dissect.cu
// includes too) and by the pass's own entry (wgrad.cu).
//
// A TPU backward zeroes its grads at grid step 0 and adds each tile's partial
// into them, in grid order.  GPU blocks run at the same time, so a backward
// here writes each layer's delta to device memory, then one launch computes
// dW = A^T delta and the bias sums for every (output tile, K-split) into
// per-split partials, and a second sums the partials of every grad in a
// fixed order: deterministic, no atomics.
//
// Two bodies compute the partials, picked by the operand type: bf16 operands
// multiply on the tensor cores (wgrad_mma_kernel, 128 x 128 output tiles),
// f32 operands on the CUDA cores in full f32 (wgrad_kernel, 64 x 64 tiles):
// TF32 would keep about three digits, which the f32 grads' limits do not
// allow.  Neither stands in for the other.

#pragma once

#include <type_traits>

#include "mlp_tile.cuh"
#include "mma_sm90.cuh"

// In a top-level unnamed namespace: each library that includes this keeps
// its own copy (nvcc cannot emit the host stubs of a __global__ template in
// an unnamed namespace nested in a named one).
namespace {

using namespace mlp;

constexpr int WT = 64;        // f32 body: output tile is WT x WT of dW (m x k)
constexpr int WR = 32;        // f32 body: points per staged chunk
constexpr int MAX_JOBS = 16;

// dW (m, k) = A^T delta over the points of one K-split, and, with
// bias_partial, db (k) = the column sums of delta.  A is (n, m) in T; delta is
// (n, k) in T or f32 (then rounded to T for the product, and summed unrounded
// for the bias), its rows ld elements apart.  partial: (splits, m, k);
// bias_partial: (splits, k).  tiles_k and tile_begin place the job's output
// tiles in the grid; a_mode and d_mode say how wgrad_mma_kernel stages A and
// delta (STAGE_*).
struct WGradJob {
  const void* a;
  const void* delta;
  float* partial;
  float* bias_partial;
  int64_t ld;
  int m, k, delta_f32, tiles_k, tile_begin, a_mode, d_mode;
};

struct WGradJobs {
  WGradJob job[MAX_JOBS];
  int n_jobs;
};

// The f32 body, on the CUDA cores: each thread owns a 4 x 4 block of a 64 x
// 64 output tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(WGradJobs jobs, int64_t n, int64_t rows_per_split,
             bool round_partial) {
  __shared__ __align__(16) float as[WR][WT];
  __shared__ __align__(16) float ds[WR][WT];    // delta as the product sees it
  __shared__ __align__(16) float draw[WR][WT];  // delta as stored (for the bias)
  int jx = 0;
  while (jx + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jx + 1].tile_begin)
    ++jx;
  const WGradJob& jb = jobs.job[jx];
  const int tile = blockIdx.x - jb.tile_begin;
  const int m0 = (tile / jb.tiles_k) * WT, k0 = (tile % jb.tiles_k) * WT;
  const int split = blockIdx.y;
  const int64_t lo = (int64_t)split * rows_per_split;
  const int64_t hi = lo + rows_per_split < n ? lo + rows_per_split : n;
  // each thread owns a 4 x 4 block of the output tile: rows m0 + 4 ty + i,
  // columns k0 + 4 tx + j, so both operands are read as float4
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool bias = jb.bias_partial != nullptr && m0 == 0;
  const T* a = (const T*)jb.a;
  float acc[4][4] = {};
  float bacc = 0.f;
  for (int64_t nb = lo; nb < hi; nb += WR) {
    for (int e = threadIdx.x; e < WR * WT; e += THREADS) {
      const int rr = e / WT, cc = e - rr * WT;
      const int64_t row = nb + rr;
      const bool in_rows = row < hi;
      as[rr][cc] = in_rows && m0 + cc < jb.m
          ? to_f(a[row * jb.m + m0 + cc]) : 0.f;
      float dv = 0.f, dp = 0.f;
      if (in_rows && k0 + cc < jb.k) {
        const int64_t at = row * jb.ld + k0 + cc;
        if (jb.delta_f32) {
          dv = ((const float*)jb.delta)[at];
          dp = to_f(from_f<T>(dv));
        } else {
          dv = dp = to_f(((const T*)jb.delta)[at]);
        }
      }
      ds[rr][cc] = dp;
      draw[rr][cc] = dv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WR; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[rr][4 * ty]);
      const float4 d4 = *reinterpret_cast<const float4*>(&ds[rr][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
    if (bias && threadIdx.x < WT)
      for (int rr = 0; rr < WR; ++rr) bacc += draw[rr][threadIdx.x];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + 4 * tx + j;
      if (mm < jb.m && kk < jb.k)
        jb.partial[((int64_t)split * jb.m + mm) * jb.k + kk] =
            round_partial ? to_f(from_f<T>(acc[i][j])) : acc[i][j];
    }
  }
  if (bias && threadIdx.x < WT && k0 + (int)threadIdx.x < jb.k)
    jb.bias_partial[(int64_t)split * jb.k + k0 + threadIdx.x] = bacc;
}

// ---------------------------------------------------------------------------
// The bf16 body, on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces the `grad_ref[...] += partial` accumulation of the Pallas
// backwards (nerf_tpu/ops/fused_mlp.py:228-237; nerf_tpu/ops/ref_fused.py:719,
// :794, :896) as wgrad_kernel does, for bf16 operands.  Bound by bytes on an
// H100: the pass reads every A and delta once and does 2 m k FLOPs per point
// and job, far below the bf16 tensor cores' 295 FLOPs per byte.  So the
// design keeps the copies in flight and the tensor cores fed:
//   - an output tile of MT x MT = 128 x 128 a block: a 256-wide layer's
//     chunk of A is read by two tiles and its delta by two, next to each
//     other in the grid (the same split), so the second read is an L2 hit.
//     A 64 x 64 tile read each 4 times; a 256 x 256 tile would need 256
//     accumulators a thread.  The 8 warps hold 2 x 4 warp tiles of 64 x 32:
//     4 x 4 mma tiles, 64 f32 accumulators a thread;
//   - chunks of MR = 64 points in a ring of MSTAGES = 3 shared-memory stages
//     (66 KB each: A's and delta's tiles and a copy area, see STAGE_*): the
//     copies of chunks c + 1 and c + 2 are in flight while the tensor cores
//     work on chunk c;
//   - products by mma.sync m16n8k16 (bf16 in, f32 accumulate).  Both operands
//     are stored point-major, A (n, m) and delta (n, k), and the product sums
//     over points, so both are read from shared memory by ldmatrix .trans:
//     an 8 x 8 block of 8 points x 8 columns arrives as the fragment of 8
//     columns x 8 points.  Rows are padded to 136 elements (272 bytes), so
//     the 8 rows an ldmatrix reads start in 8 different bank quads.  The
//     next 16 points' fragments are read while the tensor cores work;
//   - one block an SM (198 KB of shared memory, up to 255 registers: no
//     spills).  On an H100 80GB HBM3 at 700 W (PERF.md), 2 blocks an
//     SM under a 128-register cap (32-point chunks) ran the vanilla list in
//     1.52 ms against this design's 1.09; a persistent grid (one block an
//     SM walking the (tile, split) items in turn) ran slower: the items
//     differ in cost and a fixed share leaves SMs idle at the end.
// Rows past the split's end are staged as zeros.  Columns past an operand's
// width are not staged: they reach only the output rows or columns past m
// or k, which are not stored, and warps skip the mma tiles that lie wholly
// there.
// The bias sums the delta as stored: a bf16 delta from the staged chunk, an
// f32 one from the unrounded values of the copy area.  Each sum runs in a
// fixed order, and no atomics: two launches give the same bits.  The order
// of the products within a split is the tensor cores' own; the splits are
// summed in order by reduce_kernel.
constexpr int MT = 128;                 // output tile: MT x MT of dW (m x k)
constexpr int MR = 64;                  // points per staged chunk
constexpr int MSTAGES = 3;              // chunks in the ring
constexpr int MLD = MT + 8;             // padded row of a staged chunk
constexpr int TILE_ELEMS = MR * MLD;    // one operand's staged chunk (bf16)
constexpr int RAW_BYTES = 32768;        // a stage's copy area (see below)
constexpr int STAGE_BYTES = 2 * TILE_ELEMS * 2 + RAW_BYTES;
constexpr size_t MSMEM = (size_t)MSTAGES * STAGE_BYTES;

typedef __nv_bfloat16 bf16;

// How an operand is staged (WGradJob::a_mode, d_mode; stage_mode picks it).
// The chunk is rows [row0, row0 + MR) of columns [c0, c0 + w) of an (n, ld)
// array, rows at or past the split's end hi as zeros, in a tile of MR x MLD
// bf16.
//   STAGE_VEC   bf16 whose rows are 16-byte aligned and w a multiple of 8
//               (every 256- and 128-wide operand of the backwards): 16-byte
//               cp.async copies straight into the tile.
//   STAGE_SPAN  other bf16 with ld <= SPAN_LD (the 63-, 27- and 167-wide
//               trunk inputs, the 1- to 9-wide heads): the chunk's rows lie
//               in one span of memory, copied by 16-byte cp.async of its
//               aligned words into the stage's copy area (the words at the
//               span's ends read whole: an aligned 16-byte word never
//               crosses a page), then scattered into the tile.
//   STAGE_F32   an f32 delta (dbvec, the logits' delta, the strided head
//               cotangents at an offset): copied by cp.async into the copy
//               area as MR x MT f32 (16 bytes at a time where the rows are
//               aligned, else 4), then rounded into the tile; the unrounded
//               values feed the bias.
//   STAGE_ELEM  anything else, and A where delta takes the copy area: loaded
//               element by element into the tile as the chunk is issued.
// The copies of chunk j are issued MSTAGES - 1 chunks ahead; the scatter or
// rounding from the copy area (finish_chunk) runs when chunk j is due,
// before its products.
constexpr int STAGE_VEC = 0, STAGE_SPAN = 1, STAGE_F32 = 2, STAGE_ELEM = 3;
constexpr int SPAN_LD = 256;            // (MR - 1) SPAN_LD + MT bf16 fit

struct Span {
  const uint4* first;                   // the first aligned word
  int words, rows;
};

__device__ __forceinline__ Span span_of(const bf16* src, int64_t ld,
                                        int64_t row0, int64_t hi, int c0,
                                        int w) {
  Span s;
  s.rows = (int)(hi - row0 < MR ? hi - row0 : MR);
  const bf16* base = src + row0 * ld;
  const uintptr_t first = (uintptr_t)(base + c0) & ~(uintptr_t)15;
  const uintptr_t last = (uintptr_t)(base + (s.rows - 1) * ld + c0 + w);
  s.first = reinterpret_cast<const uint4*>(first);
  s.words = (int)((last - first + 15) >> 4);
  return s;
}

__device__ __forceinline__ void issue_vec(bf16* dst, const bf16* src,
                                          int64_t ld, int64_t row0,
                                          int64_t hi, int c0, int w) {
#pragma unroll
  for (int i = 0; i < MR * (MT / 8) / THREADS; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int r = q / (MT / 8), c = (q % (MT / 8)) * 8;
    if (c >= w) continue;
    bf16* d = dst + r * MLD + c;
    const int64_t row = row0 + r;
    if (row < hi)
      cp_async16(d, src + row * ld + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void issue_span(unsigned char* raw,
                                           const bf16* src, int64_t ld,
                                           int64_t row0, int64_t hi, int c0,
                                           int w) {
  const Span s = span_of(src, ld, row0, hi, c0, w);
  for (int j = threadIdx.x; j < s.words; j += THREADS)
    cp_async16(raw + 16 * j, s.first + j);
}

// the span's elements of columns [c0, c0 + w) from the copy area into the
// tile; rows past the span's as zeros
__device__ __forceinline__ void finish_span(bf16* dst,
                                            const unsigned char* raw,
                                            const bf16* src, int64_t ld,
                                            int64_t row0, int64_t hi, int c0,
                                            int w) {
  const Span s = span_of(src, ld, row0, hi, c0, w);
  const bf16* base = src + row0 * ld;
  const int ldi = (int)ld;
  for (int j = threadIdx.x; j < s.words; j += THREADS) {
    // the word's first element, counted from element (row0, 0)
    const int p = (int)(reinterpret_cast<const bf16*>(s.first + j) - base);
    int r = p >= 0 ? p / ldi : -((ldi - 1 - p) / ldi);
    int col = p - r * ldi;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + 16 * j);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (r >= 0 && r < s.rows && col >= c0 && col < c0 + w)
        dst[r * MLD + col - c0] = e[q];
      if (++col == ldi) {
        col = 0;
        ++r;
      }
    }
  }
  for (int q = s.rows * MT + threadIdx.x; q < MR * MT; q += THREADS)
    dst[(q / MT) * MLD + q % MT] = __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void issue_f32(unsigned char* raw,
                                          const float* src, int64_t ld,
                                          int64_t row0, int64_t hi, int c0,
                                          int w) {
  float* d = reinterpret_cast<float*>(raw);       // [MR][MT]
  const int rows = (int)(hi - row0 < MR ? hi - row0 : MR);
  const float* s = src + row0 * ld + c0;
  if ((uintptr_t)s % 16 == 0 && ld % 4 == 0 && w % 4 == 0) {
    for (int q = threadIdx.x; q < rows * (MT / 4); q += THREADS) {
      const int r = q / (MT / 4), c = (q % (MT / 4)) * 4;
      if (c < w) cp_async16(d + r * MT + c, s + r * ld + c);
    }
  } else {
    for (int q = threadIdx.x; q < rows * MT; q += THREADS) {
      const int r = q / MT, c = q % MT;
      if (c < w) cp_async4(d + r * MT + c, s + r * ld + c);
    }
  }
}

// the copy area's f32 values rounded into the tile: thread t takes columns
// 4 (t % 32) .. +3 of rows t / 32 + 8 i and adds the unrounded values to
// bsum[0..3]; rows past the chunk's as zeros
__device__ __forceinline__ void finish_f32(bf16* dst,
                                           const unsigned char* raw,
                                           int64_t row0, int64_t hi, int w,
                                           float (&bsum)[8]) {
  const float* s = reinterpret_cast<const float*>(raw);
  const int rows = (int)(hi - row0 < MR ? hi - row0 : MR);
  const int c = (threadIdx.x % 32) * 4;
  if (c >= w) return;
#pragma unroll
  for (int i = 0; i < MR / 8; ++i) {
    const int r = threadIdx.x / 32 + 8 * i;
    const float4 v = r < rows
        ? *reinterpret_cast<const float4*>(s + r * MT + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + r * MLD + c);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
    bsum[0] += v.x;
    bsum[1] += v.y;
    bsum[2] += v.z;
    bsum[3] += v.w;
  }
}

// STAGE_ELEM: thread t keeps column t % MT of rows t / MT + 2 i, its loads
// all in flight at once
__device__ __forceinline__ void stage_elem(bf16* dst, const bf16* src,
                                           int64_t ld, int64_t row0,
                                           int64_t hi, int c0, int w) {
  const int c = threadIdx.x % MT;
  if (c >= w) return;
  bf16 v[MR * MT / THREADS];
#pragma unroll
  for (int i = 0; i < MR * MT / THREADS; ++i) {
    const int64_t row = row0 + threadIdx.x / MT + (THREADS / MT) * i;
    v[i] = row < hi ? src[row * ld + c0 + c] : __float2bfloat16_rn(0.f);
  }
#pragma unroll
  for (int i = 0; i < MR * MT / THREADS; ++i)
    dst[(threadIdx.x / MT + (THREADS / MT) * i) * MLD + c] = v[i];
}

// The stages: A's tile, delta's tile, the copy area.
__device__ __forceinline__ bf16* a_tile(unsigned char* smem, int slot) {
  return reinterpret_cast<bf16*>(smem + (size_t)slot * STAGE_BYTES);
}
__device__ __forceinline__ bf16* d_tile(unsigned char* smem, int slot) {
  return a_tile(smem, slot) + TILE_ELEMS;
}
__device__ __forceinline__ unsigned char* raw_area(unsigned char* smem,
                                                   int slot) {
  return smem + (size_t)slot * STAGE_BYTES + 2 * TILE_ELEMS * 2;
}

// Issue the copies of chunk rows [row0, row0 + MR) into stage ``slot``
// (STAGE_ELEM loads at once).
__device__ __forceinline__ void issue_chunk(unsigned char* smem, int slot,
                                            const WGradJob& jb, int64_t row0,
                                            int64_t hi, int m0, int k0) {
  const int wa = min(MT, jb.m - m0), wd = min(MT, jb.k - k0);
  const bf16* a = (const bf16*)jb.a;
  if (jb.a_mode == STAGE_VEC)
    issue_vec(a_tile(smem, slot), a, jb.m, row0, hi, m0, wa);
  else if (jb.a_mode == STAGE_SPAN)
    issue_span(raw_area(smem, slot), a, jb.m, row0, hi, m0, wa);
  else
    stage_elem(a_tile(smem, slot), a, jb.m, row0, hi, m0, wa);
  if (jb.d_mode == STAGE_VEC)
    issue_vec(d_tile(smem, slot), (const bf16*)jb.delta, jb.ld, row0, hi, k0,
              wd);
  else if (jb.d_mode == STAGE_SPAN)
    issue_span(raw_area(smem, slot), (const bf16*)jb.delta, jb.ld, row0, hi,
               k0, wd);
  else if (jb.d_mode == STAGE_F32)
    issue_f32(raw_area(smem, slot), (const float*)jb.delta, jb.ld, row0, hi,
              k0, wd);
  else
    stage_elem(d_tile(smem, slot), (const bf16*)jb.delta, jb.ld, row0, hi,
               k0, wd);
}

// Move the landed copy area of stage ``slot`` into its tile.
__device__ __forceinline__ void finish_chunk(unsigned char* smem, int slot,
                                             const WGradJob& jb, int64_t row0,
                                             int64_t hi, int m0, int k0,
                                             float (&bsum)[8]) {
  const int wa = min(MT, jb.m - m0), wd = min(MT, jb.k - k0);
  if (jb.a_mode == STAGE_SPAN)
    finish_span(a_tile(smem, slot), raw_area(smem, slot), (const bf16*)jb.a,
                jb.m, row0, hi, m0, wa);
  if (jb.d_mode == STAGE_SPAN)
    finish_span(d_tile(smem, slot), raw_area(smem, slot),
                (const bf16*)jb.delta, jb.ld, row0, hi, k0, wd);
  else if (jb.d_mode == STAGE_F32)
    finish_f32(d_tile(smem, slot), raw_area(smem, slot), row0, hi, wd, bsum);
}

// The fragments of 16 points for the warp's 4 x 4 mma tiles: A's blocks
// (columns +0 | +8) x (points +0..7 | +8..15) and delta's (points +0..7 |
// +8..15) x (columns +0 | +8), from rows ``row`` of the staged chunk.
__device__ __forceinline__ void load_frags(uint32_t (&a)[4][4],
                                           uint32_t (&b)[4][2],
                                           const bf16* pa, const bf16* pb,
                                           int row) {
#pragma unroll
  for (int np = 0; np < 2; ++np)
    ldsm_x4_t(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1],
              pb + row * MLD + np * 16);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    ldsm_x4_t(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
              pa + row * MLD + mt * 16);
}

// One staged chunk's products into the warp's 4 x 4 mma tiles (rows wrow..,
// columns wcol.. of the block's tile), 16 points a step; the next step's
// fragments are read while the tensor cores work on this one's.  FULL:
// every mma tile lies inside m x k, else only the first mt_n x nt_n count.
template <bool FULL>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4][4],
                                          const bf16* as, const bf16* ds,
                                          int wrow, int wcol, int mt_n,
                                          int nt_n) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = as + ((lane & 7) + ((lane >> 4) & 1) * 8) * MLD + wrow
      + ((lane >> 3) & 1) * 8;
  const bf16* pb = ds + ((lane & 7) + ((lane >> 3) & 1) * 8) * MLD + wcol
      + ((lane >> 4) & 1) * 8;
  uint32_t a[2][4][4], b[2][4][2];
  load_frags(a[0], b[0], pa, pb, 0);
#pragma unroll
  for (int ks = 0; ks < MR / 16; ++ks) {
    if (ks + 1 < MR / 16)
      load_frags(a[(ks + 1) & 1], b[(ks + 1) & 1], pa, pb, (ks + 1) * 16);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (FULL || (mt < mt_n && nt < nt_n))
          mma_bf16(acc[mt][nt], a[ks & 1][mt], b[ks & 1][nt]);
  }
}

// T is bf16: a template, so that only the libraries that launch it compile it
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_mma_kernel(WGradJobs jobs, int64_t n, int64_t rows_per_split,
                 bool round_partial) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core body is bf16");
  extern __shared__ __align__(128) unsigned char wgrad_smem[];
  int jx = 0;
  while (jx + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jx + 1].tile_begin)
    ++jx;
  const WGradJob& jb = jobs.job[jx];
  const int tile = blockIdx.x - jb.tile_begin;
  const int m0 = (tile / jb.tiles_k) * MT, k0 = (tile % jb.tiles_k) * MT;
  const int split = blockIdx.y;
  const int64_t lo = (int64_t)split * rows_per_split;
  const int64_t hi = lo + rows_per_split < n ? lo + rows_per_split : n;
  const int chunks = hi > lo ? (int)((hi - lo + MR - 1) / MR) : 0;
  const bool bias = jb.bias_partial != nullptr && m0 == 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;        // 2 x 4 warps
  const int wrow = wm * 64, wcol = wn * 32;       // the warp's 64 x 32 tile
  // mma tiles of this warp that hold some row < m and column < k
  const int mt_n = max(0, min(4, (jb.m - m0 - wrow + 15) / 16));
  const int nt_n = max(0, min(4, (jb.k - k0 - wcol + 7) / 8));
  const bool full = mt_n == 4 && nt_n == 4;
  float acc[4][4][4] = {};
  float bsum[8] = {};      // bias partials: 8 columns (bf16 delta) or 4 (f32)

  const bool copied = jb.a_mode == STAGE_SPAN || jb.d_mode == STAGE_SPAN
      || jb.d_mode == STAGE_F32;

#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < chunks)
      issue_chunk(wgrad_smem, s, jb, lo + (int64_t)s * MR, hi, m0, k0);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<MSTAGES - 2>();   // this thread's copies of chunk c landed
    __syncthreads();                // everyone's, and chunk c - 1 is done
    const int next = c + MSTAGES - 1;
    if (next < chunks)
      issue_chunk(wgrad_smem, next % MSTAGES, jb, lo + (int64_t)next * MR, hi,
                  m0, k0);
    cp_async_commit();
    if (copied) {
      finish_chunk(wgrad_smem, c % MSTAGES, jb, lo + (int64_t)c * MR, hi, m0,
                   k0, bsum);
      __syncthreads();
    }
    const bf16* as = a_tile(wgrad_smem, c % MSTAGES);
    const bf16* ds = d_tile(wgrad_smem, c % MSTAGES);
    if (full)
      mma_chunk<true>(acc, as, ds, wrow, wcol, mt_n, nt_n);
    else if (mt_n > 0 && nt_n > 0)
      mma_chunk<false>(acc, as, ds, wrow, wcol, mt_n, nt_n);
    if (bias && !jb.delta_f32) {
      // thread t sums columns 8 (t % 16) .. +7 of its MR / 16 rows
      constexpr int RPG = MR / (THREADS / (MT / 8));
      const bf16* src = ds + (threadIdx.x / (MT / 8)) * RPG * MLD
          + (threadIdx.x % (MT / 8)) * 8;
#pragma unroll
      for (int rr = 0; rr < RPG; ++rr) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + rr * MLD);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          bsum[2 * j] += f.x;
          bsum[2 * j + 1] += f.y;
        }
      }
    }
  }
  cp_async_wait<0>();

  // c0 c1: row g, columns 2 q, 2 q + 1; c2 c3: row g + 8
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (mt >= mt_n || nt >= nt_n) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = m0 + wrow + mt * 16 + g + (e >> 1) * 8;
        const int kk = k0 + wcol + nt * 8 + 2 * q + (e & 1);
        if (mm < jb.m && kk < jb.k) {
          const float v = acc[mt][nt][e];
          jb.partial[((int64_t)split * jb.m + mm) * jb.k + kk] =
              round_partial ? to_f(from_f<bf16>(v)) : v;
        }
      }
    }
  }
  if (bias) {
    // each thread's sums over its rows of the chunks: a bf16 delta's 8
    // columns from the tiles (group t / 16), an f32 delta's 4 from
    // finish_f32 (group t / 32); the groups added in a fixed order
    __syncthreads();                // the ring is free
    float* red = reinterpret_cast<float*>(wgrad_smem);   // [groups][MT]
    if (jb.delta_f32) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(threadIdx.x / 32) * MT + (threadIdx.x % 32) * 4 + j] = bsum[j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(threadIdx.x / 16) * MT + (threadIdx.x % 16) * 8 + j] = bsum[j];
    }
    __syncthreads();
    const int col = threadIdx.x, groups = jb.delta_f32 ? 8 : 16;
    if (col < MT && k0 + col < jb.k) {
      float s = 0.f;
      for (int i = 0; i < groups; ++i) s += red[i * MT + col];
      jb.bias_partial[(int64_t)split * jb.k + k0 + col] = s;
    }
  }
}

// out[e] = sum over splits s = 0, 1, ... of partial[s * count + e], for every
// grad; one thread per output element, the splits summed in order.  With
// accumulate the sum starts from out[e] instead of 0: a backward that walks
// the points in chunks of whole splits reduces each chunk's splits onto the
// sum so far, in the same order as one reduction over all of them.
constexpr int MAX_GRADS = 24;

struct ReduceJobs {
  const float* partial[MAX_GRADS];
  float* out[MAX_GRADS];
  int64_t begin[MAX_GRADS + 1];   // prefix sums of the grads' sizes
  int n_grads;
};

__global__ void __launch_bounds__(THREADS)
reduce_kernel(ReduceJobs jobs, int splits, bool accumulate) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= jobs.begin[jobs.n_grads]) return;
  int gx = 0;
  while (idx >= jobs.begin[gx + 1]) ++gx;
  const int64_t count = jobs.begin[gx + 1] - jobs.begin[gx];
  const int64_t e = idx - jobs.begin[gx];
  const float* src = jobs.partial[gx];
  float s = accumulate ? jobs.out[gx][e] : 0.f;
  for (int k = 0; k < splits; ++k) s += src[k * count + e];
  jobs.out[gx][e] = s;
}

// The grads of a weight tuple: sizes[i] values for grad i, written to
// grads[i]; partials carved from `partial` (splits x the sum of sizes) in the
// tuple's order.  Jobs name the (matrix, bias) index pair they produce.
struct GradPlan {
  int n_grads;
  int64_t sizes[MAX_GRADS];
  int64_t offset[MAX_GRADS];      // into partial, in floats
};

inline GradPlan plan_grads(const int64_t* sizes, int n_grads, int splits) {
  GradPlan g;
  g.n_grads = n_grads;
  int64_t at = 0;
  for (int i = 0; i < n_grads; ++i) {
    g.sizes[i] = sizes[i];
    g.offset[i] = at;
    at += sizes[i] * splits;
  }
  return g;
}

// How wgrad_mma_kernel stages an operand of width w whose rows are ld
// elements apart (STAGE_*): bf16 by 16-byte copies where the rows are
// 16-byte aligned and w is a multiple of 8, else as a span while ld <=
// SPAN_LD, else element by element; f32 through the copy area.
inline int stage_mode(const void* p, int w, int64_t ld, bool f32) {
  if (f32) return STAGE_F32;
  if ((uintptr_t)p % 16 == 0 && w % 8 == 0 && ld % 8 == 0) return STAGE_VEC;
  return ld <= SPAN_LD ? STAGE_SPAN : STAGE_ELEM;
}

// One weight-grad job: grad index wi = A^T delta (m x k), bias index bi
// (-1: none); delta's rows are ld apart (0: k, a contiguous (n, k) array).
// ``tiles`` counts the f32 body's WT x WT output tiles; the bf16 body plans
// its own (plan_mma_tiles).  a_mode and d_mode: how the bf16 body stages
// the operand, from its type, alignment, width and row stride.
inline void add_job(WGradJobs& jobs, int& tiles, const GradPlan& g,
                    float* partial,
             const void* a, int m, const void* delta, int k, bool delta_f32,
             int wi, int bi, int64_t ld = 0) {
  WGradJob& j = jobs.job[jobs.n_jobs++];
  j.a = a;
  j.delta = delta;
  j.ld = ld > 0 ? ld : k;
  j.m = m;
  j.k = k;
  j.delta_f32 = delta_f32 ? 1 : 0;
  j.partial = partial + g.offset[wi];
  j.bias_partial = bi >= 0 ? partial + g.offset[bi] : nullptr;
  j.tiles_k = (k + WT - 1) / WT;
  j.tile_begin = tiles;
  tiles += ((m + WT - 1) / WT) * j.tiles_k;
  j.d_mode = stage_mode(delta, k, j.ld, delta_f32);
  // one copy area a stage: delta's, if it takes it
  j.a_mode = stage_mode(a, m, m, false);
  if (j.a_mode == STAGE_SPAN
      && (j.d_mode == STAGE_SPAN || j.d_mode == STAGE_F32))
    j.a_mode = STAGE_ELEM;
}

// The jobs with the bf16 body's MT x MT output tiles in place of the f32
// body's; returns the grid's tile count.
inline int plan_mma_tiles(WGradJobs& jobs) {
  int tiles = 0;
  for (int i = 0; i < jobs.n_jobs; ++i) {
    WGradJob& j = jobs.job[i];
    j.tiles_k = (j.k + MT - 1) / MT;
    j.tile_begin = tiles;
    tiles += ((j.m + MT - 1) / MT) * j.tiles_k;
  }
  return tiles;
}

// rows_per_split: the points of each K-split; round_partial: round each
// split's weight grad (not the bias sums) to T before the reduction;
// accumulate: add the splits' sum to what grads hold (reduce_kernel).  The
// operand type picks the body: bf16 on the tensor cores, f32 on the CUDA
// cores (no TF32).
template <typename T>
int launch_wgrad_reduce(const WGradJobs& jobs, int tiles, const GradPlan& g,
                        float* partial, const uint64_t* grads, int64_t n,
                        int splits, int64_t rows_per_split,
                        bool round_partial, cudaStream_t stream,
                        bool accumulate = false) {
  int err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGradJobs mj = jobs;
    const int mtiles = plan_mma_tiles(mj);
    err = set_smem(wgrad_mma_kernel<T>, MSMEM);
    if (err != 0) return err;
    wgrad_mma_kernel<T><<<dim3((unsigned)mtiles, (unsigned)splits), THREADS,
                       MSMEM, stream>>>(mj, n, rows_per_split, round_partial);
  } else {
    wgrad_kernel<T><<<dim3((unsigned)tiles, (unsigned)splits), THREADS, 0,
                      stream>>>(jobs, n, rows_per_split, round_partial);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ReduceJobs rj;
  rj.n_grads = g.n_grads;
  rj.begin[0] = 0;
  for (int i = 0; i < g.n_grads; ++i) {
    rj.partial[i] = partial + g.offset[i];
    rj.out[i] = (float*)grads[i];
    rj.begin[i + 1] = rj.begin[i] + g.sizes[i];
  }
  const unsigned blocks =
      (unsigned)((rj.begin[g.n_grads] + THREADS - 1) / THREADS);
  reduce_kernel<<<blocks, THREADS, 0, stream>>>(rj, splits, accumulate);
  return (int)cudaGetLastError();
}

// The chunk loop of the backwards that walk the points in chunks of whole
// K-splits: for each chunk of chunk_rows points (rows_per_split each split),
// ``run(c0, nc, plan, jobs, tiles)`` launches the chunk's delta kernel and
// fills ``jobs``; then, with ``wgrads``, the weight-grad pass over the chunk's
// splits (each split's weight grad rounded to T with ``round_partial``) and
// the reduction onto the sums of the chunks before it.  The splits are
// summed in the same order as one reduction over all of them, so the grads
// do not depend on the chunk size.
template <typename T, typename Chunk>
int chunked_wgrad(const int64_t* sizes, int n_grads, int64_t n,
                  int64_t rows_per_split, int64_t chunk_rows, float* partial,
                  const uint64_t* grads, bool round_partial,
                  cudaStream_t stream, Chunk run, bool wgrads = true) {
  if (rows_per_split < 1 || chunk_rows < rows_per_split
      || chunk_rows % rows_per_split != 0)
    return (int)cudaErrorInvalidValue;
  int64_t c0 = 0;
  do {
    const int64_t nc = n - c0 < chunk_rows ? n - c0 : chunk_rows;
    int splits = (int)((nc + rows_per_split - 1) / rows_per_split);
    if (splits < 1) splits = 1;
    const GradPlan gp = plan_grads(sizes, n_grads, splits);
    WGradJobs jobs;
    jobs.n_jobs = 0;
    int tiles = 0;
    int err = run(c0, nc, gp, jobs, tiles);
    if (err != 0) return err;
    if (wgrads) {
      err = launch_wgrad_reduce<T>(jobs, tiles, gp, partial, grads, nc,
                                   splits, rows_per_split, round_partial,
                                   stream, c0 > 0);
      if (err != 0) return err;
    }
    c0 += chunk_rows;
  } while (c0 < n);
  return 0;
}

}  // namespace
