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
// and job, far below the bf16 tensor cores' 295 FLOPs per byte.  The
// mma.sync body that this replaces had every thread issue cp.async copies
// and met two block-wide barriers a chunk, read its operands by ldmatrix
// from padded rows, and chained all 256 k-steps of a split in the tensor
// cores, which read 7.5 times the error of the in-order f32 sum (the wgrad
// phase's rounding gate, PERF.md).  This design:
//   - an output tile of MT x MT = 128 x 128 a block: a 256-wide layer's
//     chunk of A is read by two tiles and its delta by two, next to each
//     other in the grid (the same split), so the second read is an L2 hit;
//   - a producer warpgroup and two consumer warpgroups.  Thread 0 keeps a
//     ring of WSTAGES slots filled by TMA, each slot one chunk of MR = 64
//     points of A's and delta's 128 columns, with full/empty mbarriers: no
//     block-wide barrier runs in the point loop;
//   - the chunks are stored as TMA writes them in the 128-byte swizzle
//     (points as rows, 64-column atoms), which wgmma reads straight through
//     its descriptors with both operands MN-major (A^T and delta, both
//     transpose bits set, wgmma_ss): no padding, no ldmatrix, no registers
//     for the operands;
//   - each consumer owns 64 rows of the tile, its sum in 64 f32 registers a
//     thread.  Each k-step of 16 points is summed from zero by the tensor
//     cores (scale-d 0, a wgmma of 64 columns a half) into a partial and
//     added to the f32 sum: G = 1, one rounding a k-step, which the rounding
//     gate reads at 0.60-0.77 of the in-order sum's error (tools/
//     tile_variants' wchain, the k-steps chained, reads above 1.0);
//   - operands that TMA cannot read into the slot (the 63-, 27- and
//     167-wide inputs, the 1- to 9-wide heads, the f32 deltas, the heads'
//     strided cotangents) arrive in RSLOTS copy areas, RSLOTS chunks ahead,
//     by one TMA box or bulk copy a chunk (STAGE_*), and the producer
//     warpgroup rounds and scatters them into the slot's swizzled layout,
//     16 bytes a store, then fences (fence_proxy_async) and arrives on the
//     slot's full barrier once a warp;
//   - the bias sums run on the producer warpgroup beside the products: a
//     TMA-read delta's from the slot once it is full (a release of the
//     slot that the empty barrier waits for), any other's from the
//     unrounded values as they are staged;
//   - one block an SM (WSMEM bytes of shared memory).
// Rows past the split's end count as zeros: staging writes them as zeros,
// and a TMA-read delta of a split whose last chunk reaches into the next is
// read through a 3-d map of (columns, points of a split, splits), whose box
// stops at the split's end; the rows of A there meet those zeros.  Columns
// past an operand's width are not staged: they reach only the output rows
// or columns past m or k, which are not stored, and a consumer skips a
// product that lies wholly there.  Each bias sum runs in a fixed order, and
// no atomics: two launches give the same bits.  The order of the products
// within a k-step is the tensor cores' own; the k-steps are summed in
// order, and the splits in order by reduce_kernel.
constexpr int MT = 128;                 // output tile: MT x MT of dW (m x k)
constexpr int MR = 64;                  // points per chunk
constexpr int WATOM = 64;               // columns of a swizzle atom (128 B)
constexpr int ATOM_BYTES = MR * WATOM * 2;          // one atom of a chunk
constexpr int SLOT_BYTES = 4 * ATOM_BYTES;          // A's and delta's chunks
constexpr int WSTAGES = 3;              // slots in the ring
constexpr int PT = 128;                 // threads of a warpgroup
constexpr int WTHREADS = 3 * PT;        // the producer and two consumers
// a copy area: a chunk's span (MR - 1 rows of up to SPAN_LD bf16 or
// SPAN_LD / 2 f32 and a row's MT values, from its first 16-byte word), its
// MR x MT f32 values, or the 16-byte words of each of its MR rows of MT f32
// values, RAW_ROW bytes apart
constexpr int SPAN_LD = 256;
constexpr int RAW_ROW = MT * 4 + 32;
constexpr int RAW_BYTES = MR * RAW_ROW;
constexpr int RSLOTS = 3;               // copy areas
constexpr int RAW_AT = WSTAGES * SLOT_BYTES;
constexpr int BARS_AT = RAW_AT + RSLOTS * RAW_BYTES;
// and 1024 bytes to align the ring to the swizzle's period
constexpr size_t WSMEM = 1024 + BARS_AT + (2 * WSTAGES + RSLOTS) * 8;

typedef __nv_bfloat16 bf16;

// How an operand is staged (WGradJob::a_mode, d_mode; stage_mode picks it).
// A chunk is rows [row0, row0 + MR) of columns [c0, c0 + w) of an (n, ld)
// array, rows at or past the split's end as zeros, in a slot's operand of
// two 64-column atoms in the 128-byte swizzle (sw).
//   STAGE_TMA   bf16 whose rows are 16-byte aligned (every 256- and
//               128-wide operand of the backwards): TMA boxes of 64 columns
//               by MR points, straight into the slot.
//   STAGE_F32   an f32 delta whose rows are 16-byte aligned (dbvec): a TMA
//               box of MT columns by MR points into a copy area.
//   STAGE_SPAN  any other operand whose chunk lies in one span of memory
//               that a copy area holds (the 63-, 27- and 167-wide inputs,
//               the 1- to 9-wide heads): one bulk copy of the span's
//               16-byte words (an aligned word never crosses a page, so
//               the words at its ends read whole).
//   STAGE_ROWS  an f32 delta of longer rows (the heads' strided cotangents
//               at an offset): 16-byte cp.async copies of the words of each
//               row.
//   STAGE_ELEM  bf16 of longer unaligned rows, and A where delta takes the
//               copy areas: loaded by the producer threads as it is staged.
// The producer warpgroup rounds and scatters a copy area into the slot.
constexpr int STAGE_TMA = 0, STAGE_F32 = 1, STAGE_SPAN = 2, STAGE_ROWS = 3,
              STAGE_ELEM = 4;

// The element offset of (row r, column c) of a chunk's operand: atom c / 64,
// the 16-byte piece u of row r at piece u ^ (r % 8) (the 128-byte swizzle,
// which TMA writes and wgmma_desc_sw128 reads).
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * (MR * WATOM) + r * WATOM + ((((c >> 3) & 7) ^ (r & 7)) << 3)
      + (c & 7);
}

// The block's shared memory, from the first 1024-byte boundary of its
// dynamic shared memory: the ring's slots (A's chunk, then delta's), the
// copy areas, the barriers (full[WSTAGES], empty[WSTAGES], the copy areas'
// rfull[RSLOTS]).
struct WRingMem {
  unsigned char* base;

  __device__ bf16* a_slot(int c) const {
    return reinterpret_cast<bf16*>(base + (c % WSTAGES) * SLOT_BYTES);
  }
  __device__ bf16* d_slot(int c) const {
    return a_slot(c) + 2 * MR * WATOM;
  }
  __device__ unsigned char* raw(int c) const {
    return base + RAW_AT + (c % RSLOTS) * RAW_BYTES;
  }
  __device__ uint32_t full(int c) const {
    return smem_addr(base + BARS_AT) + (c % WSTAGES) * 8;
  }
  __device__ uint32_t empty(int c) const {
    return full(c) + WSTAGES * 8;
  }
  __device__ uint32_t rfull(int c) const {
    return smem_addr(base + BARS_AT) + (2 * WSTAGES + c % RSLOTS) * 8;
  }
};

// An operand of a chunk: element (row0, c0), its row stride and value size
// in bytes, its columns w and the chunk's rows in the split.
struct Operand {
  const unsigned char* p;
  int64_t ld;
  int w, es, rows;
};

// The TMA maps of the jobs' operands: map 3 j of job j's A (the (m, n)
// array, boxes of 64 columns by MR points), 3 j + 1 of its delta as (k,
// rows_per_split, whole splits) and 3 j + 2 as (k, n), both in boxes of 64
// columns by MR points (bf16, 128-byte swizzle) or MT columns by MR points
// (STAGE_F32), so that a chunk that reaches past a whole split's end reads
// zeros there (the last split, which may be short, reads through the 2-d
// map to the array's end).  Entries of operands that TMA does not read are
// unset.  One kernel parameter (__grid_constant__), encoded at every launch
// as the layer tile's maps are (mlp_tile.cuh's weight_map).
struct WGradMaps {
  CUtensorMap map[3 * MAX_JOBS];
};

// Thread 0: the TMA boxes of a delta's chunk ``c`` (split ``split``;
// ``whole`` splits of rows_per_split points; ``row`` its first point) at
// ``dst``, reported to ``bar``.
__device__ __forceinline__ void tma_delta(uint32_t dst, const CUtensorMap* maps,
                                          uint32_t bar, int col, int c,
                                          int row, int split, int whole) {
  if (split < whole)
    tma_load_3d(dst, &maps[1], bar, col, c * MR, split);
  else
    tma_load_2d(dst, &maps[2], bar, col, row);
}

// Thread 0: chunk ``c``'s copy into copy area c of its staged operand
// ``op``, reported to rfull(c): one TMA box (STAGE_F32) or one bulk copy of
// the span's 16-byte words (STAGE_SPAN).
__device__ __forceinline__ void issue_raw(const WRingMem& M, int c, int mode,
                                          Operand op,
                                          const CUtensorMap* maps, int k0,
                                          int row, int split, int whole) {
  unsigned char* raw = M.raw(c);
  if (mode == STAGE_F32) {
    mbar_expect_tx(M.rfull(c), MR * MT * 4);
    tma_delta(smem_addr(raw), maps, M.rfull(c), k0, c, row, split, whole);
  } else {
    const uintptr_t first = (uintptr_t)op.p & ~(uintptr_t)15;
    const uintptr_t last = (uintptr_t)(op.p + (op.rows - 1) * op.ld
                                       + op.w * op.es);
    const uint32_t bytes = (uint32_t)((last - first + 15) & ~(uintptr_t)15);
    mbar_expect_tx(M.rfull(c), bytes);
    bulk_load(smem_addr(raw), (const void*)first, bytes, M.rfull(c));
  }
}

// The producer threads (STAGE_ROWS): their 16-byte cp.async copies of the
// words that hold each row of chunk ``c``'s f32 values, row r at RAW_ROW
// r of copy area c, in one cp.async group (an empty one past the split's
// chunks).
__device__ __forceinline__ void copy_rows(const WRingMem& M, int c,
                                          Operand op, bool go) {
  if (go) {
    constexpr int WORDS = RAW_ROW / 16;
    for (int q = threadIdx.x; q < op.rows * WORDS; q += PT) {
      const int r = q / WORDS, j = q % WORDS;
      const uintptr_t at = (uintptr_t)(op.p + r * op.ld);
      const uintptr_t first = at & ~(uintptr_t)15;
      if (first + 16 * j < at + op.w * 4)
        cp_async16(M.raw(c) + r * RAW_ROW + 16 * j,
                   reinterpret_cast<const void*>(first + 16 * j));
    }
  }
  cp_async_commit();
}

// Two f32 values rounded to bf16 (to nearest even), packed low first.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// The column groups of 8 that a staged operand of width w takes, rounded up
// to a power of two: thread t stages group t % groups(w) of rows
// t / groups(w) + (PT / groups(w)) i, so that a narrow operand spreads its
// rows over all the producer threads.
__host__ __device__ constexpr int col_groups(int w) {
  return w > 64 ? 16 : w > 32 ? 8 : w > 16 ? 4 : w > 8 ? 2 : 1;
}

// The producer warpgroup: a staged operand's chunk into the slot ``dst``, 8
// columns (16 bytes) a store (col_groups), rows past the split's end as
// zeros: from its copy area ``raw`` (STAGE_F32: MR x MT f32; STAGE_ROWS:
// each row's words; STAGE_SPAN: the span from the first word of element
// (row0, c0)) or, STAGE_ELEM, from device memory.  With BIAS it adds the unrounded values
// to bsum[0..7] (a delta's bias).
template <bool BIAS>
__device__ __forceinline__ void stage_rows(bf16* dst, const unsigned char* raw,
                                           int mode, Operand op,
                                           float (&bsum)[8]) {
  const int g = col_groups(op.w);
  const int c = 8 * (threadIdx.x % g);
  if (c >= op.w) return;
  const bool grid = mode == STAGE_F32;
  const bool rows = mode == STAGE_ROWS;
  const unsigned char* src = mode == STAGE_ELEM ? op.p
      : grid || rows ? raw : raw + ((uintptr_t)op.p & 15);
  const int64_t ld = grid ? MT * 4 : rows ? RAW_ROW : op.ld;
#pragma unroll 2
  for (int r = threadIdx.x / g; r < MR; r += PT / g) {
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < op.rows) {
      const unsigned char* s = src + r * ld + c * op.es
          + (rows ? (uintptr_t)(op.p + r * op.ld) & 15 : 0);
      if (grid) {
        const float4 x = reinterpret_cast<const float4*>(s)[0];
        const float4 y = reinterpret_cast<const float4*>(s)[1];
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
      } else if (op.es == 4) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < op.w) v[j] = reinterpret_cast<const float*>(s)[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < op.w)
            v[j] = __uint_as_float(
                (uint32_t)reinterpret_cast<const unsigned short*>(s)[j] << 16);
      }
    }
    // no local's address is taken: a local array would go to the stack
    *reinterpret_cast<uint4*>(dst + sw(r, c)) =
        make_uint4(pack_rn(v[0], v[1]), pack_rn(v[2], v[3]),
                   pack_rn(v[4], v[5]), pack_rn(v[6], v[7]));
    if (BIAS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) bsum[j] += v[j];
    }
  }
}

// The producer warpgroup's bias part of a TMA-read delta's chunk ``c`` once
// its slot is full: thread t adds columns 8 (t % 16) .. +7 of rows t / 16 +
// 8 i to bsum, then each warp releases the slot.
__device__ __forceinline__ void bias_chunk(const WRingMem& M, int c,
                                           float (&bsum)[8]) {
  mbar_wait(M.full(c), (c / WSTAGES) & 1);
  const int u = threadIdx.x % 16, r0 = threadIdx.x / 16;   // r0 = row % 8
  const bf16* p = M.d_slot(c) + (u >> 3) * (MR * WATOM) + r0 * WATOM
      + (((u & 7) ^ r0) << 3);
#pragma unroll
  for (int i = 0; i < MR / 8; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + i * 8 * WATOM);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bsum[2 * j] += __uint_as_float(w[j] << 16);
      bsum[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(M.empty(c));
}

// Chunk c's operands (a, d): element (row0, c0) of A and delta, their row
// strides and value sizes, the widths of the tile and the chunk's rows.
// Held and returned by value, so that they stay in registers.
struct ChunkOps {
  const unsigned char *pa, *pd;
  int64_t lda, ldd;                     // bytes
  int64_t lo, hi;
  int wa, wd, des, m0, k0;

  __device__ int rows(int c) const {
    const int64_t row0 = lo + (int64_t)c * MR;
    return (int)(hi - row0 < MR ? hi - row0 : MR);
  }
  __device__ Operand a(int c) const {
    return Operand{pa + (lo + (int64_t)c * MR) * lda, lda, wa, 2, rows(c)};
  }
  __device__ Operand d(int c) const {
    return Operand{pd + (lo + (int64_t)c * MR) * ldd, ldd, wd, des, rows(c)};
  }
};

__device__ __forceinline__ ChunkOps chunk_ops(const WGradJob& jb, int64_t lo,
                                              int64_t hi, int m0, int k0) {
  const int des = jb.delta_f32 ? 4 : 2;
  return ChunkOps{static_cast<const unsigned char*>(jb.a) + m0 * 2,
                  static_cast<const unsigned char*>(jb.delta) + k0 * des,
                  (int64_t)jb.m * 2, jb.ld * des, lo, hi,
                  min(MT, jb.m - m0), min(MT, jb.k - k0), des, m0, k0};
}

// The producer warpgroup's loop over the split's chunks.  Thread 0 refills
// each slot's TMA-read operands once the consumers (and the bias sums) have
// released it.  With staged operands, once a chunk's copies have landed and
// its slot is free, every producer thread stages them into it and fences,
// and each warp arrives on the slot's full barrier; then, once everyone has
// read the copy area (named barrier 1), the copies of the chunk RSLOTS on
// go into it: thread 0's TMA box or bulk copy, or every thread's cp.async
// copies (STAGE_ROWS).  With a TMA-read delta and a bias, every producer
// thread sums each chunk's delta WSTAGES - 1 chunks behind the refills.
__device__ __forceinline__ void wgrad_produce(const WRingMem& M,
                                              const WGradJob& jb,
                                              const CUtensorMap* maps,
                                              const ChunkOps& ops, int chunks,
                                              int split, int whole, bool bias,
                                              float (&bsum)[8]) {
  const bool tma_a = jb.a_mode == STAGE_TMA, tma_d = jb.d_mode == STAGE_TMA;
  const bool staged = !tma_a || !tma_d;
  const bool slot_bias = bias && tma_d;
  const int na = tma_a ? (ops.wa + WATOM - 1) / WATOM : 0;
  const int nd = tma_d ? (ops.wd + WATOM - 1) / WATOM : 0;
  // the operand that the copy areas take, if one does: A's span, or delta
  const bool raw_a = jb.a_mode == STAGE_SPAN;
  const int rmode = raw_a ? jb.a_mode : jb.d_mode;
  const bool raw = raw_a || (jb.d_mode != STAGE_TMA && jb.d_mode != STAGE_ELEM);
  const bool rows = rmode == STAGE_ROWS;
  const bool fills = staged || threadIdx.x == 0;
  if (!fills && !slot_bias) return;
  // chunk c's copies (STAGE_ROWS: one cp.async group a chunk, empty past
  // the split's chunks)
  auto issue = [&](int c) {
    if (rows)
      copy_rows(M, c, ops.d(c), c < chunks);
    else if (threadIdx.x == 0 && c < chunks)
      issue_raw(M, c, rmode, raw_a ? ops.a(c) : ops.d(c), maps, ops.k0,
                (int)(ops.lo + (int64_t)c * MR), split, whole);
  };
  if (threadIdx.x == 0 && chunks > 0) {     // no maps without points
    if (tma_a) prefetch_tensormap(&maps[0]);
    if (tma_d || jb.d_mode == STAGE_F32) {
      prefetch_tensormap(&maps[2]);
      if (whole > 0) prefetch_tensormap(&maps[1]);
    }
  }
  if (raw)
    for (int c = 0; c < RSLOTS; ++c) issue(c);
  for (int c = 0; c < chunks + WSTAGES - 1; ++c) {
    if (c < chunks && fills) {
      if (rows) {
        cp_async_wait<RSLOTS - 1>();    // this thread's copies of chunk c
        bar_sync(1, PT);                // everyone's
      } else if (raw) {
        mbar_wait(M.rfull(c), (c / RSLOTS) & 1);
      }
      if (c >= WSTAGES) mbar_wait(M.empty(c), (c / WSTAGES - 1) & 1);
      if (threadIdx.x == 0 && na + nd > 0) {
        const int row = (int)(ops.lo + (int64_t)c * MR);
        mbar_expect_tx(M.full(c), (na + nd) * ATOM_BYTES);
        const uint32_t as = smem_addr(M.a_slot(c)), ds = smem_addr(M.d_slot(c));
        for (int b = 0; b < na; ++b)
          tma_load_2d(as + b * ATOM_BYTES, &maps[0], M.full(c),
                      ops.m0 + b * WATOM, row);
        for (int b = 0; b < nd; ++b)
          tma_delta(ds + b * ATOM_BYTES, maps, M.full(c), ops.k0 + b * WATOM,
                    c, row, split, whole);
      }
      if (staged) {
        if (!tma_a)
          stage_rows<false>(M.a_slot(c), M.raw(c), jb.a_mode, ops.a(c), bsum);
        if (!tma_d) {
          if (bias)
            stage_rows<true>(M.d_slot(c), M.raw(c), jb.d_mode, ops.d(c),
                             bsum);
          else
            stage_rows<false>(M.d_slot(c), M.raw(c), jb.d_mode, ops.d(c),
                              bsum);
        }
        fence_proxy_async();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(M.full(c));
        if (raw) {
          bar_sync(1, PT);              // copy area c is read
          issue(c + RSLOTS);
        }
      }
    }
    if (slot_bias && c >= WSTAGES - 1) bias_chunk(M, c - (WSTAGES - 1), bsum);
  }
}

// A consumer warpgroup's part: the products of every chunk's k-steps, in
// order, into its 64 rows (consumer wg: rows m0 + 64 wg ..) of the tile's
// two halves of 64 columns, each warp releasing a slot once its products
// are done; then the split's sums to the partial.  A k-step's product of
// each half is summed from zero (scale-d 0) into ``part`` and added to acc
// once it is done.
__device__ __forceinline__ void wgrad_consume(const WRingMem& M,
                                              const WGradJob& jb, int chunks,
                                              int wg, int m0, int k0,
                                              int split, bool round_partial) {
  const bool on = jb.m - m0 > WATOM * wg;
  const int halves = jb.k - k0 > WATOM ? 2 : 1;
  float acc[2][32] = {};
  float part[32];
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(M.full(c), (c / WSTAGES) & 1);
    if (on) {
      const uint32_t a = smem_addr(M.a_slot(c)) + wg * ATOM_BYTES;
      const uint32_t d = smem_addr(M.d_slot(c));
#pragma unroll
      for (int s = 0; s < MR / 16; ++s) {
        const uint32_t ks = s * 16 * WATOM * 2;   // the k-step's 16 rows
        const uint64_t da = wgmma_desc_sw128(a + ks, ATOM_BYTES,
                                             8 * WATOM * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < halves) {
            wgmma_fence();
            wgmma_ss<1, 1>(part, da,
                           wgmma_desc_sw128(d + ks + h * ATOM_BYTES,
                                            ATOM_BYTES, 8 * WATOM * 2), 0);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_hold(part);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[h][e] += part[e];
          }
        }
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(M.empty(c));
  }
  if (!on) return;
  // acc[h][4 t + e]: row g (e < 2) or g + 8 of the warp's 16, column
  // 8 t + 2 q + (e & 1) of half h
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= halves) continue;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int mm = m0 + WATOM * wg + 16 * w + g + ((e >> 1) & 1) * 8;
      const int kk = k0 + WATOM * h + 8 * (e >> 2) + 2 * q + (e & 1);
      if (mm < jb.m && kk < jb.k) {
        const float v = acc[h][e];
        jb.partial[((int64_t)split * jb.m + mm) * jb.k + kk] =
            round_partial ? to_f(from_f<bf16>(v)) : v;
      }
    }
  }
}

// T is bf16: a template, so that only the libraries that launch it compile it
template <typename T>
__global__ void __launch_bounds__(WTHREADS, 1)
wgrad_mma_kernel(WGradJobs jobs, const __grid_constant__ WGradMaps maps,
                 int64_t n, int64_t rows_per_split, bool round_partial) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core body is bf16");
  extern __shared__ __align__(1024) unsigned char wgrad_smem[];
  WRingMem M;
  {
    const uint32_t at = smem_addr(wgrad_smem);
    M.base = wgrad_smem + (((at + 1023) & ~1023u) - at);
  }
  int jx = 0;
  while (jx + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jx + 1].tile_begin)
    ++jx;
  const WGradJob jb = jobs.job[jx];      // in registers
  const int tile = blockIdx.x - jb.tile_begin;
  const int m0 = (tile / jb.tiles_k) * MT, k0 = (tile % jb.tiles_k) * MT;
  const int split = blockIdx.y;
  const int64_t lo = (int64_t)split * rows_per_split;
  const int64_t hi = lo + rows_per_split < n ? lo + rows_per_split : n;
  const int chunks = hi > lo ? (int)((hi - lo + MR - 1) / MR) : 0;
  const int whole = (int)(n / rows_per_split);
  const bool bias = jb.bias_partial != nullptr && m0 == 0;
  const bool tma = jb.a_mode == STAGE_TMA || jb.d_mode == STAGE_TMA;
  const bool staged = jb.a_mode != STAGE_TMA || jb.d_mode != STAGE_TMA;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(M.full(s), staged ? PT / 32 + (tma ? 1 : 0) : 1);
      mbar_init(M.empty(s), 2 * PT / 32
                + (bias && jb.d_mode == STAGE_TMA ? PT / 32 : 0));
    }
    for (int s = 0; s < RSLOTS; ++s) mbar_init(M.rfull(s), 1);
    fence_mbar_init();
  }
  __syncthreads();

  const ChunkOps ops = chunk_ops(jb, lo, hi, m0, k0);
  float bsum[8] = {};      // the producer threads' bias partials
  if (threadIdx.x < PT)
    wgrad_produce(M, jb, &maps.map[3 * jx], ops, chunks, split, whole, bias,
                  bsum);
  else
    wgrad_consume(M, jb, chunks, (int)(threadIdx.x / PT) - 1, m0, k0, split,
                  round_partial);
  if (bias) {
    // the producer threads' sums over their rows of the chunks (columns
    // 8 (t % g) .. +7, group t / g: bias_chunk's 16 column groups, or the
    // staged delta's col_groups), the groups added in a fixed order
    __syncthreads();                // the ring is free
    const int g = jb.d_mode == STAGE_TMA ? 16 : col_groups(ops.wd);
    float* red = reinterpret_cast<float*>(M.base);   // [PT / g][MT]
    if (threadIdx.x < PT && (int)(threadIdx.x % g) * 8 < MT) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(threadIdx.x / g) * MT + (threadIdx.x % g) * 8 + j] = bsum[j];
    }
    __syncthreads();
    const int col = threadIdx.x;
    if (col < MT && k0 + col < jb.k) {
      float s = 0.f;
      for (int i = 0; i < PT / g; ++i) s += red[i * MT + col];
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
// elements apart (STAGE_*), from its type, alignment and row stride; A
// (``delta_mode``: delta's) is loaded as it is staged where delta takes the
// copy areas.
inline int stage_mode(const void* p, int64_t ld, bool f32,
                      int delta_mode = STAGE_TMA) {
  const bool rows16 = (uintptr_t)p % 16 == 0 && ld % (f32 ? 4 : 8) == 0;
  if (rows16) return f32 ? STAGE_F32 : STAGE_TMA;
  if (delta_mode != STAGE_TMA && delta_mode != STAGE_ELEM) return STAGE_ELEM;
  if (ld <= (f32 ? SPAN_LD / 2 : SPAN_LD)) return STAGE_SPAN;
  return f32 ? STAGE_ROWS : STAGE_ELEM;
}

// One weight-grad job: grad index wi = A^T delta (m x k), bias index bi
// (-1: none); delta's rows are ld apart (0: k, a contiguous (n, k) array).
// ``tiles`` counts the f32 body's WT x WT output tiles; the bf16 body plans
// its own (plan_mma_tiles).  a_mode and d_mode: how the bf16 body stages
// the operand, from its type, alignment and row stride.
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
  j.d_mode = stage_mode(delta, j.ld, delta_f32);
  j.a_mode = stage_mode(a, m, false, j.d_mode);
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

// An (cols, rows) array of row stride ld (elements) for TMA boxes of MR
// rows: bf16 in boxes of 64 columns in the 128-byte swizzle, or f32 in
// boxes of MT columns unswizzled; with ``splits`` > 0 the rows as
// (rows_per_split, splits), ``rows`` = rows_per_split (the 3-d map).  Rows
// and columns past the array read as zeros.  Returns 0 or a CUDA error
// code.
inline int chunk_map(CUtensorMap* out, const void* p, bool f32, int cols,
                     int64_t rows, int64_t ld, int splits = 0) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const size_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)splits};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * es,
                                 (cuuint64_t)(ld * rows) * es};
  const cuuint32_t box[3] = {f32 ? (cuuint32_t)MT : (cuuint32_t)WATOM, MR, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(out, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                splits > 0 ? 3 : 2, const_cast<void*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
      ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of the jobs' TMA-read operands over n points (WGradMaps).
inline int wgrad_maps(WGradMaps* maps, const WGradJobs& jobs, int64_t n,
                      int64_t rows_per_split) {
  if (n < 1) return 0;                  // no chunk reads them
  const int64_t whole = n / rows_per_split;
  for (int i = 0; i < jobs.n_jobs; ++i) {
    const WGradJob& j = jobs.job[i];
    CUtensorMap* m = &maps->map[3 * i];
    int err = j.a_mode == STAGE_TMA
        ? chunk_map(m, j.a, false, j.m, n, j.m) : 0;
    if (err == 0 && (j.d_mode == STAGE_TMA || j.d_mode == STAGE_F32)) {
      const bool f32 = j.d_mode == STAGE_F32;
      err = chunk_map(m + 2, j.delta, f32, j.k, n, j.ld);
      if (err == 0 && whole > 0)
        err = chunk_map(m + 1, j.delta, f32, j.k, rows_per_split, j.ld,
                        (int)whole);
    }
    if (err != 0) return err;
  }
  return 0;
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
    WGradMaps maps;
    err = wgrad_maps(&maps, mj, n, rows_per_split);
    if (err != 0) return err;
    err = set_smem(wgrad_mma_kernel<T>, WSMEM, "wgrad_mma_kernel", 1,
                   WTHREADS);
    if (err != 0) return err;
    wgrad_mma_kernel<T><<<dim3((unsigned)mtiles, (unsigned)splits), WTHREADS,
                          WSMEM, stream>>>(mj, maps, n, rows_per_split,
                                           round_partial);
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
