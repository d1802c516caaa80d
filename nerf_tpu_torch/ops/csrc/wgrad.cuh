// Split-K weight grads and their ordered reduction, shared by the backward
// kernels (fused_mlp_bwd.cu, fused_mlp_recompute.cu, ref_fused_bwd.cu,
// ref_dir.cuh).
//
// A TPU backward zeroes its grads at grid step 0 and adds each tile's partial
// into them, in grid order.  GPU blocks run at the same time, so a backward
// here writes each layer's delta to device memory, then one launch computes
// dW = A^T delta and the bias sums for every (64 x 64 output tile, K-split)
// into per-split partials, and a second sums the partials of every grad in a
// fixed order: deterministic, no atomics.

#pragma once

#include "mlp_tile.cuh"

// In a top-level unnamed namespace: each library that includes this keeps
// its own copy (nvcc cannot emit the host stubs of a __global__ template in
// an unnamed namespace nested in a named one).
namespace {

using namespace mlp;

constexpr int WT = 64;        // output tile is WT x WT of dW (m x k)
constexpr int WR = 32;        // points per staged chunk
constexpr int MAX_JOBS = 16;

// dW (m, k) = A^T delta over the points of one K-split, and, with
// bias_partial, db (k) = the column sums of delta.  A is (n, m) in T; delta is
// (n, k) in T or f32 (then rounded to T for the product, and summed unrounded
// for the bias), its rows ld elements apart.  partial: (splits, m, k);
// bias_partial: (splits, k).
struct WGradJob {
  const void* a;
  const void* delta;
  float* partial;
  float* bias_partial;
  int64_t ld;
  int m, k, delta_f32, tiles_k, tile_begin;
};

struct WGradJobs {
  WGradJob job[MAX_JOBS];
  int n_jobs;
};

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

// One weight-grad job: grad index wi = A^T delta (m x k), bias index bi
// (-1: none); delta's rows are ld apart (0: k, a contiguous (n, k) array).
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
}

// rows_per_split: the points of each K-split; round_partial: round each
// split's weight grad (not the bias sums) to T before the reduction;
// accumulate: add the splits' sum to what grads hold (reduce_kernel).
template <typename T>
int launch_wgrad_reduce(const WGradJobs& jobs, int tiles, const GradPlan& g,
                        float* partial, const uint64_t* grads, int64_t n,
                        int splits, int64_t rows_per_split,
                        bool round_partial, cudaStream_t stream,
                        bool accumulate = false) {
  wgrad_kernel<T><<<dim3((unsigned)tiles, (unsigned)splits), THREADS, 0,
                    stream>>>(jobs, n, rows_per_split, round_partial);
  int err = (int)cudaGetLastError();
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
