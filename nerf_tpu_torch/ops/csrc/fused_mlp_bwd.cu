// Fused MLP backward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU backward kernels of nerf_tpu/ops/fused_mlp.py:
//   vanilla_mlp_bwd <- _vanilla_bwd_res_kernel (:163) with _vanilla_bwd_math
//                      (:195): the store_residuals=True backward, over the 9
//                      activations that vanilla_mlp_fwd_res stored
//   prop_mlp_bwd    <- _prop_bwd_kernel (:493) with _prop_bwd_math (:506):
//                      the recompute backward (prop_store_residuals=False),
//                      which rebuilds h1..h4 inside the tile
// Both return the f32 weight and bias grads in the shapes of the weight tuple;
// the input cotangents are zero by construction (fused_mlp.py:14-19) and are
// not computed.
//
// The TPU kernels zero the grads at program 0 and then `+=` each tile's
// partial into them (fused_mlp.py:172-175, :511-514): race-free only because
// a TPU grid runs in order.  Blocks on a GPU run at the same time, and a
// per-block copy of all grads (2.2 MB of f32 for the vanilla net) times
// thousands of tiles does not fit.  So each backward is three launches, all
// deterministic:
//   1. a per-tile delta pass: the chain rule of _vanilla_bwd_math /
//      _prop_bwd_math in shared memory, with the ReLU masks read from the
//      stored (or recomputed) activations (act > 0); every layer's delta is
//      written to device memory in T (dbvec also in f32, for dbb);
//   2. a split-K weight-grad pass, dW = A^T delta and db = column sums of the
//      delta over the points: one block per (64 x 64 output tile, K-split),
//      f32 accumulation, one partial per K-split;
//   3. a reduction that sums the partials of every grad in a fixed order.
// The dtype steps follow _vanilla_bwd_math exactly: deltas cast to T per
// layer; dbvec kept in f32 for dbb and cast to T for dwb and dz7; dz7 adds the
// f32 sigma term before its mask; dbr2 sums the T-valued dlogit3 in f32.
//
// Bound on an H100 SXM (700 W), bf16 tensor-core peak 989 TFLOP/s:
// vanilla 527,872 weight-grad MACs plus 492,160 delta MACs per point, 0.27 ms
// at N = 131,072; proposal (recompute) 622,848 MACs per point, 0.08 ms at
// N = 65,536.  Both are bound by operations.  This first version multiplies
// on the CUDA cores in f32 and pays the delta round trip through device
// memory; tensor cores and fusing the weight-grad products into the delta
// pass are later work.

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

// delta = mask(act) (a @ W^T [+ gs[row] * wcol[c]]) for the whole tile, where
// W is the layer's (n_out, k_dim) = (in, out) forward matrix, a the next
// layer's (TM, k_dim) delta in shared memory, act the stored (n, n_out)
// activation in device memory (null: no ReLU), and gs/wcol an optional K = 1
// outer-product term added in f32 before the mask.  The result goes to
// shared memory in T (the operand of the next product) and its valid rows to
// gout, in OutT (T, or f32 for dbvec).  ``stage`` is the shared-memory
// stage of accumulate_t; every thread of the block must call this.
template <typename T, typename OutT>
__device__ void delta_tile(const T* a, int k_dim, const T* __restrict__ w,
                           int n_out, const T* __restrict__ act,
                           const T* gs, const T* __restrict__ wcol, T* out,
                           OutT* __restrict__ gout, int64_t row0, int64_t n,
                           T* stage) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
  for (int c0 = 0; c0 < n_out; c0 += CHUNK) {
    float acc[RPT][CPT];
    zero(acc);
    accumulate_t(acc, a, k_dim, w, n_out, c0, stage);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c >= n_out) continue;
      const float wc = wcol != nullptr ? to_f(wcol[c]) : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int t = r0 + i;
        const int64_t row = row0 + t;
        float v = acc[i][j];
        if (wcol != nullptr) v += to_f(gs[t]) * wc;
        if (act != nullptr)
          v = (row < n && to_f(act[row * n_out + c]) > 0.f) ? v : 0.f;
        out[t * n_out + c] = from_f<T>(v);
        if (row < n) gout[row * n_out + c] = from_f<OutT>(v);
      }
    }
  }
}

// The delta arrays of the vanilla backward, each (n, width) row-major.
template <typename T>
struct VanillaDeltas {
  T* dlogit;     // (n, 3)  the rgb-logit delta, T
  T* gsig;       // (n, 1)  g_sigma cast to T
  T* dr1;        // (n, R)
  float* dbvec;  // (n, B)  f32
  T *dz7, *dz6, *dz5, *dh4, *dh3, *dh2, *dh1;
};

template <typename T>
struct VanillaActs {
  const T *h1, *h2, *h3, *h4, *z5, *z6, *z7, *bvec, *r1;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
vanilla_delta_kernel(VanillaWeights<T> p, VanillaActs<T> s,
                     const float* __restrict__ grgb,
                     const float* __restrict__ gsig,
                     const float* __restrict__ rgb3, VanillaDeltas<T> o,
                     int64_t n, int h, int bn, int r, int maxw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* dl = reinterpret_cast<T*>(smem);     // (TM, 3) dlogit
  T* gs = dl + TM * 4;                    // (TM,) g_sigma in T
  T* buf_a = gs + TM * 4;
  T* buf_b = buf_a + TM * maxw;
  T* st = buf_b + TM * maxw;              // the W^T stage
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  // row-land sigmoid backward (fused_mlp.py:201): grgb and rgb3 are (3, n)
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const int t = idx / 3, j = idx - 3 * t;
    const int64_t row = row0 + t;
    float v = 0.f;
    if (row < n) {
      const float y = rgb3[j * n + row];
      v = grgb[j * n + row] * y * (1.f - y);
    }
    dl[t * 3 + j] = from_f<T>(v);
    if (row < n) o.dlogit[row * 3 + j] = from_f<T>(v);
  }
  for (int t = threadIdx.x; t < TM; t += THREADS) {
    const int64_t row = row0 + t;
    gs[t] = from_f<T>(row < n ? gsig[row] : 0.f);
    if (row < n) o.gsig[row] = gs[t];
  }
  __syncthreads();
  delta_tile(dl, 3, p.wr2, r, s.r1, none, none, buf_a, o.dr1, row0, n, st);        // dr1
  __syncthreads();
  delta_tile(buf_a, r, p.wr1a, bn, none, none, none, buf_b, o.dbvec, row0, n, st); // dbvec
  __syncthreads();
  delta_tile(buf_b, bn, p.wb, bn, s.z7, gs, p.wsig, buf_a, o.dz7, row0, n, st);    // dz7
  __syncthreads();
  delta_tile(buf_a, bn, p.w6, h, s.z6, none, none, buf_b, o.dz6, row0, n, st);     // dz6
  __syncthreads();
  delta_tile(buf_b, h, p.w5, h, s.z5, none, none, buf_a, o.dz5, row0, n, st);      // dz5
  __syncthreads();
  delta_tile(buf_a, h, p.w4b, h, s.h4, none, none, buf_b, o.dh4, row0, n, st);     // dh4
  __syncthreads();
  delta_tile(buf_b, h, p.w3, h, s.h3, none, none, buf_a, o.dh3, row0, n, st);      // dh3
  __syncthreads();
  delta_tile(buf_a, h, p.w2, h, s.h2, none, none, buf_b, o.dh2, row0, n, st);      // dh2
  __syncthreads();
  delta_tile(buf_b, h, p.w1, h, s.h1, none, none, buf_a, o.dh1, row0, n, st);      // dh1
}

// The proposal backward's delta pass: the forward recomputed in the tile
// (h1..h4 written to device memory for the weight-grad pass), then the chain
// rule.  hs: 4 consecutive (n, h) arrays h1..h4; go: (n, 1) g cast to T;
// dhs: 4 consecutive (n, h) arrays dh1..dh4.
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
prop_delta_kernel(const T* __restrict__ x, PropWeights<T> p,
                  const float* __restrict__ g, int64_t n, int dx, int h,
                  T* __restrict__ hs, T* __restrict__ go,
                  T* __restrict__ dhs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);     // (TM,) g in T
  T* xs = gs + TM * 4;
  T* buf_a = xs + TM * dx;
  T* buf_b = buf_a + TM * h;
  T* st = buf_b + TM * h;                 // the W^T stage
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t nh = n * h;
  load_rows(x, dx, row0, n, xs);
  for (int t = threadIdx.x; t < TM; t += THREADS) {
    const int64_t row = row0 + t;
    gs[t] = from_f<T>(row < n ? g[row] : 0.f);
    if (row < n) go[row] = gs[t];
  }
  __syncthreads();
  dense_tile<true>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, hs, row0, n);
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, hs + nh, row0, n);
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, hs + 2 * nh, row0, n);
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, hs + 3 * nh, row0, n);
  __syncthreads();   // also makes the stored h1..h4 visible to the block
  // dh4 = mask(h4) (go (x) wo): a K = 1 product, no delta operand
  delta_tile(none, 0, none, h, hs + 3 * nh, gs, p.wo, buf_a, dhs + 3 * nh, row0, n, st);
  __syncthreads();
  delta_tile(buf_a, h, p.w3, h, hs + 2 * nh, none, none, buf_b, dhs + 2 * nh, row0, n, st);
  __syncthreads();
  delta_tile(buf_b, h, p.w2, h, hs + nh, none, none, buf_a, dhs + nh, row0, n, st);
  __syncthreads();
  delta_tile(buf_a, h, p.w1, h, hs, none, none, buf_b, dhs, row0, n, st);
}

// ---------------------------------------------------------------------------
// split-K weight grads
// ---------------------------------------------------------------------------

constexpr int WT = 64;        // output tile is WT x WT of dW (m x k)
constexpr int WR = 32;        // points per staged chunk
constexpr int MAX_JOBS = 16;

// dW (m, k) = A^T delta over the points of one K-split, and, with
// bias_partial, db (k) = the column sums of delta.  A is (n, m) in T; delta is
// (n, k) in T or f32 (then rounded to T for the product, and summed unrounded
// for the bias).  partial: (splits, m, k); bias_partial: (splits, k).
struct WGradJob {
  const void* a;
  const void* delta;
  float* partial;
  float* bias_partial;
  int m, k, delta_f32, tiles_k, tile_begin;
};

struct WGradJobs {
  WGradJob job[MAX_JOBS];
  int n_jobs;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(WGradJobs jobs, int64_t n, int64_t rows_per_split) {
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
        const int64_t at = row * jb.k + k0 + cc;
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
        jb.partial[((int64_t)split * jb.m + mm) * jb.k + kk] = acc[i][j];
    }
  }
  if (bias && threadIdx.x < WT && k0 + (int)threadIdx.x < jb.k)
    jb.bias_partial[(int64_t)split * jb.k + k0 + threadIdx.x] = bacc;
}

// out[e] = sum over splits s = 0, 1, ... of partial[s * count + e], for every
// grad; one thread per output element, the splits summed in order.
constexpr int MAX_GRADS = 24;

struct ReduceJobs {
  const float* partial[MAX_GRADS];
  float* out[MAX_GRADS];
  int64_t begin[MAX_GRADS + 1];   // prefix sums of the grads' sizes
  int n_grads;
};

__global__ void __launch_bounds__(THREADS)
reduce_kernel(ReduceJobs jobs, int splits) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= jobs.begin[jobs.n_grads]) return;
  int gx = 0;
  while (idx >= jobs.begin[gx + 1]) ++gx;
  const int64_t count = jobs.begin[gx + 1] - jobs.begin[gx];
  const int64_t e = idx - jobs.begin[gx];
  const float* src = jobs.partial[gx];
  float s = 0.f;
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

GradPlan plan_grads(const int64_t* sizes, int n_grads, int splits) {
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
// (-1: none).
void add_job(WGradJobs& jobs, int& tiles, const GradPlan& g, float* partial,
             const void* a, int m, const void* delta, int k, bool delta_f32,
             int wi, int bi) {
  WGradJob& j = jobs.job[jobs.n_jobs++];
  j.a = a;
  j.delta = delta;
  j.m = m;
  j.k = k;
  j.delta_f32 = delta_f32 ? 1 : 0;
  j.partial = partial + g.offset[wi];
  j.bias_partial = bi >= 0 ? partial + g.offset[bi] : nullptr;
  j.tiles_k = (k + WT - 1) / WT;
  j.tile_begin = tiles;
  tiles += ((m + WT - 1) / WT) * j.tiles_k;
}

template <typename T>
int launch_wgrad_reduce(const WGradJobs& jobs, int tiles, const GradPlan& g,
                        float* partial, const uint64_t* grads, int64_t n,
                        int splits, cudaStream_t stream) {
  const int64_t rps = (n + splits - 1) / splits;
  wgrad_kernel<T><<<dim3((unsigned)tiles, (unsigned)splits), THREADS, 0,
                    stream>>>(jobs, n, rps);
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
  reduce_kernel<<<blocks, THREADS, 0, stream>>>(rj, splits);
  return (int)cudaGetLastError();
}

// vanilla: acts (9 pointers, h1 h2 h3 h4 z5 z6 z7 bvec r1), deltas (11
// pointers, dlogit gsig dr1 dbvec dz7 dz6 dz5 dh4 dh3 dh2 dh1), grads (24 f32
// outputs in the order of the weight tuple), partial (splits x 527,872 floats
// at the default widths).
template <typename T>
int launch_vanilla_bwd(const void* x, const void* d, const float* grgb,
                       const float* gsig, const float* rgb3,
                       const uint64_t* acts, const uint64_t* ptrs, int64_t n,
                       const int* dims, const uint64_t* deltas, float* partial,
                       int splits, const uint64_t* grads,
                       cudaStream_t stream) {
  const VanillaWeights<T> p = vanilla_weights<T>(ptrs);
  VanillaActs<T> s;
  s.h1 = (const T*)acts[0]; s.h2 = (const T*)acts[1];
  s.h3 = (const T*)acts[2]; s.h4 = (const T*)acts[3];
  s.z5 = (const T*)acts[4]; s.z6 = (const T*)acts[5];
  s.z7 = (const T*)acts[6]; s.bvec = (const T*)acts[7];
  s.r1 = (const T*)acts[8];
  VanillaDeltas<T> o;
  o.dlogit = (T*)deltas[0]; o.gsig = (T*)deltas[1]; o.dr1 = (T*)deltas[2];
  o.dbvec = (float*)deltas[3]; o.dz7 = (T*)deltas[4]; o.dz6 = (T*)deltas[5];
  o.dz5 = (T*)deltas[6]; o.dh4 = (T*)deltas[7]; o.dh3 = (T*)deltas[8];
  o.dh2 = (T*)deltas[9]; o.dh1 = (T*)deltas[10];
  const int dx = dims[0], dd = dims[1], h = dims[2], bn = dims[3], r = dims[4];
  int maxw = h > bn ? h : bn;
  maxw = maxw > r ? maxw : r;
  const size_t smem =
      ((size_t)TM * (8 + 2 * maxw) + KC * stage_ld<T>()) * sizeof(T);
  int err = set_smem(vanilla_delta_kernel<T>, smem);
  if (err != 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  if (n > 0) {
    vanilla_delta_kernel<T><<<grid, THREADS, smem, stream>>>(
        p, s, grgb, gsig, rgb3, o, n, h, bn, r, maxw);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int64_t sizes[24] = {
      (int64_t)dx * h, h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * h, h, (int64_t)dx * h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * bn, bn, bn, 1, (int64_t)bn * bn, bn, (int64_t)bn * r,
      (int64_t)dd * r, r, (int64_t)r * 3, 3};
  const GradPlan g = plan_grads(sizes, 24, splits);
  WGradJobs jobs;
  jobs.n_jobs = 0;
  int tiles = 0;
  add_job(jobs, tiles, g, partial, x, dx, o.dh1, h, false, 0, 1);
  add_job(jobs, tiles, g, partial, s.h1, h, o.dh2, h, false, 2, 3);
  add_job(jobs, tiles, g, partial, s.h2, h, o.dh3, h, false, 4, 5);
  add_job(jobs, tiles, g, partial, s.h3, h, o.dh4, h, false, 6, 7);
  add_job(jobs, tiles, g, partial, x, dx, o.dz5, h, false, 8, -1);
  add_job(jobs, tiles, g, partial, s.h4, h, o.dz5, h, false, 9, 10);
  add_job(jobs, tiles, g, partial, s.z5, h, o.dz6, h, false, 11, 12);
  add_job(jobs, tiles, g, partial, s.z6, h, o.dz7, bn, false, 13, 14);
  add_job(jobs, tiles, g, partial, s.z7, bn, o.gsig, 1, false, 15, 16);
  add_job(jobs, tiles, g, partial, s.z7, bn, o.dbvec, bn, true, 17, 18);
  add_job(jobs, tiles, g, partial, s.bvec, bn, o.dr1, r, false, 19, -1);
  add_job(jobs, tiles, g, partial, d, dd, o.dr1, r, false, 20, 21);
  add_job(jobs, tiles, g, partial, s.r1, r, o.dlogit, 3, false, 22, 23);
  return launch_wgrad_reduce<T>(jobs, tiles, g, partial, grads, n, splits,
                                stream);
}

// prop: hs (4 (n, h) arrays), go ((n,) T), dhs (4 (n, h) arrays) are scratch
// from the caller; grads (10 f32 outputs in the order of the weight tuple),
// partial (splits x 212,992 floats at the default widths).
template <typename T>
int launch_prop_bwd(const void* x, const float* g_out, const uint64_t* ptrs,
                    int64_t n, int dx, int h, void* hs, void* go, void* dhs,
                    float* partial, int splits, const uint64_t* grads,
                    cudaStream_t stream) {
  const PropWeights<T> p = prop_weights<T>(ptrs);
  const size_t smem =
      ((size_t)TM * (4 + dx + 2 * h) + KC * stage_ld<T>()) * sizeof(T);
  int err = set_smem(prop_delta_kernel<T>, smem);
  if (err != 0) return err;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + TM - 1) / TM);
    prop_delta_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const T*)x, p, g_out, n, dx, h, (T*)hs, (T*)go, (T*)dhs);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const T* hv = (const T*)hs;
  const T* dv = (const T*)dhs;
  const int64_t nh = n * h;
  const int64_t sizes[10] = {(int64_t)dx * h, h, (int64_t)h * h, h,
                             (int64_t)h * h, h, (int64_t)h * h, h, h, 1};
  const GradPlan g = plan_grads(sizes, 10, splits);
  WGradJobs jobs;
  jobs.n_jobs = 0;
  int tiles = 0;
  add_job(jobs, tiles, g, partial, x, dx, dv, h, false, 0, 1);
  add_job(jobs, tiles, g, partial, hv, h, dv + nh, h, false, 2, 3);
  add_job(jobs, tiles, g, partial, hv + nh, h, dv + 2 * nh, h, false, 4, 5);
  add_job(jobs, tiles, g, partial, hv + 2 * nh, h, dv + 3 * nh, h, false, 6, 7);
  add_job(jobs, tiles, g, partial, hv + 3 * nh, h, go, 1, false, 8, 9);
  return launch_wgrad_reduce<T>(jobs, tiles, g, partial, grads, n, splits,
                                stream);
}

}  // namespace

extern "C" {

#define VANILLA_BWD(SUFFIX, T)                                                 \
  int vanilla_mlp_bwd_##SUFFIX(                                                \
      const void* x, const void* d, const void* grgb, const void* gsig,        \
      const void* rgb3, const uint64_t* acts, const uint64_t* ptrs, int64_t n, \
      const int* dims, const uint64_t* deltas, void* partial, int splits,      \
      const uint64_t* grads, void* stream) {                                   \
    return launch_vanilla_bwd<T>(                                              \
        x, d, (const float*)grgb, (const float*)gsig, (const float*)rgb3,      \
        acts, ptrs, n, dims, deltas, (float*)partial, splits, grads,           \
        (cudaStream_t)stream);                                                 \
  }

#define PROP_BWD(SUFFIX, T)                                                    \
  int prop_mlp_bwd_##SUFFIX(const void* x, const void* g,                      \
                            const uint64_t* ptrs, int64_t n, int dx, int h,    \
                            void* hs, void* go, void* dhs, void* partial,      \
                            int splits, const uint64_t* grads, void* stream) { \
    return launch_prop_bwd<T>(x, (const float*)g, ptrs, n, dx, h, hs, go, dhs, \
                              (float*)partial, splits, grads,                  \
                              (cudaStream_t)stream);                           \
  }

VANILLA_BWD(f32, float)
VANILLA_BWD(bf16, __nv_bfloat16)
PROP_BWD(f32, float)
PROP_BWD(bf16, __nv_bfloat16)

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
