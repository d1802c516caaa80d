// Fused MLP backward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU backward kernels of nerf_tpu/ops/fused_mlp.py:
//   vanilla_mlp_bwd <- _vanilla_bwd_res_kernel (:163) with _vanilla_bwd_math
//                      (:195): the store_residuals=True backward, over the 9
//                      activations that vanilla_mlp_fwd_res stored
//   prop_mlp_bwd    <- _prop_bwd_kernel (:493) with _prop_bwd_math (:506):
//                      the recompute backward (prop_store_residuals=False),
//                      which rebuilds h1..h4 inside the tile
//   prop_mlp_bwd_res <- _prop_bwd_res_kernel (:499) with _prop_bwd_math: the
//                      backward of prop_store_residuals=True, over the h1..h4
//                      that prop_mlp_fwd_res stored; the same delta pass
//                      without the rebuild, so its grads equal
//                      prop_mlp_bwd's bit for bit on the same operands
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
// N = 65,536, and 409,856 without the rebuild (res), 0.05 ms.  All are bound
// by operations.  The proposal backwards walk the points in chunks of whole
// K-splits (launch_prop_bwd), so their deltas (and the rebuilt activations)
// take scratch of one chunk, not of all N points.  This first version multiplies
// on the CUDA cores in f32 and pays the delta round trip through device
// memory; tensor cores and fusing the weight-grad products into the delta
// pass are later work.

#include "mlp_tile.cuh"
#include "wgrad.cuh"

namespace {

using namespace mlp;

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

// The proposal net's h1..h4 (or their deltas), (n, h) each.
template <typename T>
struct PropHs {
  T* a[4];
};

// The proposal backward's delta pass over one chunk of n rows.  With REBUILD
// (prop_mlp_bwd) the forward is recomputed in the tile, as
// prop_mlp_fwd_kernel runs it, and h1..h4 are written to hs, the chunk's
// scratch; without (prop_mlp_bwd_res) hs are the chunk's rows of the stored
// activations and only read.  Then the chain rule, the ReLU masks read from
// hs.  x: the chunk's encoding rows (REBUILD only); g: its cotangent; go:
// (n,) g cast to T; dhs: dh1..dh4.
template <bool REBUILD, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
prop_delta_kernel(const T* __restrict__ x, PropWeights<T> p,
                  const float* __restrict__ g, int64_t n, int dx, int h,
                  PropHs<T> hs, T* __restrict__ go, PropHs<T> dhs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);     // (TM,) g in T
  T* xs = gs + TM * 4;                    // (TM, dx), REBUILD only
  T* buf_a = xs + (REBUILD ? TM * dx : 0);
  T* buf_b = buf_a + TM * h;
  T* st = buf_b + TM * h;                 // the W^T stage
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  if (REBUILD) load_rows(x, dx, row0, n, xs);
  for (int t = threadIdx.x; t < TM; t += THREADS) {
    const int64_t row = row0 + t;
    gs[t] = from_f<T>(row < n ? g[row] : 0.f);
    if (row < n) go[row] = gs[t];
  }
  __syncthreads();
  if (REBUILD) {
    dense_tile<true>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, hs.a[0], row0, n);
    __syncthreads();
    dense_tile<true>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, hs.a[1], row0, n);
    __syncthreads();
    dense_tile<true>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, hs.a[2], row0, n);
    __syncthreads();
    dense_tile<true>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, hs.a[3], row0, n);
    __syncthreads();   // also makes the stored h1..h4 visible to the block
  }
  // dh4 = mask(h4) (go (x) wo): a K = 1 product, no delta operand
  delta_tile(none, 0, none, h, hs.a[3], gs, p.wo, buf_a, dhs.a[3], row0, n, st);
  __syncthreads();
  delta_tile(buf_a, h, p.w3, h, hs.a[2], none, none, buf_b, dhs.a[2], row0, n, st);
  __syncthreads();
  delta_tile(buf_b, h, p.w2, h, hs.a[1], none, none, buf_a, dhs.a[1], row0, n, st);
  __syncthreads();
  delta_tile(buf_a, h, p.w1, h, hs.a[0], none, none, buf_b, dhs.a[0], row0, n, st);
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
                                (n + splits - 1) / splits, false, stream);
}

// prop: the points are walked in chunks of whole K-splits (rows_per_split
// points each split, chunk_rows points a chunk), each chunk's deltas in
// scratch of the chunk's size.  REBUILD: hs is scratch of 4 x chunk_rows x h
// for the rebuilt h1..h4; else the 4 pointers of acts are the stored (n, h)
// activations.  go (chunk_rows,) and dhs (4 x chunk_rows x h) are scratch;
// grads: the 10 f32 outputs in the order of the weight tuple; partial:
// chunk_rows / rows_per_split splits of 212,992 floats at the default
// widths.
template <bool REBUILD, typename T>
int launch_prop_bwd(const void* x, const float* g_out, const uint64_t* ptrs,
                    int64_t n, int dx, int h, void* hs, const uint64_t* acts,
                    void* go, void* dhs, float* partial,
                    int64_t rows_per_split, int64_t chunk_rows,
                    const uint64_t* grads, cudaStream_t stream) {
  const PropWeights<T> p = prop_weights<T>(ptrs);
  const size_t smem = ((size_t)TM * (4 + (REBUILD ? dx : 0) + 2 * h)
                       + KC * stage_ld<T>()) * sizeof(T);
  int err = set_smem(prop_delta_kernel<REBUILD, T>, smem);
  if (err != 0) return err;
  const int64_t sizes[10] = {(int64_t)dx * h, h, (int64_t)h * h, h,
                             (int64_t)h * h, h, (int64_t)h * h, h, h, 1};
  auto run = [&](int64_t c0, int64_t nc, const GradPlan& gp, WGradJobs& jobs,
                 int& tiles) -> int {
    const T* xc = (const T*)x + c0 * dx;
    PropHs<T> a, d;
    for (int i = 0; i < 4; ++i) {
      a.a[i] = REBUILD ? (T*)hs + i * nc * h : (T*)acts[i] + c0 * h;
      d.a[i] = (T*)dhs + i * nc * h;
    }
    if (nc > 0) {
      const unsigned grid = (unsigned)((nc + TM - 1) / TM);
      prop_delta_kernel<REBUILD, T><<<grid, THREADS, smem, stream>>>(
          xc, p, g_out + c0, nc, dx, h, a, (T*)go, d);
      const int e = (int)cudaGetLastError();
      if (e != 0) return e;
    }
    add_job(jobs, tiles, gp, partial, xc, dx, d.a[0], h, false, 0, 1);
    add_job(jobs, tiles, gp, partial, a.a[0], h, d.a[1], h, false, 2, 3);
    add_job(jobs, tiles, gp, partial, a.a[1], h, d.a[2], h, false, 4, 5);
    add_job(jobs, tiles, gp, partial, a.a[2], h, d.a[3], h, false, 6, 7);
    add_job(jobs, tiles, gp, partial, a.a[3], h, go, 1, false, 8, 9);
    return 0;
  };
  return chunked_wgrad<T>(sizes, 10, n, rows_per_split, chunk_rows, partial,
                          grads, false, stream, run);
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
  int prop_mlp_bwd_##SUFFIX(                                                   \
      const void* x, const void* g, const uint64_t* ptrs, int64_t n, int dx,  \
      int h, void* hs, void* go, void* dhs, void* partial,                     \
      int64_t rows_per_split, int64_t chunk_rows, const uint64_t* grads,       \
      void* stream) {                                                          \
    return launch_prop_bwd<true, T>(                                           \
        x, (const float*)g, ptrs, n, dx, h, hs, nullptr, go, dhs,              \
        (float*)partial, rows_per_split, chunk_rows, grads,                    \
        (cudaStream_t)stream);                                                 \
  }                                                                            \
  int prop_mlp_bwd_res_##SUFFIX(                                               \
      const void* x, const void* g, const uint64_t* ptrs, int64_t n, int dx,  \
      int h, const uint64_t* acts, void* go, void* dhs, void* partial,         \
      int64_t rows_per_split, int64_t chunk_rows, const uint64_t* grads,       \
      void* stream) {                                                          \
    return launch_prop_bwd<false, T>(                                          \
        x, (const float*)g, ptrs, n, dx, h, nullptr, acts, go, dhs,            \
        (float*)partial, rows_per_split, chunk_rows, grads,                    \
        (cudaStream_t)stream);                                                 \
  }

VANILLA_BWD(f32, float)
VANILLA_BWD(bf16, __nv_bfloat16)
PROP_BWD(f32, float)
PROP_BWD(bf16, __nv_bfloat16)

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
