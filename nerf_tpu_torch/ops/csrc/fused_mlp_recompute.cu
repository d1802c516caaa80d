// Fused VanillaNeRF backward in the recompute form, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nerf_tpu/ops/fused_mlp.py that
// store_residuals=False selects:
//   vanilla_mlp_bwd_recompute <- _vanilla_bwd_kernel (:136) over
//                                _vanilla_bwd_tile (:181) and
//                                _vanilla_bwd_math (:195): enc_x (N, 63),
//                                enc_d (N, 27) and the cotangents g_rgb
//                                (3, N), g_sigma (N,) f32 -> the 24 f32
//                                grads of the weight tuple.  h1 .. r1 and
//                                rgb3 are rebuilt in the tile from the
//                                encodings; the forward saved nothing else.
//
// The chain rule is vanilla_mlp_bwd's (fused_mlp_bwd.cu), cast for cast; the
// rebuilt activations and rgb3 are the forward kernel's values bit for bit
// (the same tile code, the rgb head as the forward's warp reduction), so the
// ReLU masks and the sigmoid's derivative are the forward's.
//
// Design.  Writing every layer's activations and deltas for all N points,
// as vanilla_mlp_bwd's weight-grad pass reads them, would hold as much
// device memory as the residual form saves.  This backward walks the points
// in chunks of whole K-splits (ROWS_PER_SPLIT = 4096 points at the default
// step): per chunk one kernel rebuilds the chunk's activations into
// chunk-sized scratch and runs the chain rule (one block per 64 points),
// the split-K weight-grad pass (wgrad.cuh) writes the chunk's per-split f32
// partials, and the ordered reduction adds them onto the sums so far.  The
// splits are summed in the same order as vanilla_mlp_bwd sums them, so the
// grads equal its grads on the same operands: deterministic, no atomics, and
// independent of the chunk size.
//
// Bound on an H100 SXM (700 W), bf16 tensor-core peak 989 TFLOP/s: the
// residual backward's 527,872 weight-grad and 492,160 delta MACs per point
// plus one forward (527,872): 0.41 ms at N = 131,072, bound by operations.
// This first version multiplies on the CUDA cores in f32.

#include "mlp_tile.cuh"
#include "wgrad.cuh"

namespace {

using namespace mlp;

// The chunk's scratch, (rows, width) each: the 9 activations in T and the
// deltas (dbvec in f32, the others in T).
template <typename T>
struct ChunkActs {
  T *h1, *h2, *h3, *h4, *z5, *z6, *z7, *bvec, *r1;
};

template <typename T>
struct ChunkDeltas {
  T *dlogit, *gsig, *dr1;
  float* dbvec;
  T *dz7, *dz6, *dz5, *dh4, *dh3, *dh2, *dh1;
};

// One chunk of n rows: x and d the chunk's encoding rows; grgb (3, n_all)
// row-land and gsig the whole cotangents, read at column row_base + row.
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
vanilla_recompute_kernel(const T* __restrict__ x, const T* __restrict__ d,
                         VanillaWeights<T> p, const float* __restrict__ grgb,
                         const float* __restrict__ gsig, int64_t row_base,
                         int64_t n_all, ChunkActs<T> s, ChunkDeltas<T> o,
                         int64_t n, int dx, int dd, int h, int bn, int r,
                         int maxw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rgb_s = reinterpret_cast<float*>(smem);   // (TM, 3) sigmoid(logit)
  T* xs = reinterpret_cast<T*>(rgb_s + TM * 4);
  T* ds = xs + TM * dx;
  T* dl = ds + TM * dd;                   // (TM, 3) dlogit
  T* gs = dl + TM * 4;                    // (TM,) g_sigma in T
  T* buf_a = gs + TM * 4;
  T* buf_b = buf_a + TM * maxw;
  T* st = buf_b + TM * maxw;              // the W^T stage
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  load_rows(x, dx, row0, n, xs);
  load_rows(d, dd, row0, n, ds);
  __syncthreads();
  // the forward, as vanilla_mlp_fwd_kernel<true> runs it, into the scratch
  dense_tile<true>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, s.h1, row0, n);
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.h2, row0, n);
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.h3, row0, n);
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.h4, row0, n);
  __syncthreads();
  dense_tile<true>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.z5, row0, n);
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.z6, row0, n);
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w6, none, 0, none, p.b6, bn, true, buf_a, s.z7, row0, n);
  __syncthreads();
  dense_tile<true>(buf_a, bn, p.wb, none, 0, none, p.bb, bn, false, buf_b, s.bvec, row0, n);
  __syncthreads();
  dense_tile<true>(buf_b, bn, p.wr1a, ds, dd, p.wr1b, p.br1, r, true, buf_a, s.r1, row0, n);
  __syncthreads();
  narrow_head(buf_a, r, p.wr2, p.br2, 3, true, rgb_s, 3, 0, 0, TM);   // rgb
  __syncthreads();   // also makes the stored activations visible to the block
  // row-land sigmoid backward (fused_mlp.py:201)
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const int t = idx / 3, j = idx - 3 * t;
    const int64_t row = row0 + t;
    float v = 0.f;
    if (row < n) {
      const float y = rgb_s[idx];
      v = grgb[j * n_all + row_base + row] * y * (1.f - y);
    }
    dl[t * 3 + j] = from_f<T>(v);
    if (row < n) o.dlogit[row * 3 + j] = from_f<T>(v);
  }
  for (int t = threadIdx.x; t < TM; t += THREADS) {
    const int64_t row = row0 + t;
    gs[t] = from_f<T>(row < n ? gsig[row_base + row] : 0.f);
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

// acts (9 pointers, h1 h2 h3 h4 z5 z6 z7 bvec r1) and deltas (11 pointers,
// dlogit gsig dr1 dbvec dz7 dz6 dz5 dh4 dh3 dh2 dh1): chunk_rows rows each;
// grads: the 24 f32 outputs in the order of the weight tuple; partial:
// chunk_rows / rows_per_split splits of them.
template <typename T>
int launch_vanilla_bwd_recompute(const void* x, const void* d,
                                 const float* grgb, const float* gsig,
                                 const uint64_t* ptrs, int64_t n,
                                 const int* dims, const uint64_t* acts,
                                 const uint64_t* deltas, float* partial,
                                 int64_t rows_per_split, int64_t chunk_rows,
                                 const uint64_t* grads, cudaStream_t stream) {
  const VanillaWeights<T> p = vanilla_weights<T>(ptrs);
  ChunkActs<T> s;
  s.h1 = (T*)acts[0]; s.h2 = (T*)acts[1]; s.h3 = (T*)acts[2];
  s.h4 = (T*)acts[3]; s.z5 = (T*)acts[4]; s.z6 = (T*)acts[5];
  s.z7 = (T*)acts[6]; s.bvec = (T*)acts[7]; s.r1 = (T*)acts[8];
  ChunkDeltas<T> o;
  o.dlogit = (T*)deltas[0]; o.gsig = (T*)deltas[1]; o.dr1 = (T*)deltas[2];
  o.dbvec = (float*)deltas[3]; o.dz7 = (T*)deltas[4]; o.dz6 = (T*)deltas[5];
  o.dz5 = (T*)deltas[6]; o.dh4 = (T*)deltas[7]; o.dh3 = (T*)deltas[8];
  o.dh2 = (T*)deltas[9]; o.dh1 = (T*)deltas[10];
  const int dx = dims[0], dd = dims[1], h = dims[2], bn = dims[3], r = dims[4];
  int maxw = h > bn ? h : bn;
  maxw = maxw > r ? maxw : r;
  const size_t smem = (size_t)TM * 4 * sizeof(float)
      + ((size_t)TM * (dx + dd + 8 + 2 * maxw) + KC * stage_ld<T>())
      * sizeof(T);
  int err = set_smem(vanilla_recompute_kernel<T>, smem);
  if (err != 0) return err;
  const int64_t sizes[24] = {
      (int64_t)dx * h, h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * h, h, (int64_t)dx * h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * bn, bn, bn, 1, (int64_t)bn * bn, bn, (int64_t)bn * r,
      (int64_t)dd * r, r, (int64_t)r * 3, 3};
  auto run = [&](int64_t c0, int64_t nc, const GradPlan& g, WGradJobs& jobs,
                 int& tiles) -> int {
    const T* xc = (const T*)x + c0 * dx;
    const T* dc = (const T*)d + c0 * dd;
    if (nc > 0) {
      const unsigned grid = (unsigned)((nc + TM - 1) / TM);
      vanilla_recompute_kernel<T><<<grid, THREADS, smem, stream>>>(
          xc, dc, p, grgb, gsig, c0, n, s, o, nc, dx, dd, h, bn, r, maxw);
      const int e = (int)cudaGetLastError();
      if (e != 0) return e;
    }
    add_job(jobs, tiles, g, partial, xc, dx, o.dh1, h, false, 0, 1);
    add_job(jobs, tiles, g, partial, s.h1, h, o.dh2, h, false, 2, 3);
    add_job(jobs, tiles, g, partial, s.h2, h, o.dh3, h, false, 4, 5);
    add_job(jobs, tiles, g, partial, s.h3, h, o.dh4, h, false, 6, 7);
    add_job(jobs, tiles, g, partial, xc, dx, o.dz5, h, false, 8, -1);
    add_job(jobs, tiles, g, partial, s.h4, h, o.dz5, h, false, 9, 10);
    add_job(jobs, tiles, g, partial, s.z5, h, o.dz6, h, false, 11, 12);
    add_job(jobs, tiles, g, partial, s.z6, h, o.dz7, bn, false, 13, 14);
    add_job(jobs, tiles, g, partial, s.z7, bn, o.gsig, 1, false, 15, 16);
    add_job(jobs, tiles, g, partial, s.z7, bn, o.dbvec, bn, true, 17, 18);
    add_job(jobs, tiles, g, partial, s.bvec, bn, o.dr1, r, false, 19, -1);
    add_job(jobs, tiles, g, partial, dc, dd, o.dr1, r, false, 20, 21);
    add_job(jobs, tiles, g, partial, s.r1, r, o.dlogit, 3, false, 22, 23);
    return 0;
  };
  return chunked_wgrad<T>(sizes, 24, n, rows_per_split, chunk_rows, partial,
                          grads, false, stream, run);
}

}  // namespace

extern "C" {

#define VANILLA_BWD_RECOMPUTE(SUFFIX, T)                                       \
  int vanilla_mlp_bwd_recompute_##SUFFIX(                                      \
      const void* x, const void* d, const void* grgb, const void* gsig,        \
      const uint64_t* ptrs, int64_t n, const int* dims, const uint64_t* acts,  \
      const uint64_t* deltas, void* partial, int64_t rows_per_split,           \
      int64_t chunk_rows, const uint64_t* grads, void* stream) {               \
    return launch_vanilla_bwd_recompute<T>(                                    \
        x, d, (const float*)grgb, (const float*)gsig, ptrs, n, dims, acts,     \
        deltas, (float*)partial, rows_per_split, chunk_rows, grads,            \
        (cudaStream_t)stream);                                                 \
  }

VANILLA_BWD_RECOMPUTE(f32, float)
VANILLA_BWD_RECOMPUTE(bf16, __nv_bfloat16)

const char* fused_mlp_recompute_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
