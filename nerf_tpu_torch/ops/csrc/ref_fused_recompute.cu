// Fused Ref-NeRF backward kernels in the recompute form, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of nerf_tpu/ops/ref_fused.py that
// store_residuals=False selects (the memory-light step, and the spatial half
// of ref_kernels="hybrid"):
//   ref_spa_bwd_recompute <- _make_spa_bwd_kernel (:701): enc and the heads'
//                            cotangent g (N, 11 + NB) f32 -> the 23 f32
//                            grads of the spatial tuple; the trunk is rebuilt
//                            from enc in the tile.
//   ref_dir_bwd_recompute <- _make_dir_bwd_kernel (:867): heads, noise, the
//                            per-ray directions and the cotangents of rgb,
//                            normal (N, 3) and density (N,) f32 -> d(heads)
//                            (N, 11 + NB) f32 and the 19 f32 grads of the
//                            directional tuple; the glue and the trunk are
//                            rebuilt in the tile.  Its code is in
//                            ref_dir_recompute.cuh, which the dissection
//                            (ref_dissect.cu) compiles too.
//
// Numerics are those of jax.vjp through _cd_matmul_rules (ref_fused.py
// :87-163) with bwd_cd=True, as the residual forms (ref_fused_bwd.cu) take
// them, with the two places where jax.vjp's own rules differ from the
// hand-written residual kernels: d(inter) sums the three heads' pullbacks
// in the order jax.vjp accumulates them, the reverse of the forward's
// (bn + nct, rounded, + rt, rounded), and the heads' bias grads are sums of
// the f32 cotangent, not of its rounded copy.  The rebuilt activations are
// the forward kernels' values bit for bit (the same tile code), so the ReLU
// masks are the forward's.
//
// Design.  A recompute backward that wrote every layer's activations and
// deltas for all N points, as the residual forms' weight-grad pass reads
// them, would hold as much device memory as the residual form saves.  These
// walk the points in chunks of whole K-splits (the TPU's tiles): per chunk a
// delta kernel rebuilds the chunk's activations into chunk-sized scratch and
// runs the chain rule (one block per 64 points, as ref_fused_bwd.cu), the
// split-K weight-grad pass (wgrad.cuh) writes the chunk's per-split partials,
// each rounded to T as the TPU rounds its per-tile weight grads, and the
// ordered reduction adds them onto the sums so far.  The splits are summed in
// the same order as one reduction over all of them: deterministic, no
// atomics, and the result does not depend on the chunk size.
//
// Bound on an H100 SXM (700 W), bf16 tensor-core peak 989 TFLOP/s: at
// H = O = 256 each backward costs its residual form's MACs (spatial 526,592
// weight-grad + 494,336 delta, directional 545,024 + 545,024 per point) plus
// one forward of its trunk (526,592 and 545,195): about 0.61 and 0.65 ms at
// N = 196,608, bound by operations.  This first version multiplies on the
// CUDA cores in f32, as the residual forms do.

#include "ref_common.cuh"
#include "ref_dir_recompute.cuh"
#include "wgrad.cuh"

namespace {

using namespace mlp;

// One chunk of n rows: x the chunk's enc rows, g its (n, 11 + NB) heads'
// cotangent; s receives h1..h4 z5 z6 z7 inter and dl d1 .. d7 (H), d8 (O).
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_spa_recompute_kernel(const T* __restrict__ x, RefSpaWeights<T> p,
                         const float* __restrict__ g, int64_t n, int dx,
                         int h, int o, int nb, int maxw, Acts<T> s,
                         Deltas<T> dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);    // (TM, dx)
  T* grt = xs + TM * dx;                 // (TM, 2)
  T* gnct = grt + TM * 2;                // (TM, 9)
  T* gbn = gnct + TM * 9;                // (TM, NB)
  T* buf_a = gbn + TM * nb;
  T* buf_b = buf_a + TM * maxw;
  T* st = buf_b + TM * maxw;             // the W^T stage
  const T* none = nullptr;
  T* drop = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int hw = HEAD_FIXED + nb;
  load_rows(x, dx, row0, n, xs);
  for (int idx = threadIdx.x; idx < TM * hw; idx += THREADS) {
    const int r = idx / hw;
    const int c = idx - r * hw;
    const int64_t row = row0 + r;
    const T v = from_f<T>(row < n ? g[row * hw + c] : 0.f);
    if (c < 2)
      grt[r * 2 + c] = v;
    else if (c < HEAD_FIXED)
      gnct[r * 9 + c - 2] = v;
    else
      gbn[r * nb + c - HEAD_FIXED] = v;
  }
  __syncthreads();
  // the trunk, as ref_spa_fwd_kernel runs it, into the chunk's scratch
  dense_tile<true>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, s.a[0], row0, n);     // h1
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.a[1], row0, n);   // h2
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.a[2], row0, n);   // h3
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.a[3], row0, n);   // h4
  __syncthreads();
  dense_tile<true>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.a[4], row0, n); // z5
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.a[5], row0, n);   // z6
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w6, none, 0, none, p.b6, h, true, buf_a, s.a[6], row0, n);   // z7
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w7, none, 0, none, p.b7, o, true, buf_b, s.a[7], row0, n);   // inter
  __syncthreads();   // also makes the stored activations visible to the block
  // d(inter) = cd(cd(cd(g_bn wbn^T) + cd(g_nct wnct^T)) + cd(g_rt wrt^T)),
  // masked: jax.vjp adds the heads' cotangents last use first
  delta_tile(gbn, nb, p.wbn, o, none, none, none, buf_a, drop, row0, n, st);
  __syncthreads();
  delta_tile<true>(gnct, 9, p.wnct, o, none, none, none, buf_a, drop, row0, n, st);
  __syncthreads();
  delta_tile<true>(grt, 2, p.wrt, o, s.a[7], none, none, buf_a, dl.d[7], row0, n, st);
  __syncthreads();
  delta_tile(buf_a, o, p.w7, h, s.a[6], none, none, buf_b, dl.d[6], row0, n, st);    // z7
  __syncthreads();
  delta_tile(buf_b, h, p.w6, h, s.a[5], none, none, buf_a, dl.d[5], row0, n, st);    // z6
  __syncthreads();
  delta_tile(buf_a, h, p.w5, h, s.a[4], none, none, buf_b, dl.d[4], row0, n, st);    // z5
  __syncthreads();
  delta_tile(buf_b, h, p.w4b, h, s.a[3], none, none, buf_a, dl.d[3], row0, n, st);   // h4
  __syncthreads();
  delta_tile(buf_a, h, p.w3, h, s.a[2], none, none, buf_b, dl.d[2], row0, n, st);    // h3
  __syncthreads();
  delta_tile(buf_b, h, p.w2, h, s.a[1], none, none, buf_a, dl.d[1], row0, n, st);    // h2
  __syncthreads();
  delta_tile(buf_a, h, p.w1, h, s.a[0], none, none, buf_b, dl.d[0], row0, n, st);    // h1
}

// dims: dx h o nb; acts: h1..h4 z5 z6 z7 inter and deltas: d1..d7 d8, each
// chunk_rows rows; grads: the 23 f32 outputs in the order of the weight
// tuple; partial: chunk_rows / rows_per_split splits of them
template <typename T>
int launch_spa_bwd_recompute(const void* x, const float* g,
                             const uint64_t* ptrs, int64_t n, const int* dims,
                             const uint64_t* acts, const uint64_t* deltas,
                             float* partial, int64_t rows_per_split,
                             int64_t chunk_rows, const uint64_t* grads,
                             cudaStream_t stream) {
  const RefSpaWeights<T> p = spa_weights<T>(ptrs);
  const Acts<T> s = acts_of<T>(acts);
  const Deltas<T> dl = deltas_of<T>(deltas);
  const int dx = dims[0], h = dims[1], o = dims[2], nb = dims[3];
  const int maxw = h > o ? h : o;
  const int hw = HEAD_FIXED + nb;
  const size_t smem =
      ((size_t)TM * (dx + 11 + nb + 2 * maxw) + KC * stage_ld<T>()) * sizeof(T);
  int err = set_smem(ref_spa_recompute_kernel<T>, smem);
  if (err != 0) return err;
  const int64_t sizes[23] = {
      (int64_t)dx * h, h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * h, h, (int64_t)dx * h, (int64_t)h * h, h, (int64_t)h * h,
      h, (int64_t)h * h, h, (int64_t)h * o, o, (int64_t)o * 2, 2,
      (int64_t)o * 9, 9, (int64_t)o * nb, nb};
  auto run = [&](int64_t c0, int64_t nc, const GradPlan& gp, WGradJobs& jobs,
                 int& tiles) -> int {
    const T* xc = (const T*)x + c0 * dx;
    const float* gc = g + c0 * hw;
    if (nc > 0) {
      const unsigned grid = (unsigned)((nc + TM - 1) / TM);
      ref_spa_recompute_kernel<T><<<grid, THREADS, smem, stream>>>(
          xc, p, gc, nc, dx, h, o, nb, maxw, s, dl);
      const int e = (int)cudaGetLastError();
      if (e != 0) return e;
    }
    T* const* a = s.a;
    T* const* d = dl.d;
    add_job(jobs, tiles, gp, partial, xc, dx, d[0], h, false, 0, 1);
    add_job(jobs, tiles, gp, partial, a[0], h, d[1], h, false, 2, 3);
    add_job(jobs, tiles, gp, partial, a[1], h, d[2], h, false, 4, 5);
    add_job(jobs, tiles, gp, partial, a[2], h, d[3], h, false, 6, 7);
    add_job(jobs, tiles, gp, partial, xc, dx, d[4], h, false, 8, -1);
    add_job(jobs, tiles, gp, partial, a[3], h, d[4], h, false, 9, 10);
    add_job(jobs, tiles, gp, partial, a[4], h, d[5], h, false, 11, 12);
    add_job(jobs, tiles, gp, partial, a[5], h, d[6], h, false, 13, 14);
    add_job(jobs, tiles, gp, partial, a[6], h, d[7], o, false, 15, 16);
    // the heads read the f32 cotangent itself: its rounded copy for the
    // product, the f32 values for the bias sums (jax.vjp's bias rule)
    add_job(jobs, tiles, gp, partial, a[7], o, gc, 2, true, 17, 18, hw);
    add_job(jobs, tiles, gp, partial, a[7], o, gc + 2, 9, true, 19, 20, hw);
    add_job(jobs, tiles, gp, partial, a[7], o, gc + HEAD_FIXED, nb, true, 21,
            22, hw);
    return 0;
  };
  return chunked_wgrad<T>(sizes, 23, n, rows_per_split, chunk_rows, partial,
                          grads, true, stream, run);
}

}  // namespace

extern "C" {

#define REF_RECOMPUTE(SUFFIX, T)                                               \
  int ref_spa_bwd_recompute_##SUFFIX(                                          \
      const void* x, const void* g, const uint64_t* ptrs, int64_t n,           \
      const int* dims, const uint64_t* acts, const uint64_t* deltas,           \
      void* partial, int64_t rows_per_split, int64_t chunk_rows,               \
      const uint64_t* grads, void* stream) {                                   \
    return launch_spa_bwd_recompute<T>(                                        \
        x, (const float*)g, ptrs, n, dims, acts, deltas, (float*)partial,      \
        rows_per_split, chunk_rows, grads, (cudaStream_t)stream);              \
  }                                                                            \
  int ref_dir_bwd_recompute_##SUFFIX(                                          \
      const void* heads, const void* noise, const void* dirs, int64_t per_ray, \
      const void* mat, const void* sigma, const void* grgb, const void* gnrm,  \
      const void* gden, const uint64_t* ptrs, int64_t n, const int* dims,      \
      void* xg, const uint64_t* acts, const uint64_t* deltas, void* dlog,      \
      void* dheads, void* partial, int64_t rows_per_split,                     \
      int64_t chunk_rows, const uint64_t* grads, void* stream) {               \
    return launch_dir_bwd_recompute<BWD_FULL, T>(                              \
        heads, noise, dirs, per_ray, mat, sigma, grgb, gnrm, gden, ptrs, n,    \
        dims, xg, acts, deltas, (float*)dlog, (float*)dheads,                  \
        (float*)partial, rows_per_split, chunk_rows, grads,                    \
        (cudaStream_t)stream);                                                 \
  }

REF_RECOMPUTE(f32, float)
REF_RECOMPUTE(bf16, __nv_bfloat16)

const char* ref_fused_recompute_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
