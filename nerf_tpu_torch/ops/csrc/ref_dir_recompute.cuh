// The fused directional backward of Ref-NeRF in the recompute form
// (ref_dir_bwd_recompute of ref_fused_recompute.cu) and the modes of its
// dissection (ref_dir_bwd_dissect of ref_dissect.cu): one kernel and one
// chunk loop, parts of them switched off by a compile-time MODE, as
// _dissect_dir_bwd (tools/bench_ref_kernels.py:45 of the JAX package) cuts
// the TPU kernel:
//   BWD_RECOMPUTE  the forward rebuild only (the trunk input, the glue, the
//                  trunk with its stored activations, the rgb tail); rgb,
//                  normal and density go to d(heads)' first 7 columns, the
//                  rest of d(heads) and the grads are zero;
//   BWD_DHEADS     the rebuild, the delta pass (its deltas not stored) and
//                  the glue's pullback to d(heads); the grads are zero;
//   BWD_WGRADS     the rebuild, the trunk's delta pass, the split-K
//                  weight-grad pass and the reduction; no pullback into the
//                  trunk input or the glue, d(heads) zero;
//   BWD_FULL       the shipped backward.
// Kept in a header so that both libraries compile the same code.

#pragma once

#include "ref_common.cuh"
#include "wgrad.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

constexpr int BWD_RECOMPUTE = 0;
constexpr int BWD_DHEADS = 1;
constexpr int BWD_WGRADS = 2;
constexpr int BWD_FULL = 3;

// The chunk's scratch, (rows, width) each in T.
template <typename T>
struct Deltas {
  T* d[8];
};

template <typename T>
Deltas<T> deltas_of(const uint64_t* ptrs) {
  Deltas<T> o;
  for (int i = 0; i < 8; ++i) o.d[i] = (T*)ptrs[i];
  return o;
}

// One chunk of n rows starting at row row_base of the operands: heads, noise,
// grgb, gnrm, gden and dheads point at the chunk's first row, dirs at the
// whole (R, 3) array.  xg (n, dd), s (h1..h4 z5 z6 (H) z7 z8 (O)), dl (d1 ..
// d6 (H), d7 d8 (O)) and dlog (n, 3) f32 are the chunk's scratch.
template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_dir_recompute_kernel(const float* __restrict__ heads,
                         const T* __restrict__ noise,
                         const float* __restrict__ dirs, int64_t per_ray,
                         int64_t row_base, const float* __restrict__ mat,
                         const float* __restrict__ sigma,
                         const float* __restrict__ grgb,
                         const float* __restrict__ gnrm,
                         const float* __restrict__ gden, RefDirWeights<T> p,
                         int64_t n, DirDims d, T* __restrict__ xg, Acts<T> s,
                         Deltas<T> dl, float* __restrict__ dlog,
                         float* __restrict__ dheads) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* mat_s = reinterpret_cast<float*>(smem);
  float* sig_s = mat_s + (d.l_max + 1) * d.n_ch;
  float* tint_s = sig_s + d.n_ch;     // (TM, 3) sigmoid(tint)
  float* diff_s = tint_s + TM * 3;    // (TM, 3) sigmoid(diffuse [- ln 3])
  float* spec_s = diff_s + TM * 3;    // (TM, 3) sigmoid(logit)
  float* dtint_s = spec_s + TM * 3;   // (TM, 3) their cotangents
  float* ddiff_s = dtint_s + TM * 3;
  const int nf = ((d.l_max + 1) * d.n_ch + d.n_ch + 15 * TM + 3) & ~3;
  T* xs = reinterpret_cast<T*>(mat_s + nf);   // x, then its pullback
  T* buf_a = xs + TM * d.dd;
  T* buf_b = buf_a + TM * d.maxw;
  T* dlc = buf_b + TM * d.maxw;       // (TM, 3) logit cotangent in T
  T* st = dlc + TM * 4;               // the W^T stage
  const T* none = nullptr;
  T* drop = nullptr;
  // the deltas (and dlog) go to device memory only for the weight-grad pass
  constexpr bool KEEP = MODE != BWD_DHEADS;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t valid = n - row0 < TM ? n - row0 : TM;
  const int64_t hw = HEAD_FIXED + d.nb;
  const int h = d.h, o = d.o, dd = d.dd;
  for (int i = threadIdx.x; i < (d.l_max + 1) * d.n_ch; i += THREADS)
    mat_s[i] = mat[i];
  for (int i = threadIdx.x; i < d.n_ch; i += THREADS) sig_s[i] = sigma[i];
  // the trunk input, as ref_dir_fwd_kernel builds it
  for (int idx = threadIdx.x; idx < TM * d.nb; idx += THREADS) {
    const int r = idx / d.nb;
    const int c = idx - r * d.nb;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < n) {
      v = heads[row * hw + HEAD_FIXED + c];
      if (noise != nullptr) v += to_f(noise[row * d.nb + c]);
    }
    xs[r * dd + c] = from_f<T>(v);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    const int64_t row = row0 + r;
    T* xr = xs + r * dd;
    if (row < n) {
      // BWD_RECOMPUTE writes the normal and the density into d(heads)
      float* dh = MODE == BWD_RECOMPUTE ? dheads + row * hw : nullptr;
      dir_glue(heads + row * hw, dirs + ((row_base + row) / per_ray) * 3,
               mat_s, sig_s, d, xr, tint_s + r * 3, diff_s + r * 3,
               dh == nullptr ? nullptr : dh + 3,
               dh == nullptr ? nullptr : dh + 6);
    } else {
      for (int c = d.nb; c < dd; ++c) xr[c] = from_f<T>(0.f);
      for (int k = 0; k < 3; ++k) tint_s[r * 3 + k] = diff_s[r * 3 + k] = 0.f;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < valid * dd; idx += THREADS)
    xg[row0 * dd + idx] = xs[idx];
  // the trunk, as ref_dir_fwd_kernel<true> runs it, into the chunk's scratch
  dense_tile<true>(xs, dd, p.w0, none, 0, none, p.b0, h, true, buf_a, s.a[0], row0, n);     // h1
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.a[1], row0, n);   // h2
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.a[2], row0, n);   // h3
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.a[3], row0, n);   // h4
  __syncthreads();
  dense_tile<true>(xs, dd, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.a[4], row0, n); // z5
  __syncthreads();
  dense_tile<true>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.a[5], row0, n);   // z6
  __syncthreads();
  dense_tile<true>(buf_b, h, p.w6, none, 0, none, p.b6, o, true, buf_a, s.a[6], row0, n);   // z7
  __syncthreads();
  dense_tile<true>(buf_a, o, p.w7, none, 0, none, p.b7, o, true, buf_b, s.a[7], row0, n);   // z8
  __syncthreads();   // also makes the stored activations visible to the block
  narrow_head(buf_b, o, p.wh, p.bh, 3, true, spec_s, 3, 0, 0, TM);
  __syncthreads();
  if (MODE == BWD_RECOMPUTE) {
    // rgb into d(heads)' first 3 columns, columns 7.. zero
    for (int idx = threadIdx.x; idx < valid * 3; idx += THREADS) {
      const float v = spec_s[idx] * tint_s[idx] + diff_s[idx];
      dheads[(row0 + idx / 3) * hw + idx % 3] = d.srgb ? srgbf(v) : v;
    }
    for (int idx = threadIdx.x; idx < valid * (hw - 7); idx += THREADS)
      dheads[(row0 + idx / (hw - 7)) * hw + 7 + idx % (hw - 7)] = 0.f;
    return;
  }
  // the tail: rgb = [srgb](spec tint + diff), spec = sigmoid(logit)
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const int64_t row = row0 + idx / 3;
    float dlg = 0.f, dt = 0.f, df = 0.f;
    if (row < n) {
      const float sp = spec_s[idx], ti = tint_s[idx];
      float gv = grgb[row0 * 3 + idx];
      if (d.srgb) gv = srgb_bwd(sp * ti + diff_s[idx], gv);
      dt = gv * sp;
      df = gv;
      dlg = (gv * ti) * (sp * (1.f - sp));
      if (KEEP) dlog[row0 * 3 + idx] = dlg;
    }
    dtint_s[idx] = dt;
    ddiff_s[idx] = df;
    dlc[idx] = from_f<T>(dlg);
  }
  __syncthreads();
  T* g7 = KEEP ? dl.d[7] : nullptr;
  T* g6 = KEEP ? dl.d[6] : nullptr;
  T* g5 = KEEP ? dl.d[5] : nullptr;
  T* g4 = KEEP ? dl.d[4] : nullptr;
  T* g3 = KEEP ? dl.d[3] : nullptr;
  T* g2 = KEEP ? dl.d[2] : nullptr;
  T* g1 = KEEP ? dl.d[1] : nullptr;
  T* g0 = KEEP ? dl.d[0] : nullptr;
  delta_tile(dlc, 3, p.wh, o, s.a[7], none, none, buf_b, g7, row0, n, st);   // z8
  __syncthreads();
  delta_tile(buf_b, o, p.w7, o, s.a[6], none, none, buf_a, g6, row0, n, st); // z7
  __syncthreads();
  delta_tile(buf_a, o, p.w6, h, s.a[5], none, none, buf_b, g5, row0, n, st); // z6
  __syncthreads();
  delta_tile(buf_b, h, p.w5, h, s.a[4], none, none, buf_a, g4, row0, n, st); // z5
  __syncthreads();
  // the pullback of x: cd(d5 w4a^T) + cd(d1 w0^T), rounded after the add
  if (MODE != BWD_WGRADS) {
    delta_tile(buf_a, h, p.w4a, dd, none, none, none, xs, drop, row0, n, st);
    __syncthreads();
  }
  delta_tile(buf_a, h, p.w4b, h, s.a[3], none, none, buf_b, g3, row0, n, st); // h4
  __syncthreads();
  delta_tile(buf_b, h, p.w3, h, s.a[2], none, none, buf_a, g2, row0, n, st);  // h3
  __syncthreads();
  delta_tile(buf_a, h, p.w2, h, s.a[1], none, none, buf_b, g1, row0, n, st);  // h2
  __syncthreads();
  delta_tile(buf_b, h, p.w1, h, s.a[0], none, none, buf_a, g0, row0, n, st);  // h1
  __syncthreads();
  if (MODE == BWD_WGRADS) {
    for (int idx = threadIdx.x; idx < valid * hw; idx += THREADS)
      dheads[row0 * hw + idx] = 0.f;
    return;
  }
  delta_tile<true>(buf_a, h, p.w0, dd, none, none, none, xs, drop, row0, n, st);
  __syncthreads();
  // d(heads): the bottleneck's pullback passes through, the glue per point
  for (int idx = threadIdx.x; idx < valid * d.nb; idx += THREADS) {
    const int r = idx / d.nb;
    const int c = idx - r * d.nb;
    dheads[(row0 + r) * hw + HEAD_FIXED + c] = to_f(xs[r * dd + c]);
  }
  for (int r = threadIdx.x; r < valid; r += THREADS) {
    const int64_t row = row0 + r;
    dir_glue_bwd(heads + row * hw, dirs + ((row_base + row) / per_ray) * 3,
                 mat_s, sig_s, d, xs + r * dd, gnrm + row * 3, gden[row],
                 tint_s + r * 3, diff_s + r * 3, dtint_s + r * 3,
                 ddiff_s + r * 3, dheads + row * hw);
  }
}

// dims: nb h o l_max n_ch use_srgb; xg, acts (h1..h4 z5 z6 z7 z8), deltas
// (d1..d6 d7 d8) and dlog: chunk_rows rows each; grads: the 19 f32 outputs
// in the order of the weight tuple, zeroed by the modes without the
// weight-grad pass
template <int MODE, typename T>
int launch_dir_bwd_recompute(
    const void* heads, const void* noise, const void* dirs, int64_t per_ray,
    const void* mat, const void* sigma, const void* grgb, const void* gnrm,
    const void* gden, const uint64_t* ptrs, int64_t n, const int* dims,
    void* xg, const uint64_t* acts, const uint64_t* deltas, float* dlog,
    float* dheads, float* partial, int64_t rows_per_split, int64_t chunk_rows,
    const uint64_t* grads, cudaStream_t stream) {
  const RefDirWeights<T> p = dir_weights<T>(ptrs);
  const Acts<T> s = acts_of<T>(acts);
  const Deltas<T> dl = deltas_of<T>(deltas);
  const DirDims d = dir_dims(dims);
  const int nf = ((d.l_max + 1) * d.n_ch + d.n_ch + 15 * TM + 3) & ~3;
  const size_t smem = (size_t)nf * sizeof(float)
      + ((size_t)TM * (d.dd + 2 * d.maxw + 4) + KC * stage_ld<T>())
      * sizeof(T);
  int err = set_smem(ref_dir_recompute_kernel<MODE, T>, smem);
  if (err != 0) return err;
  const int h = d.h, o = d.o, dd = d.dd;
  const int64_t hw = HEAD_FIXED + d.nb;
  const int64_t sizes[19] = {
      (int64_t)dd * h, h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * h, h, (int64_t)dd * h, (int64_t)h * h, h, (int64_t)h * h,
      h, (int64_t)h * o, o, (int64_t)o * o, o, (int64_t)o * 3, 3};
  constexpr bool WGRADS = MODE == BWD_WGRADS || MODE == BWD_FULL;
  if (!WGRADS) {
    for (int i = 0; i < 19; ++i) {
      err = (int)cudaMemsetAsync((void*)grads[i], 0, sizes[i] * sizeof(float),
                                 stream);
      if (err != 0) return err;
    }
  }
  auto run = [&](int64_t c0, int64_t nc, const GradPlan& gp, WGradJobs& jobs,
                 int& tiles) -> int {
    if (nc > 0) {
      const unsigned grid = (unsigned)((nc + TM - 1) / TM);
      ref_dir_recompute_kernel<MODE, T><<<grid, THREADS, smem, stream>>>(
          (const float*)heads + c0 * hw,
          noise == nullptr ? nullptr : (const T*)noise + c0 * d.nb,
          (const float*)dirs, per_ray, c0, (const float*)mat,
          (const float*)sigma, (const float*)grgb + c0 * 3,
          (const float*)gnrm + c0 * 3, (const float*)gden + c0, p, nc, d,
          (T*)xg, s, dl, dlog, dheads + c0 * hw);
      const int e = (int)cudaGetLastError();
      if (e != 0) return e;
    }
    T* const* a = s.a;
    T* const* t = dl.d;
    add_job(jobs, tiles, gp, partial, xg, dd, t[0], h, false, 0, 1);
    add_job(jobs, tiles, gp, partial, a[0], h, t[1], h, false, 2, 3);
    add_job(jobs, tiles, gp, partial, a[1], h, t[2], h, false, 4, 5);
    add_job(jobs, tiles, gp, partial, a[2], h, t[3], h, false, 6, 7);
    add_job(jobs, tiles, gp, partial, xg, dd, t[4], h, false, 8, -1);
    add_job(jobs, tiles, gp, partial, a[3], h, t[4], h, false, 9, 10);
    add_job(jobs, tiles, gp, partial, a[4], h, t[5], h, false, 11, 12);
    add_job(jobs, tiles, gp, partial, a[5], h, t[6], o, false, 13, 14);
    add_job(jobs, tiles, gp, partial, a[6], o, t[7], o, false, 15, 16);
    add_job(jobs, tiles, gp, partial, a[7], o, dlog, 3, true, 17, 18);
    return 0;
  };
  return chunked_wgrad<T>(sizes, 19, n, rows_per_split, chunk_rows, partial,
                          grads, true, stream, run, WGRADS);
}

}  // namespace
