// The fused directional forward of Ref-NeRF (ref_dir_fwd, ref_dir_fwd_res
// of ref_fused.cu) and the stages of its dissection (ref_dir_fwd_dissect of
// ref_dissect.cu): one kernel, its glue stopped at a compile-time STAGE
// (ref_common.cuh).  At DIR_FULL it is the shipped kernel; below it the
// glue's later parts are switched off and rgb is the specular head alone,
// sigmoid(z8 @ wh + bh), as the stages of _dissect_dir_fwd
// (tools/bench_ref_kernels.py:145 of the JAX package) write it.  Kept in a
// header so that both libraries compile the same code.

#pragma once

#include "ref_common.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

// With STORE the 8 trunk activations go to s (device memory) as well.  rows:
// the (2C + 1, n) input rows of DIR_TRUNK and DIR_REFLECT, else null.
template <bool STORE, int STAGE, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_dir_fwd_kernel(const float* __restrict__ heads, const T* __restrict__ noise,
                   const float* __restrict__ dirs, int64_t per_ray,
                   const float* __restrict__ rows,
                   const float* __restrict__ mat,
                   const float* __restrict__ sigma, RefDirWeights<T> p,
                   int64_t n, DirDims d, float* __restrict__ rgb,
                   float* __restrict__ normal, float* __restrict__ density,
                   Acts<T> s, const __grid_constant__ TileMaps maps) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* buf_a = xs + TM * d.dd;
  T* buf_b = buf_a + TM * d.maxw;
  T* st = buf_b + TM * d.maxw;         // dense_tile's weight stage
  float* mat_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(st)
      + dense_stage_bytes<T>(reinterpret_cast<unsigned char*>(st) - smem));
  float* sig_s = mat_s + (d.l_max + 1) * d.n_ch;
  float* tint_s = sig_s + d.n_ch;      // (TM, 3) sigmoid(tint)
  float* diff_s = tint_s + TM * 3;     // (TM, 3) sigmoid(diffuse [- ln 3])
  float* spec_s = diff_s + TM * 3;     // (TM, 3) specular
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t hw = HEAD_FIXED + d.nb;
  for (int i = threadIdx.x; i < (d.l_max + 1) * d.n_ch; i += THREADS)
    mat_s[i] = mat[i];
  for (int i = threadIdx.x; i < d.n_ch; i += THREADS) sig_s[i] = sigma[i];
  // b_vec = (bottleneck + noise) cast to T, the first nb columns of x
  for (int idx = threadIdx.x; idx < TM * d.nb; idx += THREADS) {
    const int r = idx / d.nb;
    const int c = idx - r * d.nb;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < n) {
      v = heads[row * hw + HEAD_FIXED + c];
      if (noise != nullptr) v += to_f(noise[row * d.nb + c]);
    }
    xs[r * d.dd + c] = from_f<T>(v);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    const int64_t row = row0 + r;
    T* xr = xs + r * d.dd;
    if (row < n) {
      dir_glue<STAGE>(heads + row * hw, dirs + (row / per_ray) * 3, mat_s,
                      sig_s, d, xr, tint_s + r * 3, diff_s + r * 3,
                      normal + row * 3, density + row, rows + row, n);
    } else {
      for (int c = d.nb; c < d.dd; ++c) xr[c] = from_f<T>(0.f);
      for (int k = 0; k < 3; ++k) tint_s[r * 3 + k] = diff_s[r * 3 + k] = 0.f;
    }
  }
  __syncthreads();
  const int h = d.h, o = d.o, dd = d.dd;
  dense_tile<STORE>(xs, dd, p.w0, none, 0, none, p.b0, h, true, buf_a, s.a[0], row0, n, st, &maps.map[0]);     // h1
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.a[1], row0, n, st, &maps.map[1]);   // h2
  __syncthreads();
  dense_tile<STORE>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.a[2], row0, n, st, &maps.map[2]);   // h3
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.a[3], row0, n, st, &maps.map[3]);   // h4
  __syncthreads();
  dense_tile<STORE>(xs, dd, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.a[4], row0, n, st, &maps.map[4]); // z5
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.a[5], row0, n, st, &maps.map[6]);   // z6
  __syncthreads();
  dense_tile<STORE>(buf_b, h, p.w6, none, 0, none, p.b6, o, true, buf_a, s.a[6], row0, n, st, &maps.map[7]);   // z7
  __syncthreads();
  dense_tile<STORE>(buf_a, o, p.w7, none, 0, none, p.b7, o, true, buf_b, s.a[7], row0, n, st, &maps.map[8]);   // z8
  __syncthreads();
  narrow_head(buf_b, o, p.wh, p.bh, 3, true, spec_s, 3, 0, 0, TM);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const int64_t row = row0 + idx / 3;
    if (row >= n) continue;
    if (STAGE != DIR_FULL) {
      rgb[row0 * 3 + idx] = spec_s[idx];
      continue;
    }
    const float v = spec_s[idx] * tint_s[idx] + diff_s[idx];
    rgb[row0 * 3 + idx] = d.srgb ? srgbf(v) : v;
  }
}

// dims: nb h o l_max n_ch use_srgb; rows: the (2C + 1, n) input rows of the
// first two stages, else null; acts (STORE): the 8 (n, width) outputs
// h1..h4 z5 z6 z7 z8
template <bool STORE, int STAGE, typename T>
int launch_dir(const void* heads, const void* noise, const void* dirs,
               int64_t per_ray, const void* rows, const void* mat,
               const void* sigma, const uint64_t* ptrs, int64_t n,
               const int* dims, float* rgb, float* normal, float* density,
               const uint64_t* acts, cudaStream_t stream) {
  const RefDirWeights<T> p = dir_weights<T>(ptrs);
  const DirDims d = dir_dims(dims);
  if (!tile_widths_ok<T>({d.h, d.o})) return (int)cudaErrorInvalidValue;
  const size_t at = (size_t)TM * (d.dd + 2 * d.maxw) * sizeof(T);
  const size_t smem = at + dense_stage_bytes<T>(at)
      + (size_t)((d.l_max + 1) * d.n_ch + d.n_ch + 9 * TM) * sizeof(float);
  auto kernel = ref_dir_fwd_kernel<STORE, STAGE, T>;
  TileMaps maps;
  int err = dir_maps<T>(&maps, p, d);
  if (err == 0) err = set_smem(kernel, smem);
  if (err != 0 || n == 0) return err;
  if (STAGE <= DIR_REFLECT && rows == nullptr)
    return (int)cudaErrorInvalidValue;
  Acts<T> s = {};
  if (STORE) s = acts_of<T>(acts);
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)heads, (const T*)noise, (const float*)dirs, per_ray,
      (const float*)rows, (const float*)mat, (const float*)sigma, p, n, d,
      rgb, normal, density, s, maps);
  return (int)cudaGetLastError();
}

}  // namespace
