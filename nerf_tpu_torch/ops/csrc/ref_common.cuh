// Device code shared by the Ref-NeRF forward and backward kernels
// (ref_fused.cu, ref_fused_bwd.cu): the weight tuples, the narrow heads and
// the per-point glue of the directional branch.

#pragma once

#include "mlp_tile.cuh"

#include <float.h>

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

constexpr int HEAD_FIXED = 11;   // rho_tau 2 + normal 3 + diffuse 3 + tint 3
constexpr float LN3 = 1.0986122886681098f;

template <typename T>
struct RefSpaWeights {
  const T *w0, *w1, *w2, *w3, *w4a, *w4b, *w5, *w6, *w7, *wrt, *wnct, *wbn;
  const float *b0, *b1, *b2, *b3, *b4, *b5, *b6, *b7, *brt, *bnct, *bbn;
};

template <typename T>
struct RefDirWeights {
  const T *w0, *w1, *w2, *w3, *w4a, *w4b, *w5, *w6, *w7, *wh;
  const float *b0, *b1, *b2, *b3, *b4, *b5, *b6, *b7, *bh;
};

// ptrs: the 23 device pointers of the spatial weight tuple in the order of
// nerf_tpu/ops/ref_fused.py:51-63.
template <typename T>
RefSpaWeights<T> spa_weights(const uint64_t* ptrs) {
  RefSpaWeights<T> p;
  p.w0 = (const T*)ptrs[0];    p.b0 = (const float*)ptrs[1];
  p.w1 = (const T*)ptrs[2];    p.b1 = (const float*)ptrs[3];
  p.w2 = (const T*)ptrs[4];    p.b2 = (const float*)ptrs[5];
  p.w3 = (const T*)ptrs[6];    p.b3 = (const float*)ptrs[7];
  p.w4a = (const T*)ptrs[8];   p.w4b = (const T*)ptrs[9];
  p.b4 = (const float*)ptrs[10];
  p.w5 = (const T*)ptrs[11];   p.b5 = (const float*)ptrs[12];
  p.w6 = (const T*)ptrs[13];   p.b6 = (const float*)ptrs[14];
  p.w7 = (const T*)ptrs[15];   p.b7 = (const float*)ptrs[16];
  p.wrt = (const T*)ptrs[17];  p.brt = (const float*)ptrs[18];
  p.wnct = (const T*)ptrs[19]; p.bnct = (const float*)ptrs[20];
  p.wbn = (const T*)ptrs[21];  p.bbn = (const float*)ptrs[22];
  return p;
}

// ptrs: the 19 device pointers of the directional weight tuple in the order
// of nerf_tpu/ops/ref_fused.py:65-74.
template <typename T>
RefDirWeights<T> dir_weights(const uint64_t* ptrs) {
  RefDirWeights<T> p;
  p.w0 = (const T*)ptrs[0];    p.b0 = (const float*)ptrs[1];
  p.w1 = (const T*)ptrs[2];    p.b1 = (const float*)ptrs[3];
  p.w2 = (const T*)ptrs[4];    p.b2 = (const float*)ptrs[5];
  p.w3 = (const T*)ptrs[6];    p.b3 = (const float*)ptrs[7];
  p.w4a = (const T*)ptrs[8];   p.w4b = (const T*)ptrs[9];
  p.b4 = (const float*)ptrs[10];
  p.w5 = (const T*)ptrs[11];   p.b5 = (const float*)ptrs[12];
  p.w6 = (const T*)ptrs[13];   p.b6 = (const float*)ptrs[14];
  p.w7 = (const T*)ptrs[15];   p.b7 = (const float*)ptrs[16];
  p.wh = (const T*)ptrs[17];   p.bh = (const float*)ptrs[18];
  return p;
}

struct DirDims {
  int nb, dd, h, o, maxw, l_max, n_ch, srgb;
};

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// jax.nn.softplus: logaddexp(v, 0)
__device__ __forceinline__ float softplusf(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// linear_to_srgb (ref_fused.py:303-308)
__device__ __forceinline__ float srgbf(float v) {
  return v <= 0.0031308f
      ? 323.f / 25.f * v
      : (211.f * powf(fmaxf(FLT_EPSILON, v), 5.f / 12.f) - 11.f) / 200.f;
}

// dst[(row0 + r) * ld + col0 + o] = act(a[r] @ w[:, o] + bias[o]) for the
// tile's rows r with row0 + r < n and o < n_out, with a (TM, k_dim) in
// shared memory and w (k_dim, n_out): one warp per (r, o), lanes stride over
// k and reduce with shuffles.  For the narrow heads.
template <typename T>
__device__ void narrow_head(const T* a, int k_dim, const T* __restrict__ w,
                            const float* __restrict__ bias, int n_out,
                            bool sigmoid, float* dst, int64_t ld, int col0,
                            int64_t row0, int64_t n) {
  const int lane = threadIdx.x & 31;
  for (int idx = threadIdx.x >> 5; idx < TM * n_out; idx += WARPS) {
    const int r = idx / n_out;
    const int o = idx - r * n_out;
    float acc = 0.f;
    for (int k = lane; k < k_dim; k += 32)
      acc = fmaf(to_f(a[r * k_dim + k]), to_f(w[(size_t)k * n_out + o]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && row0 + r < n) {
      float v = acc + bias[o];
      if (sigmoid) v = sigmoidf(v);
      dst[(row0 + r) * ld + col0 + o] = v;
    }
  }
}

// dst[(row0 + r) * ld + col0 + c] = a[r] @ w[:, c] + bias[c] in f32 for
// c < n_out and the tile's valid rows: a wide linear head, register-tiled
// as the hidden layers are (dense_tile), written unrounded.
template <typename T>
__device__ void wide_head(const T* a, int k_dim, const T* __restrict__ w,
                          const float* __restrict__ bias, int n_out,
                          float* __restrict__ dst, int64_t ld, int col0,
                          int64_t row0, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
  for (int c0 = 0; c0 < n_out; c0 += CHUNK) {
    float acc[RPT][CPT];
    zero(acc);
    accumulate(acc, a, k_dim, w, n_out, c0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c >= n_out) continue;
      const float b = bias[c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int64_t row = row0 + r0 + i;
        if (row < n) dst[row * ld + col0 + c] = acc[i][j] + b;
      }
    }
  }
}

// dims of the directional kernels: nb h o l_max n_ch use_srgb
inline DirDims dir_dims(const int* dims) {
  DirDims d;
  d.nb = dims[0];
  d.h = dims[1];
  d.o = dims[2];
  d.l_max = dims[3];
  d.n_ch = dims[4];
  d.srgb = dims[5];
  d.dd = d.nb + 2 * d.n_ch + 1;
  d.maxw = d.h > d.o ? d.h : d.o;
  return d;
}

// The 8 stored activations of a trunk, (n, width) each in T.
template <typename T>
struct Acts {
  T* a[8];
};

template <typename T>
Acts<T> acts_of(const uint64_t* ptrs) {
  Acts<T> s;
  for (int i = 0; i < 8; ++i) s.a[i] = (T*)ptrs[i];
  return s;
}

// The pre-trunk glue of one point (_dir_glue_prelude_rowland, ref_fused.py
// :543-572) into its row xr of the tile's input: the IDE in columns
// [nb, nb + 2C), d.n in column nb + 2C; sigmoid(tint) and
// sigmoid(diffuse [- ln 3]) into tint3 and diff3; the normal and the density
// passthrough to device memory unless nrm_out is null.
template <typename T>
__device__ void dir_glue(const float* hr, const float* dv, const float* mat,
                         const float* sig, const DirDims& d, T* xr,
                         float* tint3, float* diff3, float* nrm_out,
                         float* den_out) {
  const float n0 = hr[2], n1 = hr[3], n2 = hr[4];
  const float norm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f) + 1e-7f;
  const float m0 = -n0 / norm, m1 = -n1 / norm, m2 = -n2 / norm;
  const float dn = dv[0] * m0 + dv[1] * m1 + dv[2] * m2;
  const float x = dv[0] - 2.f * dn * m0;
  const float y = dv[1] - 2.f * dn * m1;
  const float z = dv[2] - 2.f * dn * m2;
  const float rough = softplusf(hr[0] - 1.f);
  int c = 0;
  for (int l = 1; l <= d.l_max; l *= 2) {
    float pr = 1.f, pi = 0.f;          // (x + iy)^m, from m = 0
    for (int m = 0; m <= l; ++m, ++c) {
      float vzm = 0.f, zp = 1.f;       // sum_i mat[i, c] z^i
      for (int i = 0; i <= d.l_max; ++i) {
        vzm = fmaf(mat[i * d.n_ch + c], zp, vzm);
        zp *= z;
      }
      const float att = expf(-sig[c] * rough);
      xr[d.nb + c] = from_f<T>(pr * vzm * att);
      xr[d.nb + d.n_ch + c] = from_f<T>(pi * vzm * att);
      const float next = pr * x - pi * y;
      pi = pi * x + pr * y;
      pr = next;
    }
  }
  xr[d.nb + 2 * d.n_ch] = from_f<T>(dn);
  const float shift = d.srgb ? LN3 : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tint3[k] = sigmoidf(hr[8 + k]);
    diff3[k] = sigmoidf(hr[5 + k] - shift);
  }
  if (nrm_out == nullptr) return;
  nrm_out[0] = m0;
  nrm_out[1] = m1;
  nrm_out[2] = m2;
  *den_out = hr[1];
}

}  // namespace
