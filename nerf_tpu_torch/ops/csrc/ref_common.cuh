// Device code shared by the Ref-NeRF kernels (ref_fused.cu, ref_fused_bwd.cu,
// ref_fused_recompute.cu): the weight tuples, the wide head and the
// per-point glue of the directional branch and its pullback.

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

// The stages of the directional forward, each adding a part of the glue to
// the one before (tools/bench_ref_kernels.py:147-156 of the JAX package).
// Every kernel of the training and render paths runs DIR_FULL; the
// dissection (ref_dissect.cu) also runs the first four, the same code with
// the later parts switched off.
constexpr int DIR_TRUNK = 0;    // the trunk: the IDE and d.n columns of its
                                // input read from ``rows``, normal = dirs
constexpr int DIR_REFLECT = 1;  // + the normal, d.n, the reflection and the
                                // roughness; IDE columns rows + [refl, rough]
constexpr int DIR_VANDER = 2;   // + the z-powers @ mat and the attenuation:
                                // Re and Im both (vz @ mat) att
constexpr int DIR_POLAR = 3;    // + the complex powers: the full IDE
constexpr int DIR_FULL = 4;     // + the rgb tail (tint, diffuse, sRGB)

// The pre-trunk glue of one point (_dir_glue_prelude_rowland, ref_fused.py
// :543-572) into its row xr of the tile's input: the IDE in columns
// [nb, nb + 2C), d.n in column nb + 2C; sigmoid(tint) and
// sigmoid(diffuse [- ln 3]) into tint3 and diff3; the normal and the density
// passthrough to device memory unless nrm_out is null.  Below DIR_FULL the
// glue stops at its STAGE (tint3 and diff3 are not written); DIR_TRUNK and
// DIR_REFLECT read the point's 2C + 1 input rows at rows[c * rs].
template <int STAGE = DIR_FULL, typename T>
__device__ void dir_glue(const float* hr, const float* dv, const float* mat,
                         const float* sig, const DirDims& d, T* xr,
                         float* tint3, float* diff3, float* nrm_out,
                         float* den_out, const float* rows = nullptr,
                         int64_t rs = 0) {
  if (STAGE == DIR_TRUNK) {
    for (int c = 0; c <= 2 * d.n_ch; ++c)
      xr[d.nb + c] = from_f<T>(rows[c * rs]);
    if (nrm_out == nullptr) return;
    nrm_out[0] = dv[0];
    nrm_out[1] = dv[1];
    nrm_out[2] = dv[2];
    *den_out = hr[1];
    return;
  }
  const float n0 = hr[2], n1 = hr[3], n2 = hr[4];
  const float norm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f) + 1e-7f;
  const float m0 = -n0 / norm, m1 = -n1 / norm, m2 = -n2 / norm;
  const float dn = dv[0] * m0 + dv[1] * m1 + dv[2] * m2;
  const float x = dv[0] - 2.f * dn * m0;
  const float y = dv[1] - 2.f * dn * m1;
  const float z = dv[2] - 2.f * dn * m2;
  const float rough = softplusf(hr[0] - 1.f);
  if (STAGE == DIR_REFLECT) {
    const float add[4] = {x, y, z, rough};
    for (int c = 0; c < 2 * d.n_ch; ++c)
      xr[d.nb + c] = from_f<T>(rows[c * rs] + (c < 4 ? add[c] : 0.f));
  } else {
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
        if (STAGE == DIR_VANDER) {
          xr[d.nb + c] = xr[d.nb + d.n_ch + c] = from_f<T>(vzm * att);
          continue;
        }
        xr[d.nb + c] = from_f<T>(pr * vzm * att);
        xr[d.nb + d.n_ch + c] = from_f<T>(pi * vzm * att);
        const float next = pr * x - pi * y;
        pi = pi * x + pr * y;
        pr = next;
      }
    }
  }
  xr[d.nb + 2 * d.n_ch] = from_f<T>(dn);
  if (STAGE == DIR_FULL) {
    const float shift = d.srgb ? LN3 : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tint3[k] = sigmoidf(hr[8 + k]);
      diff3[k] = sigmoidf(hr[5 + k] - shift);
    }
  }
  if (nrm_out == nullptr) return;
  nrm_out[0] = m0;
  nrm_out[1] = m1;
  nrm_out[2] = m2;
  *den_out = hr[1];
}

// d/dv of linear_to_srgb (ref_fused.py:303-308) times g, as jax.vjp takes it
// through the where: 323/25 below the knee, else (g / 200) 211 (5/12)
// max(eps, v)^(5/12 - 1).
__device__ __forceinline__ float srgb_bwd(float v, float g) {
  return v <= 0.0031308f
      ? g * (323.f / 25.f)
      : g / 200.f * 211.f * (5.f / 12.f * powf(fmaxf(FLT_EPSILON, v),
                                                5.f / 12.f - 1.f));
}

// The pullback of one point's glue (_dir_glue_prelude_rowland, ref_fused.py
// :543-572, with the recurrence IDE's hand rules :410-414, :474-482) into
// its row dh of d(heads), columns 0..10: xr is the pullback of the trunk
// input row in T (IDE in columns [nb, nb + 2C), d.n in nb + 2C); gn the
// normal's cotangent; dtint3 and ddiff3 those of sigmoid(tint) and
// sigmoid(diffuse [- ln 3]).  The forward is recomputed as dir_glue does it.
template <typename T>
__device__ void dir_glue_bwd(const float* hr, const float* dv,
                             const float* mat, const float* sig,
                             const DirDims& d, const T* xr, const float* gn,
                             float gden, const float* tint3,
                             const float* diff3, const float* dtint3,
                             const float* ddiff3, float* dh) {
  const float n0 = hr[2], n1 = hr[3], n2 = hr[4];
  const float nrm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
  const float s = nrm + 1e-7f;
  const float m0 = -n0 / s, m1 = -n1 / s, m2 = -n2 / s;
  const float dn = dv[0] * m0 + dv[1] * m1 + dv[2] * m2;
  const float x = dv[0] - 2.f * dn * m0;
  const float y = dv[1] - 2.f * dn * m1;
  const float z = dv[2] - 2.f * dn * m2;
  const float rho = hr[0] - 1.f;
  const float rough = softplusf(rho);
  float gx = 0.f, gy = 0.f, gz = 0.f, grough = 0.f;
  int c = 0;
  for (int l = 1; l <= d.l_max; l *= 2) {
    float pr = 1.f, pi = 0.f;   // (x + iy)^m
    float qr = 0.f, qi = 0.f;   // (x + iy)^(m - 1), 0 at m = 0
    for (int m = 0; m <= l; ++m, ++c) {
      float vzm = 0.f, dvzm = 0.f, zp = 1.f, zq = 0.f;
      for (int i = 0; i <= d.l_max; ++i) {
        const float mc = mat[i * d.n_ch + c];
        vzm = fmaf(mc, zp, vzm);             // sum_i mat[i, c] z^i
        dvzm = fmaf(mc * (float)i, zq, dvzm);  // sum_i mat[i, c] i z^(i-1)
        zq = zp;
        zp *= z;
      }
      const float att = expf(-sig[c] * rough);
      const float gre = to_f(xr[d.nb + c]);
      const float gim = to_f(xr[d.nb + d.n_ch + c]);
      // out_re = (re vzm) att, out_im = (im vzm) att
      const float are = gre * att, aim = gim * att;
      const float dre = are * vzm, dim = aim * vzm;
      gz = fmaf(are * pr + aim * pi, dvzm, gz);
      gx += (float)m * (dre * qr + dim * qi);
      gy += (float)m * (dim * qr - dre * qi);
      grough += (gre * (pr * vzm) + gim * (pi * vzm)) * att * -sig[c];
      qr = pr;
      qi = pi;
      const float next = pr * x - pi * y;
      pi = pi * x + pr * y;
      pr = next;
    }
  }
  // reflect = d - (2 d.n) m; d.n = d . m, which also takes the trunk's row
  const float two_dn = 2.f * dn;
  const float gdn = to_f(xr[d.nb + 2 * d.n_ch])
      - 2.f * (gx * m0 + gy * m1 + gz * m2);
  const float gm0 = gn[0] - two_dn * gx + dv[0] * gdn;
  const float gm1 = gn[1] - two_dn * gy + dv[1] * gdn;
  const float gm2 = gn[2] - two_dn * gz + dv[2] * gdn;
  // m = -n / s, s = sqrt(|n|^2 + 1e-20) + 1e-7
  const float ds = (gm0 * n0 + gm1 * n1 + gm2 * n2) / (s * s);
  const float dq = ds * (0.5f / nrm);
  dh[0] = grough * expf(rho - rough);
  dh[1] = gden;
  dh[2] = -(gm0 / s) + 2.f * n0 * dq;
  dh[3] = -(gm1 / s) + 2.f * n1 * dq;
  dh[4] = -(gm2 / s) + 2.f * n2 * dq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dh[5 + k] = ddiff3[k] * (diff3[k] * (1.f - diff3[k]));
    dh[8 + k] = dtint3[k] * (tint3[k] * (1.f - tint3[k]));
  }
}

}  // namespace
