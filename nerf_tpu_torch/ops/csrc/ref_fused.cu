// Fused Ref-NeRF forward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of nerf_tpu/ops/ref_fused.py in the
// forward-only form that eval runs (make_ref_fused(need_grad=False), no
// stored activations):
//   ref_spa_fwd <- _make_spa_fwd_kernel (:643) over _spa_pure (:192): the
//                  spatial trunk (4 layers, the skip as a split product
//                  enc @ w4a + h4 @ w4b, 3 more layers, the last one O wide)
//                  and the three heads, written in f32 without rounding as
//                  heads (N, 11 + NB) = [rho_tau 2 | normal 3, diffuse 3,
//                  tint 3 | bottleneck NB].
//   ref_dir_fwd <- _make_dir_fwd_kernel (:841) over _dir_glue_pure_rowland
//                  (:575) with the recurrence IDE (hand_vjp=True, :380,
//                  :421): per point, in f32, the normal -n / (|n| + 1e-7)
//                  (with the 1e-20 of the grad-safe norm), d.n on the raw
//                  ray direction, the reflection d - 2 (d.n) n, roughness
//                  softplus(rho - 1), the IDE [Re | Im] of
//                  (x + iy)^m (z-powers @ mat) exp(-sigma roughness) with
//                  z^i and (x + iy)^m by repeated multiplication; then the
//                  directional trunk on x = [bottleneck + noise | IDE | d.n]
//                  (4 x H, the skip x @ w4a + h4 @ w4b, H, O, O) and
//                  rgb = sigmoid(z8 @ wh + bh) sigmoid(tint)
//                  + sigmoid(diffuse [- ln 3]) [-> sRGB].  Outputs rgb and
//                  normal (N, 3) and the density passthrough heads[:, 1], f32.
//
// Contract (ref_fused.py:51-75, :1031-1033): weight matrices (in, out)
// row-major in the compute dtype T (float or __nv_bfloat16), biases f32;
// products accumulate in f32 and the bias is added in f32; after every
// hidden layer the ReLU, then a cast to T.  The heads and the whole glue stay
// f32; the trunk input x is cast to T.  H (trunk width), O (output_dim), NB
// (bottleneck) and the IDE's l_max and channel count C are runtime
// dimensions: the skip and O-wide layers are not square at other widths.
//
// Design.  One block of 256 threads owns a tile of TM = 64 points
// (mlp_tile.cuh) and keeps its input row and two ping-pong activation
// buffers in shared memory across all layers; only the outputs are written.
// The glue runs one thread per point of the tile and writes the IDE and d.n
// straight into the tile's input row; the IDE tables (mat, sigma) are staged
// in shared memory.  The per-ray directions are read as dirs[row / P] for P
// samples per ray, so the (N, 3) broadcast never exists.  The narrow heads
// (rho_tau, normal/diffuse/tint, the 3-wide specular head) are one warp per
// (point, output) with a shuffle reduction; the bottleneck head is a
// register-tiled product like the hidden layers.  The ragged last tile is
// masked: rows past N load as zero and are not stored.
//
// Bound on an H100 SXM (700 W): at H = O = 256 the spatial net costs 526,592
// MACs per point and the directional 545,024 (+ 171 for the IDE's
// z-powers @ mat).  They move about 0.7 KB per point in bf16 (the 556-byte
// f32 heads out of one and into the other, the encoding, the outputs), so
// both are bound by operations: 0.84 and 0.87 ms per 4096-ray chunk
// (786,432 points) at the 989 TFLOP/s bf16 peak.  This first version
// multiplies on the CUDA cores in f32, not on the tensor cores; mma.sync /
// wgmma and TMA are later work.

#include "mlp_tile.cuh"

#include <float.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_spa_fwd_kernel(const T* __restrict__ x, RefSpaWeights<T> p, int64_t n,
                   int dx, int h, int o, int nb, int maxw,
                   float* __restrict__ heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* buf_a = xs + TM * dx;
  T* buf_b = buf_a + TM * maxw;
  T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t hw = HEAD_FIXED + nb;
  load_rows(x, dx, row0, n, xs);
  __syncthreads();
  dense_tile<false>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, none, row0, n);     // h1
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, none, row0, n);   // h2
  __syncthreads();
  dense_tile<false>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, none, row0, n);   // h3
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, none, row0, n);   // h4
  __syncthreads();
  dense_tile<false>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, none, row0, n); // z5
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, none, row0, n);   // z6
  __syncthreads();
  dense_tile<false>(buf_b, h, p.w6, none, 0, none, p.b6, h, true, buf_a, none, row0, n);   // z7
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w7, none, 0, none, p.b7, o, true, buf_b, none, row0, n);   // inter
  __syncthreads();
  narrow_head(buf_b, o, p.wrt, p.brt, 2, false, heads, hw, 0, row0, n);
  narrow_head(buf_b, o, p.wnct, p.bnct, 9, false, heads, hw, 2, row0, n);
  wide_head(buf_b, o, p.wbn, p.bbn, nb, heads, hw, HEAD_FIXED, row0, n);
}

// The pre-trunk glue of one point (_dir_glue_prelude_rowland, ref_fused.py
// :543-572) into its row xr of the tile's input: the IDE in columns
// [nb, nb + 2C), d.n in column nb + 2C; sigmoid(tint) and
// sigmoid(diffuse [- ln 3]) into tint3 and diff3; the normal and the density
// passthrough to device memory.
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
  nrm_out[0] = m0;
  nrm_out[1] = m1;
  nrm_out[2] = m2;
  *den_out = hr[1];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_dir_fwd_kernel(const float* __restrict__ heads, const T* __restrict__ noise,
                   const float* __restrict__ dirs, int64_t per_ray,
                   const float* __restrict__ mat,
                   const float* __restrict__ sigma, RefDirWeights<T> p,
                   int64_t n, DirDims d, float* __restrict__ rgb,
                   float* __restrict__ normal, float* __restrict__ density) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* buf_a = xs + TM * d.dd;
  T* buf_b = buf_a + TM * d.maxw;
  float* mat_s = reinterpret_cast<float*>(buf_b + TM * d.maxw);
  float* sig_s = mat_s + (d.l_max + 1) * d.n_ch;
  float* tint_s = sig_s + d.n_ch;      // (TM, 3) sigmoid(tint)
  float* diff_s = tint_s + TM * 3;     // (TM, 3) sigmoid(diffuse [- ln 3])
  float* spec_s = diff_s + TM * 3;     // (TM, 3) specular
  T* none = nullptr;
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
      dir_glue(heads + row * hw, dirs + (row / per_ray) * 3, mat_s, sig_s, d,
               xr, tint_s + r * 3, diff_s + r * 3, normal + row * 3,
               density + row);
    } else {
      for (int c = d.nb; c < d.dd; ++c) xr[c] = from_f<T>(0.f);
      for (int k = 0; k < 3; ++k) tint_s[r * 3 + k] = diff_s[r * 3 + k] = 0.f;
    }
  }
  __syncthreads();
  const int h = d.h, o = d.o, dd = d.dd;
  dense_tile<false>(xs, dd, p.w0, none, 0, none, p.b0, h, true, buf_a, none, row0, n);     // h1
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, none, row0, n);   // h2
  __syncthreads();
  dense_tile<false>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, none, row0, n);   // h3
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, none, row0, n);   // h4
  __syncthreads();
  dense_tile<false>(xs, dd, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, none, row0, n); // z5
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, none, row0, n);   // z6
  __syncthreads();
  dense_tile<false>(buf_b, h, p.w6, none, 0, none, p.b6, o, true, buf_a, none, row0, n);   // z7
  __syncthreads();
  dense_tile<false>(buf_a, o, p.w7, none, 0, none, p.b7, o, true, buf_b, none, row0, n);   // z8
  __syncthreads();
  narrow_head(buf_b, o, p.wh, p.bh, 3, true, spec_s, 3, 0, 0, TM);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const int64_t row = row0 + idx / 3;
    if (row >= n) continue;
    const float v = spec_s[idx] * tint_s[idx] + diff_s[idx];
    rgb[row0 * 3 + idx] = d.srgb ? srgbf(v) : v;
  }
}

template <typename T>
int launch_spa(const void* x, const uint64_t* ptrs, int64_t n,
               const int* dims, float* heads, cudaStream_t stream) {
  const RefSpaWeights<T> p = spa_weights<T>(ptrs);
  const int dx = dims[0], h = dims[1], o = dims[2], nb = dims[3];
  const int maxw = h > o ? h : o;
  const size_t smem = (size_t)TM * (dx + 2 * maxw) * sizeof(T);
  int err = set_smem(ref_spa_fwd_kernel<T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  ref_spa_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, p, n, dx, h, o, nb, maxw, heads);
  return (int)cudaGetLastError();
}

// dims: nb h o l_max n_ch use_srgb
template <typename T>
int launch_dir(const void* heads, const void* noise, const void* dirs,
               int64_t per_ray, const void* mat, const void* sigma,
               const uint64_t* ptrs, int64_t n, const int* dims, float* rgb,
               float* normal, float* density, cudaStream_t stream) {
  const RefDirWeights<T> p = dir_weights<T>(ptrs);
  DirDims d;
  d.nb = dims[0];
  d.h = dims[1];
  d.o = dims[2];
  d.l_max = dims[3];
  d.n_ch = dims[4];
  d.srgb = dims[5];
  d.dd = d.nb + 2 * d.n_ch + 1;
  d.maxw = d.h > d.o ? d.h : d.o;
  const size_t smem = (size_t)TM * (d.dd + 2 * d.maxw) * sizeof(T)
      + (size_t)((d.l_max + 1) * d.n_ch + d.n_ch + 9 * TM) * sizeof(float);
  int err = set_smem(ref_dir_fwd_kernel<T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  ref_dir_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const float*)heads, (const T*)noise, (const float*)dirs, per_ray,
      (const float*)mat, (const float*)sigma, p, n, d, rgb, normal, density);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: dx h o nb
int ref_spa_fwd_f32(const void* x, const uint64_t* ptrs, int64_t n,
                    const int* dims, void* heads, void* stream) {
  return launch_spa<float>(x, ptrs, n, dims, (float*)heads,
                           (cudaStream_t)stream);
}

int ref_spa_fwd_bf16(const void* x, const uint64_t* ptrs, int64_t n,
                     const int* dims, void* heads, void* stream) {
  return launch_spa<__nv_bfloat16>(x, ptrs, n, dims, (float*)heads,
                                   (cudaStream_t)stream);
}

int ref_dir_fwd_f32(const void* heads, const void* noise, const void* dirs,
                    int64_t per_ray, const void* mat, const void* sigma,
                    const uint64_t* ptrs, int64_t n, const int* dims,
                    void* rgb, void* normal, void* density, void* stream) {
  return launch_dir<float>(heads, noise, dirs, per_ray, mat, sigma, ptrs, n,
                           dims, (float*)rgb, (float*)normal, (float*)density,
                           (cudaStream_t)stream);
}

int ref_dir_fwd_bf16(const void* heads, const void* noise, const void* dirs,
                     int64_t per_ray, const void* mat, const void* sigma,
                     const uint64_t* ptrs, int64_t n, const int* dims,
                     void* rgb, void* normal, void* density, void* stream) {
  return launch_dir<__nv_bfloat16>(heads, noise, dirs, per_ray, mat, sigma,
                                   ptrs, n, dims, (float*)rgb, (float*)normal,
                                   (float*)density, (cudaStream_t)stream);
}

const char* ref_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
