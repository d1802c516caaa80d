// Fused whole-network MLP forward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of nerf_tpu/ops/fused_mlp.py:
//   prop_mlp_fwd    <- _prop_fwd_kernel (:478) via make_prop_fused (:540)
//   vanilla_mlp_fwd <- _vanilla_fwd_kernel (:128) over _vanilla_forward_tile
//                      (:96) via make_vanilla_fused (:305)
// both in their forward-only form (store_residuals=False).
//
// Contract (fused_mlp.py:96-125, :326-331): weight matrices (in, out)
// row-major in the compute dtype T, biases f32 of shape (1, W); products are
// accumulated in f32 and the bias added in f32; after every hidden layer the
// ReLU, then a cast to T.  The sigma/density head and the rgb logits stay
// f32; rgb goes through a sigmoid and leaves as (3, N) f32, sigma as (N,).
//
// Design.  One block of 256 threads owns a tile of TM = 64 points.  It keeps
// the tile's inputs and two ping-pong activation buffers in shared memory
// across all layers, so no activation touches device memory; only rgb and
// sigma are written.  The weights (about 0.55 MB in bf16 at width 256) are
// read from device memory by every block and stay in L2.  The skip concat
// [x, h4] and the rgb-layer concat [bvec, enc_d] are split products
// (x @ w4a + h4 @ w4b), as in the TPU kernel.  The ragged last tile is masked
// inside the kernel: rows past N load as zero and are not stored.
//
// Bound on an H100 SXM (700 W): the vanilla net costs 527,872 MACs per
// point and the proposal net 212,992, against under 0.2 KB of device-memory
// traffic per point: both are compute-bound (0.56 ms and 0.11 ms per
// 4096-ray chunk at the 989 TFLOP/s bf16 peak).  This first version multiplies
// on the CUDA cores in f32 (each thread accumulates an 8 x 8 register tile),
// not on the tensor cores; mma.sync / wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;                    // points per block
constexpr int THREADS = 256;              // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPT = TM / WARPS;           // rows per thread (one warp = 8 rows)
constexpr int CPT = 8;                    // columns per thread per chunk
constexpr int CHUNK = 32 * CPT;           // output columns per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc[i][j] += sum_k a[row_i][k] * w[k][col_j] for this thread's rows
// (ty * RPT + i) and columns (c0 + lane + 32 j).  All lanes of a warp share
// their rows, so the shared-memory reads of `a` are broadcasts; the weight
// reads are 32 consecutive columns per warp.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[RPT][CPT], const T* a,
                                           int k_dim, const T* __restrict__ w,
                                           int n_out, int c0) {
  const int lane = threadIdx.x & 31;
  const T* arow = a + (threadIdx.x >> 5) * RPT * k_dim;
  for (int k = 0; k < k_dim; ++k) {
    float wv[CPT];
    const T* wk = w + (size_t)k * n_out;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + lane + 32 * j;
      wv[j] = c < n_out ? to_f(wk[c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float av = to_f(arow[i * k_dim + k]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
    }
  }
}

// out = act(a0 @ w0 [+ a1 @ w1] + bias) for the whole tile, cast to T.
// a0, a1 and out are (TM, width) row-major in shared memory.
template <typename T>
__device__ void dense_tile(const T* a0, int k0, const T* __restrict__ w0,
                           const T* a1, int k1, const T* __restrict__ w1,
                           const float* __restrict__ bias, int n_out,
                           bool relu, T* out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
  for (int c0 = 0; c0 < n_out; c0 += CHUNK) {
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    accumulate(acc, a0, k0, w0, n_out, c0);
    if (a1 != nullptr) accumulate(acc, a1, k1, w1, n_out, c0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c >= n_out) continue;
      const float b = bias[c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float v = acc[i][j] + b;
        if (relu) v = fmaxf(v, 0.f);
        out[(r0 + i) * n_out + c] = from_f<T>(v);
      }
    }
  }
}

// Narrow f32 head: dst[o * stride + row] = act(a[row] @ w[:, o] + bias[o]).
// One warp per (row, o): lanes stride over k and reduce with shuffles.
template <typename T>
__device__ void head_tile(const T* a, int k_dim, const T* __restrict__ w,
                          const float* __restrict__ bias, int n_out,
                          bool sigmoid, float* __restrict__ dst,
                          int64_t stride, int64_t row0, int64_t n) {
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
      if (sigmoid) v = 1.f / (1.f + expf(-v));
      dst[o * stride + row0 + r] = v;
    }
  }
}

// Rows [row0, row0 + TM) of a (n, width) row-major array into shared
// memory; rows past n are zero.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int width, int64_t row0,
                          int64_t n, T* dst) {
  const int64_t valid = n - row0 < TM ? n - row0 : TM;
  const T* base = src + row0 * width;
  for (int idx = threadIdx.x; idx < TM * width; idx += THREADS)
    dst[idx] = idx < valid * width ? base[idx] : from_f<T>(0.f);
}

template <typename T>
struct PropWeights {
  const T *w0, *w1, *w2, *w3, *wo;
  const float *b0, *b1, *b2, *b3, *bo;
};

template <typename T>
struct VanillaWeights {
  const T *w0, *w1, *w2, *w3, *w4a, *w4b, *w5, *w6, *wsig, *wb, *wr1a, *wr1b,
      *wr2;
  const float *b0, *b1, *b2, *b3, *b4, *b5, *b6, *bsig, *bb, *br1, *br2;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
prop_mlp_fwd_kernel(const T* __restrict__ x, PropWeights<T> p, int64_t n,
                    int dx, int h, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* buf_a = xs + TM * dx;
  T* buf_b = buf_a + TM * h;
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  load_rows(x, dx, row0, n, xs);
  __syncthreads();
  dense_tile(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a);       // h1
  __syncthreads();
  dense_tile(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b);     // h2
  __syncthreads();
  dense_tile(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a);     // h3
  __syncthreads();
  dense_tile(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b);     // h4
  __syncthreads();
  head_tile(buf_b, h, p.wo, p.bo, 1, false, out, n, row0, n);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
vanilla_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ d,
                       VanillaWeights<T> p, int64_t n, int dx, int dd, int h,
                       int bn, int r, int maxw, float* __restrict__ rgb3,
                       float* __restrict__ sigma) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + TM * dx;
  T* buf_a = ds + TM * dd;
  T* buf_b = buf_a + TM * maxw;
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  load_rows(x, dx, row0, n, xs);
  load_rows(d, dd, row0, n, ds);
  __syncthreads();
  dense_tile(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a);       // h1
  __syncthreads();
  dense_tile(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b);     // h2
  __syncthreads();
  dense_tile(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a);     // h3
  __syncthreads();
  dense_tile(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b);     // h4
  __syncthreads();
  dense_tile(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a);    // z5
  __syncthreads();
  dense_tile(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b);     // z6
  __syncthreads();
  dense_tile(buf_b, h, p.w6, none, 0, none, p.b6, bn, true, buf_a);    // z7
  __syncthreads();
  head_tile(buf_a, bn, p.wsig, p.bsig, 1, false, sigma, n, row0, n);   // sigma
  dense_tile(buf_a, bn, p.wb, none, 0, none, p.bb, bn, false, buf_b);  // bvec
  __syncthreads();
  dense_tile(buf_b, bn, p.wr1a, ds, dd, p.wr1b, p.br1, r, true, buf_a);  // r1
  __syncthreads();
  head_tile(buf_a, r, p.wr2, p.br2, 3, true, rgb3, n, row0, n);        // rgb
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ptrs: the 10 device pointers of the weight tuple in the order of
// fused_mlp.py:457 (w0 b0 w1 b1 w2 b2 w3 b3 wo bo).
template <typename T>
int launch_prop(const void* x, const uint64_t* ptrs, int64_t n, int dx, int h,
                float* out, cudaStream_t stream) {
  PropWeights<T> p;
  p.w0 = (const T*)ptrs[0]; p.b0 = (const float*)ptrs[1];
  p.w1 = (const T*)ptrs[2]; p.b1 = (const float*)ptrs[3];
  p.w2 = (const T*)ptrs[4]; p.b2 = (const float*)ptrs[5];
  p.w3 = (const T*)ptrs[6]; p.b3 = (const float*)ptrs[7];
  p.wo = (const T*)ptrs[8]; p.bo = (const float*)ptrs[9];
  const size_t smem = (size_t)TM * (dx + 2 * h) * sizeof(T);
  int err = set_smem(prop_mlp_fwd_kernel<T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  prop_mlp_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, p, n, dx, h, out);
  return (int)cudaGetLastError();
}

// ptrs: the 24 device pointers of the weight tuple in the order of
// fused_mlp.py:79-92.
template <typename T>
int launch_vanilla(const void* x, const void* d, const uint64_t* ptrs,
                   int64_t n, const int* dims, float* rgb3, float* sigma,
                   cudaStream_t stream) {
  VanillaWeights<T> p;
  p.w0 = (const T*)ptrs[0];    p.b0 = (const float*)ptrs[1];
  p.w1 = (const T*)ptrs[2];    p.b1 = (const float*)ptrs[3];
  p.w2 = (const T*)ptrs[4];    p.b2 = (const float*)ptrs[5];
  p.w3 = (const T*)ptrs[6];    p.b3 = (const float*)ptrs[7];
  p.w4a = (const T*)ptrs[8];   p.w4b = (const T*)ptrs[9];
  p.b4 = (const float*)ptrs[10];
  p.w5 = (const T*)ptrs[11];   p.b5 = (const float*)ptrs[12];
  p.w6 = (const T*)ptrs[13];   p.b6 = (const float*)ptrs[14];
  p.wsig = (const T*)ptrs[15]; p.bsig = (const float*)ptrs[16];
  p.wb = (const T*)ptrs[17];   p.bb = (const float*)ptrs[18];
  p.wr1a = (const T*)ptrs[19]; p.wr1b = (const T*)ptrs[20];
  p.br1 = (const float*)ptrs[21];
  p.wr2 = (const T*)ptrs[22];  p.br2 = (const float*)ptrs[23];
  const int dx = dims[0], dd = dims[1], h = dims[2], bn = dims[3], r = dims[4];
  int maxw = h > bn ? h : bn;
  maxw = maxw > r ? maxw : r;
  const size_t smem = (size_t)TM * (dx + dd + 2 * maxw) * sizeof(T);
  int err = set_smem(vanilla_mlp_fwd_kernel<T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  vanilla_mlp_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)d, p, n, dx, dd, h, bn, r, maxw, rgb3, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int prop_mlp_fwd_f32(const void* x, const uint64_t* ptrs, int64_t n, int dx,
                     int h, void* out, void* stream) {
  return launch_prop<float>(x, ptrs, n, dx, h, (float*)out,
                            (cudaStream_t)stream);
}

int prop_mlp_fwd_bf16(const void* x, const uint64_t* ptrs, int64_t n, int dx,
                      int h, void* out, void* stream) {
  return launch_prop<__nv_bfloat16>(x, ptrs, n, dx, h, (float*)out,
                                    (cudaStream_t)stream);
}

int vanilla_mlp_fwd_f32(const void* x, const void* d, const uint64_t* ptrs,
                        int64_t n, const int* dims, void* rgb3, void* sigma,
                        void* stream) {
  return launch_vanilla<float>(x, d, ptrs, n, dims, (float*)rgb3,
                               (float*)sigma, (cudaStream_t)stream);
}

int vanilla_mlp_fwd_bf16(const void* x, const void* d, const uint64_t* ptrs,
                         int64_t n, const int* dims, void* rgb3, void* sigma,
                         void* stream) {
  return launch_vanilla<__nv_bfloat16>(x, d, ptrs, n, dims, (float*)rgb3,
                                       (float*)sigma, (cudaStream_t)stream);
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
