// Tile building blocks shared by the fused MLP kernels (fused_mlp.cu,
// fused_mlp_bwd.cu, ref_fused.cu, ref_fused_bwd.cu).
//
// One block of THREADS threads owns a tile of TM points.  Activations of the
// tile live in shared memory as (TM, width) row-major arrays in the compute
// dtype T (float or __nv_bfloat16).  Products accumulate in f32 on the CUDA
// cores: each thread holds an RPT x CPT register tile (its warp's RPT rows,
// CPT columns strided by 32), and a layer wider than CHUNK columns is done in
// passes of CHUNK.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mlp {

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
// (warp * RPT + i) and columns (c0 + lane + 32 j), with w an (k_dim, n_out)
// row-major matrix: the forward's product with an (in, out) matrix.  All
// lanes of a warp share their rows, so the shared-memory reads of `a` are
// broadcasts; the weight reads are 32 consecutive columns per warp.
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

// The transposed product of the backward, delta @ W^T: acc[i][j] +=
// sum_k a[row_i][k] * w[col_j][k], with w the layer's (n_out, k_dim) =
// (in, out) forward matrix.  Read directly, neighbouring lanes would read
// neighbouring rows of w; instead the block stages KC rows of W^T at a time
// in shared memory (``stage``, KC x stage_ld<T>() elements), loading each
// row segment of w with consecutive lanes, and the row stride is padded to
// an odd number of 4-byte words so the transposing stores do not collide.
// Holds __syncthreads(): every thread of the block must call it.
constexpr int KC = 32;

template <typename T>
__host__ __device__ constexpr int stage_ld() {
  return CHUNK + (sizeof(T) == 4 ? 1 : 2);
}

template <typename T>
__device__ __forceinline__ void accumulate_t(float (&acc)[RPT][CPT],
                                             const T* a, int k_dim,
                                             const T* __restrict__ w,
                                             int n_out, int c0, T* stage) {
  constexpr int LD = stage_ld<T>();
  const int lane = threadIdx.x & 31;
  const T* arow = a + (threadIdx.x >> 5) * RPT * k_dim;
  for (int k0 = 0; k0 < k_dim; k0 += KC) {
    const int kc = k_dim - k0 < KC ? k_dim - k0 : KC;
    __syncthreads();   // the previous pass is done reading the stage
    for (int idx = threadIdx.x; idx < KC * CHUNK; idx += THREADS) {
      const int kk = idx % KC, cc = idx / KC;
      const int c = c0 + cc;
      stage[kk * LD + cc] = kk < kc && c < n_out
          ? w[(size_t)c * k_dim + k0 + kk] : from_f<T>(0.f);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = to_f(stage[kk * LD + lane + 32 * j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float av = to_f(arow[i * k_dim + k0 + kk]);
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
      }
    }
  }
}

// Blocks per SM that the bf16 tile kernels are built for: two 8-warp blocks
// fit the shared memory of the width-256 tiles in bf16, and capping the
// registers at 128 a thread lets them both run.  The f32 tiles need twice
// the shared memory and run one block per SM.
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 2 ? 2 : 1;
};

__device__ __forceinline__ void zero(float (&acc)[RPT][CPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
}

// out = act(a0 @ w0 [+ a1 @ w1] + bias) for the whole tile, cast to T.
// a0, a1 and out are (TM, width) row-major in shared memory.  With STORE the
// tile's valid rows are also written to gout, an (n, n_out) array in device
// memory (rows row0 .. row0 + TM).
template <bool STORE, typename T>
__device__ void dense_tile(const T* a0, int k0, const T* __restrict__ w0,
                           const T* a1, int k1, const T* __restrict__ w1,
                           const float* __restrict__ bias, int n_out,
                           bool relu, T* out, T* __restrict__ gout,
                           int64_t row0, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
  for (int c0 = 0; c0 < n_out; c0 += CHUNK) {
    float acc[RPT][CPT];
    zero(acc);
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
        const T vt = from_f<T>(v);
        out[(r0 + i) * n_out + c] = vt;
        if (STORE && row0 + r0 + i < n) gout[(row0 + r0 + i) * n_out + c] = vt;
      }
    }
  }
}

// delta = mask(act) (a @ W^T [+ gs[row] * wcol[c]]) for the whole tile, where
// W is the layer's (n_out, k_dim) = (in, out) forward matrix, a the next
// layer's (TM, k_dim) delta in shared memory, act the stored (n, n_out)
// activation in device memory (null: no ReLU), and gs/wcol an optional K = 1
// outer-product term added in f32 before the mask.  With ADD the product is
// first rounded to T and added to what ``out`` holds (a sum of T-valued
// pullbacks that rounds after each add).  The result goes to shared memory
// in T (the operand of the next product) and, when gout is not null, its
// valid rows to gout, in OutT (T, or f32).  ``stage`` is the shared-memory
// stage of accumulate_t; every thread of the block must call this.
template <bool ADD = false, typename T, typename OutT>
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
        if (ADD) v = to_f(from_f<T>(v)) + to_f(out[t * n_out + c]);
        if (act != nullptr)
          v = (row < n && to_f(act[row * n_out + c]) > 0.f) ? v : 0.f;
        out[t * n_out + c] = from_f<T>(v);
        if (gout != nullptr && row < n) gout[row * n_out + c] = from_f<OutT>(v);
      }
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

// ptrs: the 10 device pointers of the weight tuple in the order of
// nerf_tpu/ops/fused_mlp.py:457 (w0 b0 w1 b1 w2 b2 w3 b3 wo bo).
template <typename T>
PropWeights<T> prop_weights(const uint64_t* ptrs) {
  PropWeights<T> p;
  p.w0 = (const T*)ptrs[0]; p.b0 = (const float*)ptrs[1];
  p.w1 = (const T*)ptrs[2]; p.b1 = (const float*)ptrs[3];
  p.w2 = (const T*)ptrs[4]; p.b2 = (const float*)ptrs[5];
  p.w3 = (const T*)ptrs[6]; p.b3 = (const float*)ptrs[7];
  p.wo = (const T*)ptrs[8]; p.bo = (const float*)ptrs[9];
  return p;
}

// ptrs: the 24 device pointers of the weight tuple in the order of
// nerf_tpu/ops/fused_mlp.py:79-92.
template <typename T>
VanillaWeights<T> vanilla_weights(const uint64_t* ptrs) {
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
  return p;
}

// Allow `bytes` of dynamic shared memory for `kernel`; a request beyond the
// card's limit (at wide layers) returns its error code, which is then cleared
// so that it does not surface at the next unrelated launch.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace mlp
