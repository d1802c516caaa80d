// Fused whole-network MLP forward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of nerf_tpu/ops/fused_mlp.py:
//   prop_mlp_fwd        <- _prop_fwd_kernel (:478) via make_prop_fused (:540)
//   prop_mlp_fwd_res    <- _prop_fwd_res_kernel (:483), the training forward
//                          of prop_store_residuals=True: the same network
//                          (the density equal to prop_mlp_fwd's bit for
//                          bit), and h1..h4 of every tile written to device
//                          memory in T for prop_mlp_bwd_res
//   vanilla_mlp_fwd     <- _vanilla_fwd_kernel (:128) over
//                          _vanilla_forward_tile (:96) via make_vanilla_fused
//                          (:305), the forward-only form
//   vanilla_mlp_fwd_res <- _vanilla_fwd_res_kernel (:150), the training
//                          forward of store_residuals=True: the same network,
//                          and the 9 activations h1 h2 h3 h4 z5 z6 z7 bvec r1
//                          of every tile written to device memory in T for
//                          the backward (fused_mlp_bwd.cu).
//
// The backward that reads those activations is fused_mlp_bwd.cu: it returns
// the f32 grads of every weight and bias (the encodings get none, being of
// detached sample points), casts each layer's delta to T as
// _vanilla_bwd_math (:195-246) does, and replaces the TPU's in-order
// `grad += partial` over the grid with three deterministic passes: a
// per-tile delta pass, a split-K weight-grad pass writing one f32 partial
// per split, and a reduction adding the partials in a fixed order.
//
// Contract (fused_mlp.py:96-125, :326-331): weight matrices (in, out)
// row-major in the compute dtype T, biases f32 of shape (1, W); products are
// accumulated in f32 and the bias added in f32; after every hidden layer the
// ReLU, then a cast to T.  The sigma/density head and the rgb logits stay
// f32; rgb goes through a sigmoid and leaves as (3, N) f32, sigma as (N,).
//
// Design.  One block of 256 threads owns a tile of TM = 64 points
// (mlp_tile.cuh).  It keeps the tile's inputs and two ping-pong activation
// buffers in shared memory across all layers; only rgb and sigma (and, in the
// res variant, the stored activations) are written.  The weights (about
// 0.55 MB in bf16 at width 256) are read from device memory by every block
// and stay in L2.  The skip concat [x, h4] and the rgb-layer concat
// [bvec, enc_d] are split products (x @ w4a + h4 @ w4b), as in the TPU
// kernel.  The ragged last tile is masked inside the kernel: rows past N load
// as zero and are not stored.
//
// Bound on an H100 SXM (700 W): the vanilla net costs 527,872 MACs per point
// and the proposal net 212,992.  The forward-only kernels move under 0.2 KB
// per point and are compute-bound (0.56 ms and 0.11 ms per 4096-ray chunk at
// the 989 TFLOP/s bf16 peak).  The vanilla res variant also writes 2,176
// activation values per point (4.35 KB in bf16): at N = 131,072 that is
// 0.17 ms of writes against 0.14 ms of bf16 tensor-core work, so it is bound
// by bytes; the proposal res variant writes 1,024 (2 KB in bf16), 0.04 ms at
// one step's N = 65,536 against 0.03 ms of work, bound by bytes as well.
// The hidden layers run through dense_tile (mlp_tile.cuh): in bf16 on the
// tensor cores (wgmma, each layer's weights brought by TMA into a 24 KB
// ring of shared memory after the two activation buffers: 102,400 bytes a
// block for the vanilla net and 98,304 for the proposal net at width 256,
// so two blocks share an SM), in f32 on the CUDA cores.  The narrow heads
// stay on the CUDA cores (head_tile).  The bf16 vanilla forwards run the
// persistent frame of vanilla_frame.cuh instead (128-point tiles, one block
// an SM, a producer that streams every layer's weights through one ring),
// and the bf16 proposal forwards that of prop_frame.cuh, or this 64-row
// tile at widths whose frame does not fit a block (vanilla_frame_body and
// prop_frame_body choose by shape before the launch; the entries report
// the body they launched).

#include "mlp_tile.cuh"
#include "prop_frame.cuh"

namespace {

using namespace mlp;

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

// Device pointers of the proposal net's 4 stored activations, (n, h) each.
template <typename T>
struct PropActs {
  T *h1, *h2, *h3, *h4;
};

// With STORE (prop_mlp_fwd_res) h1..h4 also go to s in device memory.
template <bool STORE, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
prop_mlp_fwd_kernel(const T* __restrict__ x, PropWeights<T> p, PropActs<T> s,
                    int64_t n, int dx, int h, float* __restrict__ out,
                    const __grid_constant__ TileMaps maps) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* buf_a = xs + TM * dx;
  T* buf_b = buf_a + TM * h;
  T* st = buf_b + TM * h;                 // dense_tile's weight stage
  T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  load_rows(x, dx, row0, n, xs);
  __syncthreads();
  dense_tile<STORE>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, s.h1, row0, n, st, &maps.map[0]);    // h1
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.h2, row0, n, st, &maps.map[1]);  // h2
  __syncthreads();
  dense_tile<STORE>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.h3, row0, n, st, &maps.map[2]);  // h3
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.h4, row0, n, st, &maps.map[3]);  // h4
  __syncthreads();
  head_tile(buf_b, h, p.wo, p.bo, 1, false, out, n, row0, n);
}

// Device pointers of the 9 stored activations, each (n, width) row-major.
template <typename T>
struct VanillaActs {
  T *h1, *h2, *h3, *h4, *z5, *z6, *z7, *bvec, *r1;
};

template <bool STORE, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
vanilla_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ d,
                       VanillaWeights<T> p, VanillaActs<T> s, int64_t n,
                       int dx, int dd, int h, int bn, int r, int maxw,
                       float* __restrict__ rgb3, float* __restrict__ sigma,
                       const __grid_constant__ TileMaps maps) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + TM * dx;
  T* buf_a = ds + TM * dd;
  T* buf_b = buf_a + TM * maxw;
  T* st = buf_b + TM * maxw;              // dense_tile's weight stage
  const T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  load_rows(x, dx, row0, n, xs);
  load_rows(d, dd, row0, n, ds);
  __syncthreads();
  dense_tile<STORE>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, s.h1, row0, n, st, &maps.map[0]);
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.h2, row0, n, st, &maps.map[1]);
  __syncthreads();
  dense_tile<STORE>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.h3, row0, n, st, &maps.map[2]);
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.h4, row0, n, st, &maps.map[3]);
  __syncthreads();
  dense_tile<STORE>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.z5, row0, n, st, &maps.map[4]);
  __syncthreads();
  dense_tile<STORE>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.z6, row0, n, st, &maps.map[6]);
  __syncthreads();
  dense_tile<STORE>(buf_b, h, p.w6, none, 0, none, p.b6, bn, true, buf_a, s.z7, row0, n, st, &maps.map[7]);
  __syncthreads();
  head_tile(buf_a, bn, p.wsig, p.bsig, 1, false, sigma, n, row0, n);   // sigma
  dense_tile<STORE>(buf_a, bn, p.wb, none, 0, none, p.bb, bn, false, buf_b, s.bvec, row0, n, st, &maps.map[8]);
  __syncthreads();
  dense_tile<STORE>(buf_b, bn, p.wr1a, ds, dd, p.wr1b, p.br1, r, true, buf_a, s.r1, row0, n, st, &maps.map[9]);
  __syncthreads();
  head_tile(buf_a, r, p.wr2, p.br2, 3, true, rgb3, n, row0, n);        // rgb
}

// acts: null for the forward-only kernel, else the 4 activation pointers
// h1 h2 h3 h4.
template <bool STORE, typename T>
int launch_prop(const void* x, const uint64_t* ptrs, int64_t n, int dx, int h,
                float* out, const uint64_t* acts, cudaStream_t stream) {
  const PropWeights<T> p = prop_weights<T>(ptrs);
  PropActs<T> s = {};
  if (STORE) {
    s.h1 = (T*)acts[0]; s.h2 = (T*)acts[1];
    s.h3 = (T*)acts[2]; s.h4 = (T*)acts[3];
  }
  if (!tile_widths_ok<T>({h})) return (int)cudaErrorInvalidValue;
  const size_t at = (size_t)TM * (dx + 2 * h) * sizeof(T);
  const size_t smem = at + dense_stage_bytes<T>(at);
  TileMaps maps;
  int err = prop_maps<T>(&maps, p, dx, h);
  if (err == 0) err = set_smem(prop_mlp_fwd_kernel<STORE, T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  prop_mlp_fwd_kernel<STORE, T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, p, s, n, dx, h, out, maps);
  return (int)cudaGetLastError();
}

// The proposal forward: in bf16 the frame where it fits (prop_frame_body),
// else, and in f32, the 64-row tile.  *body: the body launched, the
// frame's consumer warpgroups (1 or 2) or 0 for the 64-row tile.
template <bool STORE, typename T>
int launch_prop_fwd(const void* x, const uint64_t* ptrs, int64_t n, int dx,
                    int h, float* out, const uint64_t* acts, int* body,
                    cudaStream_t stream) {
  *body = 0;
  if constexpr (std::is_same<T, bf16_t>::value) {
    if (!tile_widths_ok<T>({h})) return (int)cudaErrorInvalidValue;
    FrameLayout L;
    size_t smem = 0;
    int sms = 0;
    const int err = prop_frame_body(dx, h, STORE, &L, &smem, &sms);
    if (err != 0) return err;
    if (smem != 0) {
      *body = L.cons;
      return launch_prop_frame<STORE>(x, ptrs, n, dx, h, out, acts, L, smem,
                                      sms, stream);
    }
  }
  return launch_prop<STORE, T>(x, ptrs, n, dx, h, out, acts, stream);
}

// acts: null for the forward-only kernel, else the 9 activation pointers in
// the order h1 h2 h3 h4 z5 z6 z7 bvec r1.
template <bool STORE, typename T>
int launch_vanilla(const void* x, const void* d, const uint64_t* ptrs,
                   int64_t n, const int* dims, float* rgb3, float* sigma,
                   const uint64_t* acts, cudaStream_t stream) {
  const VanillaWeights<T> p = vanilla_weights<T>(ptrs);
  VanillaActs<T> s = {};
  if (STORE) {
    s.h1 = (T*)acts[0]; s.h2 = (T*)acts[1]; s.h3 = (T*)acts[2];
    s.h4 = (T*)acts[3]; s.z5 = (T*)acts[4]; s.z6 = (T*)acts[5];
    s.z7 = (T*)acts[6]; s.bvec = (T*)acts[7]; s.r1 = (T*)acts[8];
  }
  const int dx = dims[0], dd = dims[1], h = dims[2], bn = dims[3], r = dims[4];
  int maxw = h > bn ? h : bn;
  maxw = maxw > r ? maxw : r;
  if (!tile_widths_ok<T>({h, bn, r})) return (int)cudaErrorInvalidValue;
  const size_t at = (size_t)TM * (dx + dd + 2 * maxw) * sizeof(T);
  const size_t smem = at + dense_stage_bytes<T>(at);
  TileMaps maps;
  int err = vanilla_maps<T>(&maps, p, dx, dd, h, bn, r);
  if (err == 0) err = set_smem(vanilla_mlp_fwd_kernel<STORE, T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  vanilla_mlp_fwd_kernel<STORE, T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)d, p, s, n, dx, dd, h, bn, r, maxw, rgb3, sigma,
      maps);
  return (int)cudaGetLastError();
}

// The vanilla forward: in bf16 the frame where it fits
// (vanilla_frame_body), else, and in f32, the 64-row tile.  *body: the body
// launched, the frame's consumer warpgroups (1 or 2) or 0 for the 64-row
// tile.
template <bool STORE, typename T>
int launch_vanilla_fwd(const void* x, const void* d, const uint64_t* ptrs,
                       int64_t n, const int* dims, float* rgb3, float* sigma,
                       const uint64_t* acts, int* body, cudaStream_t stream) {
  *body = 0;
  if constexpr (std::is_same<T, bf16_t>::value) {
    if (!tile_widths_ok<T>({dims[2], dims[3], dims[4]}))
      return (int)cudaErrorInvalidValue;
    FrameLayout L;
    size_t smem = 0;
    int sms = 0;
    const int err = vanilla_frame_body(dims, STORE, &L, &smem, &sms);
    if (err != 0) return err;
    if (smem != 0) {
      *body = L.cons;
      return launch_vanilla_frame<STORE>(x, d, ptrs, n, dims, rgb3, sigma,
                                         acts, L, smem, sms, stream);
    }
  }
  return launch_vanilla<STORE, T>(x, d, ptrs, n, dims, rgb3, sigma, acts,
                                  stream);
}

}  // namespace

extern "C" {

#define PROP_FWD(SUFFIX, T)                                                    \
  int prop_mlp_fwd_##SUFFIX(const void* x, const uint64_t* ptrs, int64_t n,    \
                            int dx, int h, void* out, int* body,               \
                            void* stream) {                                    \
    return launch_prop_fwd<false, T>(x, ptrs, n, dx, h, (float*)out, nullptr,  \
                                     body, (cudaStream_t)stream);              \
  }                                                                            \
  int prop_mlp_fwd_res_##SUFFIX(const void* x, const uint64_t* ptrs,           \
                                int64_t n, int dx, int h, void* out,           \
                                const uint64_t* acts, int* body,               \
                                void* stream) {                                \
    return launch_prop_fwd<true, T>(x, ptrs, n, dx, h, (float*)out, acts,      \
                                    body, (cudaStream_t)stream);               \
  }

PROP_FWD(f32, float)
PROP_FWD(bf16, __nv_bfloat16)

#define VANILLA_FWD(SUFFIX, T)                                                 \
  int vanilla_mlp_fwd_##SUFFIX(const void* x, const void* d,                   \
                               const uint64_t* ptrs, int64_t n,                \
                               const int* dims, void* rgb3, void* sigma,       \
                               int* body, void* stream) {                      \
    return launch_vanilla_fwd<false, T>(x, d, ptrs, n, dims, (float*)rgb3,     \
                                        (float*)sigma, nullptr, body,          \
                                        (cudaStream_t)stream);                 \
  }                                                                            \
  int vanilla_mlp_fwd_res_##SUFFIX(const void* x, const void* d,               \
                                   const uint64_t* ptrs, int64_t n,            \
                                   const int* dims, void* rgb3, void* sigma,   \
                                   const uint64_t* acts, int* body,            \
                                   void* stream) {                             \
    return launch_vanilla_fwd<true, T>(x, d, ptrs, n, dims, (float*)rgb3,      \
                                       (float*)sigma, acts, body,              \
                                       (cudaStream_t)stream);                  \
  }

VANILLA_FWD(f32, float)
VANILLA_FWD(bf16, __nv_bfloat16)

OCCUPANCY_ENTRY(fused_mlp)

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
