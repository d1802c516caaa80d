// Fused Ref-NeRF forward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of nerf_tpu/ops/ref_fused.py:
//   ref_spa_fwd     <- _make_spa_fwd_kernel (:643) over _spa_pure (:192), the
//                      eval form (need_grad=False, no stored activations): the
//                      spatial trunk (4 layers, the skip as a split product
//                      enc @ w4a + h4 @ w4b, 3 more layers, the last one O
//                      wide) and the three heads, written in f32 without
//                      rounding as heads (N, 11 + NB) = [rho_tau 2 | normal 3,
//                      diffuse 3, tint 3 | bottleneck NB].
//   ref_spa_fwd_res <- the same kernel's training form (need_grad=True,
//                      store_acts=True, :653-697): the heads, the 8
//                      activations h1..h4 z5 z6 z7 inter stored in T, and the
//                      normal target.  The TPU kernel takes d(density)/d(enc)
//                      with jax.vjp of the density column alone (has_aux:
//                      no other head's cotangent enters); here it is written
//                      out: from wrt[:, 1] down w7^T .. w4b^T, w3^T .. w1^T,
//                      each product cast to T and masked by its stored
//                      activation, the two pullbacks into the encoding
//                      (w0^T and w4a^T) each cast to T and summed in f32,
//                      then the encoding's transpose g = denc[:3] +
//                      (denc[3:] cos(pos @ pe_w + pe_b)) @ pe_w^T and the
//                      target -g / max(1e-5, |g|), in f32.
//   ref_dir_fwd     <- _make_dir_fwd_kernel (:841) over _dir_glue_pure_rowland
//   ref_dir_fwd_res    (:575) with the recurrence IDE (hand_vjp=True, :380,
//                      :421), without and with the 8 stored activations
//                      h1..h4 z5 z6 (H wide) z7 z8 (O wide): per point, in
//                      f32, the normal -n / (|n| + 1e-7) (with the 1e-20 of
//                      the grad-safe norm), d.n on the raw ray direction, the
//                      reflection d - 2 (d.n) n, roughness softplus(rho - 1),
//                      the IDE [Re | Im] of (x + iy)^m (z-powers @ mat)
//                      exp(-sigma roughness) with z^i and (x + iy)^m by
//                      repeated multiplication; then the directional trunk on
//                      x = [bottleneck + noise | IDE | d.n] (4 x H, the skip
//                      x @ w4a + h4 @ w4b, H, O, O) and
//                      rgb = sigmoid(z8 @ wh + bh) sigmoid(tint)
//                      + sigmoid(diffuse [- ln 3]) [-> sRGB].  Outputs rgb and
//                      normal (N, 3) and the density passthrough heads[:, 1],
//                      f32.  Its code is in ref_dir_fwd.cuh, which the
//                      dissection (ref_dissect.cu) compiles too.
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
// buffers in shared memory across all layers; only the outputs (and the
// stored activations) are written.  The glue runs one thread per point of the
// tile and writes the IDE and d.n straight into the tile's input row; the IDE
// tables (mat, sigma) are staged in shared memory.  The per-ray directions
// are read as dirs[row / P] for P samples per ray, so the (N, 3) broadcast
// never exists.  The narrow heads are one warp per (point, output) with a
// shuffle reduction; the bottleneck head is a register-tiled product like the
// hidden layers.  The density gradient of ref_spa_fwd_res runs in the same
// block after the forward, its ReLU masks read back from the activations the
// block just stored, its transposed products staged as in the backwards
// (accumulate_t).  The positional encoding's cosines use cosf, whose range
// reduction holds at the 2^9 |x| of the top frequency.  The ragged last tile
// is masked: rows past N load as zero and are not stored.
//
// Bound on an H100 SXM (700 W): at H = O = 256 the spatial net costs 526,592
// MACs per point and the directional 545,024 (+ 171 for the IDE's
// z-powers @ mat); the density gradient adds 491,520 (+ 360 for the encoding's
// transpose).  The eval forwards move about 0.7 KB per point in bf16 and are
// bound by operations: 0.84 and 0.87 ms per 4096-ray chunk (786,432 points)
// at the 989 TFLOP/s bf16 peak.  The training forwards also write 4 KB of
// activations per point in bf16.  This first version multiplies on the CUDA
// cores in f32, not on the tensor cores; mma.sync / wgmma and TMA are later
// work.

#include "ref_common.cuh"
#include "ref_dir_fwd.cuh"

namespace {

using namespace mlp;

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

// enc_grad = [enc_grad +] (a @ W^T rounded to T), f32, for the whole tile:
// a pullback into the encoding, W the layer's (n_out = dx, k_dim) forward
// matrix.  Every thread of the block must call this.
template <bool ADD, typename T>
__device__ void enc_pull(const T* a, int k_dim, const T* __restrict__ w,
                         int n_out, float* enc_grad, T* stage) {
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
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float* e = enc_grad + (r0 + i) * n_out + c;
        const float v = to_f(from_f<T>(acc[i][j]));
        *e = ADD ? *e + v : v;
      }
    }
  }
}

// Bytes of the encoding tile of ref_spa_fwd_res_kernel<false>: the f32
// d(density)/d(enc) tile is laid over the masks of z5 z6 z7 inter and the
// encoding tile, all dead once it is first written (after z5's pullback), so
// the tile is padded where those are smaller than it.  At H = O = 256 in
// bf16 that keeps the block at 106 KB of shared memory: two fit an SM.
__host__ __device__ inline size_t grad_xs_bytes(int dx, int h, int o,
                                                size_t t_size) {
  const size_t tail =
      (size_t)TM * (3 * mask_words(h) + mask_words(o)) * sizeof(uint32_t);
  const size_t xs = (size_t)TM * dx * t_size;
  const size_t denc = (size_t)TM * dx * sizeof(float);
  const size_t need = denc > tail + xs ? denc - tail : xs;
  return (need + 15) & ~(size_t)15;
}

// The training forward of the spatial net.  With STORE (ref_spa_fwd_res)
// the 8 activations go to s in device memory and the density pullback reads
// its ReLU masks back from them; without (ref_spa_fwd_grad) nothing of the
// trunk leaves the block: each layer's mask is kept as bits in shared
// memory (dense_tile's MASK, 8 words a row at width 256), which is all the
// pullback needs of an activation.
template <bool STORE, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_spa_fwd_res_kernel(const T* __restrict__ x, const float* __restrict__ pos,
                       const float* __restrict__ pe_w,
                       const float* __restrict__ pe_b, RefSpaWeights<T> p,
                       int64_t n, int dx, int h, int o, int nb, int maxw,
                       Acts<T> s, float* __restrict__ heads,
                       float* __restrict__ dgrad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hwd = TM * mask_words(h);             // mask words of an H layer
  uint32_t* mb = reinterpret_cast<uint32_t*>(smem);
  uint32_t* m[8];                                 // h1..h4 z5 z6 z7 inter
  for (int i = 0; i < 8; ++i) m[i] = STORE ? nullptr : mb + i * hwd;
  // (TM, dx) d(density)/d(enc): first in STORE, else over dead masks
  float* denc = STORE ? reinterpret_cast<float*>(smem)
                      : reinterpret_cast<float*>(mb + 4 * hwd);
  T* xs = STORE ? reinterpret_cast<T*>(denc + TM * dx)
                : reinterpret_cast<T*>(mb + 7 * hwd + TM * mask_words(o));
  T* buf_a = STORE ? xs + TM * dx
      : reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(xs)
                             + grad_xs_bytes(dx, h, o, sizeof(T)));
  T* buf_b = buf_a + TM * maxw;
  T* unit = buf_b + TM * maxw;                    // (TM, 2) rows [0, 1]
  T* st = unit + TM * 2;                          // the W^T stage
  const T* none = nullptr;
  T* drop = nullptr;                              // deltas not stored
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t hw = HEAD_FIXED + nb;
  load_rows(x, dx, row0, n, xs);
  for (int t = threadIdx.x; t < TM; t += THREADS) {
    unit[2 * t] = from_f<T>(0.f);
    unit[2 * t + 1] = from_f<T>(1.f);
  }
  __syncthreads();
  constexpr bool MK = !STORE;
  dense_tile<STORE, T, MK>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, s.a[0], row0, n, m[0]);     // h1
  __syncthreads();
  dense_tile<STORE, T, MK>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.a[1], row0, n, m[1]);   // h2
  __syncthreads();
  dense_tile<STORE, T, MK>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.a[2], row0, n, m[2]);   // h3
  __syncthreads();
  dense_tile<STORE, T, MK>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.a[3], row0, n, m[3]);   // h4
  __syncthreads();
  dense_tile<STORE, T, MK>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.a[4], row0, n, m[4]); // z5
  __syncthreads();
  dense_tile<STORE, T, MK>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.a[5], row0, n, m[5]);   // z6
  __syncthreads();
  dense_tile<STORE, T, MK>(buf_b, h, p.w6, none, 0, none, p.b6, h, true, buf_a, s.a[6], row0, n, m[6]);   // z7
  __syncthreads();
  dense_tile<STORE, T, MK>(buf_a, h, p.w7, none, 0, none, p.b7, o, true, buf_b, s.a[7], row0, n, m[7]);   // inter
  __syncthreads();
  narrow_head(buf_b, o, p.wrt, p.brt, 2, false, heads, hw, 0, row0, n);
  narrow_head(buf_b, o, p.wnct, p.bnct, 9, false, heads, hw, 2, row0, n);
  wide_head(buf_b, o, p.wbn, p.bbn, nb, heads, hw, HEAD_FIXED, row0, n);
  __syncthreads();   // also makes the stored activations visible to the block
  // the density column's pullback: [0, 1] @ wrt^T = wrt[:, 1], then the trunk
  delta_tile<false, T, T, MK>(unit, 2, p.wrt, o, s.a[7], none, none, buf_a, drop, row0, n, st, m[7]);    // inter
  __syncthreads();
  delta_tile<false, T, T, MK>(buf_a, o, p.w7, h, s.a[6], none, none, buf_b, drop, row0, n, st, m[6]);    // z7
  __syncthreads();
  delta_tile<false, T, T, MK>(buf_b, h, p.w6, h, s.a[5], none, none, buf_a, drop, row0, n, st, m[5]);    // z6
  __syncthreads();
  delta_tile<false, T, T, MK>(buf_a, h, p.w5, h, s.a[4], none, none, buf_b, drop, row0, n, st, m[4]);    // z5
  __syncthreads();
  enc_pull<false>(buf_b, h, p.w4a, dx, denc, st);
  delta_tile<false, T, T, MK>(buf_b, h, p.w4b, h, s.a[3], none, none, buf_a, drop, row0, n, st, m[3]);   // h4
  __syncthreads();
  delta_tile<false, T, T, MK>(buf_a, h, p.w3, h, s.a[2], none, none, buf_b, drop, row0, n, st, m[2]);    // h3
  __syncthreads();
  delta_tile<false, T, T, MK>(buf_b, h, p.w2, h, s.a[1], none, none, buf_a, drop, row0, n, st, m[1]);    // h2
  __syncthreads();
  delta_tile<false, T, T, MK>(buf_a, h, p.w1, h, s.a[0], none, none, buf_b, drop, row0, n, st, m[0]);    // h1
  __syncthreads();
  enc_pull<true>(buf_b, h, p.w0, dx, denc, st);
  __syncthreads();
  // the encoding's transpose and the normalization, one thread per point;
  // pe_w is (3, pc) row-major, pc = dx - 3
  const int pc = dx - 3;
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    const int64_t row = row0 + r;
    if (row >= n) continue;
    const float* dr = denc + r * dx;
    const float* pr = pos + row * 3;
    float g0 = dr[0], g1 = dr[1], g2 = dr[2];
    for (int j = 0; j < pc; ++j) {
      const float w0 = pe_w[j], w1 = pe_w[pc + j], w2 = pe_w[2 * pc + j];
      const float proj = pr[0] * w0 + pr[1] * w1 + pr[2] * w2 + pe_b[j];
      const float v = dr[3 + j] * cosf(proj);
      g0 = fmaf(v, w0, g0);
      g1 = fmaf(v, w1, g1);
      g2 = fmaf(v, w2, g2);
    }
    const float norm = fmaxf(1e-5f, sqrtf(g0 * g0 + g1 * g1 + g2 * g2));
    dgrad[row * 3] = -(g0 / norm);
    dgrad[row * 3 + 1] = -(g1 / norm);
    dgrad[row * 3 + 2] = -(g2 / norm);
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

// dims: dx h o nb; acts: the 8 (n, width) outputs h1..h4 z5 z6 z7 inter,
// or null (ref_spa_fwd_grad: the masks stay on chip)
template <typename T>
int launch_spa_res(const void* x, const void* pos, const void* pe_w,
                   const void* pe_b, const uint64_t* ptrs, int64_t n,
                   const int* dims, float* heads, float* dgrad,
                   const uint64_t* acts, cudaStream_t stream) {
  const RefSpaWeights<T> p = spa_weights<T>(ptrs);
  const int dx = dims[0], h = dims[1], o = dims[2], nb = dims[3];
  const int maxw = h > o ? h : o;
  const bool store = acts != nullptr;
  const size_t tail = ((size_t)TM * (2 * maxw + 2) + KC * stage_ld<T>())
      * sizeof(T);                                // buf_a buf_b unit stage
  const size_t smem = store
      ? (size_t)TM * dx * (sizeof(float) + sizeof(T)) + tail
      : (size_t)TM * (7 * mask_words(h) + mask_words(o)) * sizeof(uint32_t)
        + grad_xs_bytes(dx, h, o, sizeof(T)) + tail;
  auto kernel = store ? ref_spa_fwd_res_kernel<true, T>
                      : ref_spa_fwd_res_kernel<false, T>;
  int err = set_smem(kernel, smem);
  if (err != 0 || n == 0) return err;
  Acts<T> s = {};
  if (store) s = acts_of<T>(acts);
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)pos, (const float*)pe_w,
      (const float*)pe_b, p, n, dx, h, o, nb, maxw, s, heads, dgrad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define REF_FWD(SUFFIX, T)                                                     \
  int ref_spa_fwd_##SUFFIX(const void* x, const uint64_t* ptrs, int64_t n,     \
                           const int* dims, void* heads, void* stream) {       \
    return launch_spa<T>(x, ptrs, n, dims, (float*)heads,                      \
                         (cudaStream_t)stream);                                \
  }                                                                            \
  int ref_spa_fwd_res_##SUFFIX(const void* x, const void* pos,                 \
                               const void* pe_w, const void* pe_b,             \
                               const uint64_t* ptrs, int64_t n,                \
                               const int* dims, void* heads, void* dgrad,      \
                               const uint64_t* acts, void* stream) {           \
    return launch_spa_res<T>(x, pos, pe_w, pe_b, ptrs, n, dims,                \
                             (float*)heads, (float*)dgrad, acts,               \
                             (cudaStream_t)stream);                            \
  }                                                                            \
  int ref_spa_fwd_grad_##SUFFIX(const void* x, const void* pos,                \
                                const void* pe_w, const void* pe_b,            \
                                const uint64_t* ptrs, int64_t n,               \
                                const int* dims, void* heads, void* dgrad,     \
                                void* stream) {                                \
    return launch_spa_res<T>(x, pos, pe_w, pe_b, ptrs, n, dims,                \
                             (float*)heads, (float*)dgrad, nullptr,            \
                             (cudaStream_t)stream);                            \
  }                                                                            \
  int ref_dir_fwd_##SUFFIX(const void* heads, const void* noise,               \
                           const void* dirs, int64_t per_ray, const void* mat, \
                           const void* sigma, const uint64_t* ptrs, int64_t n, \
                           const int* dims, void* rgb, void* normal,           \
                           void* density, void* stream) {                      \
    return launch_dir<false, DIR_FULL, T>(                                     \
        heads, noise, dirs, per_ray, nullptr, mat, sigma, ptrs, n, dims,       \
        (float*)rgb, (float*)normal, (float*)density, nullptr,                 \
        (cudaStream_t)stream);                                                 \
  }                                                                            \
  int ref_dir_fwd_res_##SUFFIX(                                                \
      const void* heads, const void* noise, const void* dirs, int64_t per_ray, \
      const void* mat, const void* sigma, const uint64_t* ptrs, int64_t n,     \
      const int* dims, void* rgb, void* normal, void* density,                 \
      const uint64_t* acts, void* stream) {                                    \
    return launch_dir<true, DIR_FULL, T>(                                      \
        heads, noise, dirs, per_ray, nullptr, mat, sigma, ptrs, n, dims,       \
        (float*)rgb, (float*)normal, (float*)density, acts,                    \
        (cudaStream_t)stream);                                                 \
  }

REF_FWD(f32, float)
REF_FWD(bf16, __nv_bfloat16)

const char* ref_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
