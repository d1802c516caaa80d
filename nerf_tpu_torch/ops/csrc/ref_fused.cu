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
// Design.  The bf16 spatial forwards (ref_spa_fwd, ref_spa_fwd_res,
// ref_spa_fwd_grad) run the persistent frame of spa_frame.cuh: 128-point
// tiles, two consumer warpgroups and a producer warp that streams every
// layer's weights through one TMA ring.  The bf16 directional forwards
// (ref_dir_fwd, ref_dir_fwd_res) run the same frame with the directional
// net's input stage and tail (dir_frame.cuh).  At widths whose frame does
// not fit a block's shared memory each runs its 64-row tile instead (the
// kernels below, ref_dir_fwd.cuh's): spa_frame_body and dir_frame_body
// choose by shape before the launch, and every entry reports the body it
// launched.  The 64-row tile: one block of 256
// threads owns a tile of TM = 64 points (mlp_tile.cuh) and keeps its input
// row and two ping-pong activation buffers in shared memory across all
// layers; only the outputs (and the stored activations) are written.  The
// glue runs one thread per point of the tile and writes the IDE and d.n
// straight into the tile's input row; the IDE tables (mat, sigma) are
// staged in shared memory.  The per-ray directions are read as dirs[row /
// P] for P samples per ray, so the (N, 3) broadcast never exists.  The
// narrow heads are one warp per (point, output) with a shuffle reduction;
// the bottleneck head is a register-tiled product like the hidden layers.
// The tile's density gradient runs in the same block after the forward,
// its ReLU masks read back from the activations the block just stored (or
// kept as bits: ref_spa_fwd_grad), its transposed products taken as in the
// backwards (delta_tile, and enc_pull into the encoding; in bf16 in passes
// of 128 columns, for want of registers).  The positional encoding's
// cosines use cosf, whose range reduction holds at the 2^9 |x| of the top
// frequency.  The ragged last tile is masked: rows past N load as zero and
// are not stored.
//
// Bound on an H100 SXM (700 W): at H = O = 256 the spatial net costs 526,592
// MACs per point and the directional 545,024 (+ 171 for the IDE's
// z-powers @ mat); the density gradient adds 491,520 (+ 360 for the
// encoding's transpose).  The eval forwards move about 0.7 KB per point in
// bf16 and are bound by operations: 0.84 and 0.87 ms per 4096-ray chunk
// (786,432 points) at the 989 TFLOP/s bf16 peak.  The training forwards
// also write 4 KB of activations per point in bf16.  The 64-row tiles run
// their trunks through dense_tile (mlp_tile.cuh): in f32 on the CUDA cores,
// in bf16 on the tensor cores (wgmma, each layer's weights brought by TMA
// into a 24 KB ring of shared memory: 115,288 bytes a block for the
// directional net at IDE level 4, two blocks an SM).

#include "ref_common.cuh"
#include "ref_dir_fwd.cuh"
#include "spa_frame.cuh"
#include "dir_frame.cuh"

namespace {

using namespace mlp;

// The eval forward of the spatial net (bf16: spa_frame.cuh's FORM_EVAL
// where its frame fits).
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_spa_fwd_kernel(const T* __restrict__ x, RefSpaWeights<T> p, int64_t n,
                   int dx, int h, int o, int nb, int maxw,
                   float* __restrict__ heads,
                   const __grid_constant__ TileMaps maps) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* buf_a = xs + TM * dx;
  T* buf_b = buf_a + TM * maxw;
  T* st = buf_b + TM * maxw;              // dense_tile's weight stage
  T* none = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t hw = HEAD_FIXED + nb;
  load_rows(x, dx, row0, n, xs);
  __syncthreads();
  dense_tile<false>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, none, row0, n, st, &maps.map[0]);     // h1
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, none, row0, n, st, &maps.map[1]);   // h2
  __syncthreads();
  dense_tile<false>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, none, row0, n, st, &maps.map[2]);   // h3
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, none, row0, n, st, &maps.map[3]);   // h4
  __syncthreads();
  dense_tile<false>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, none, row0, n, st, &maps.map[4]); // z5
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, none, row0, n, st, &maps.map[6]);   // z6
  __syncthreads();
  dense_tile<false>(buf_b, h, p.w6, none, 0, none, p.b6, h, true, buf_a, none, row0, n, st, &maps.map[7]);   // z7
  __syncthreads();
  dense_tile<false>(buf_a, h, p.w7, none, 0, none, p.b7, o, true, buf_b, none, row0, n, st, &maps.map[8]);   // inter
  __syncthreads();
  narrow_head(buf_b, o, p.wrt, p.brt, 2, false, heads, hw, 0, row0, n);
  narrow_head(buf_b, o, p.wnct, p.bnct, 9, false, heads, hw, 2, row0, n);
  wide_head(buf_b, o, p.wbn, p.bbn, nb, heads, hw, HEAD_FIXED, row0, n, st, &maps.map[9]);
}

// The bf16 body of enc_pull, on the tensor cores as delta_tile_mma takes
// them (mlp_tile.cuh: ring_pass_t on wgmma through the delta ring where
// ``tmap`` is given, else mma_pass_t): the
// fragments' values rounded to bf16, then added in f32, one by one (n_out =
// 63 is odd).
template <bool ADD>
__device__ __forceinline__ void enc_pull_mma(const bf16_t* a, int k_dim,
                                             const bf16_t* __restrict__ w,
                                             int n_out, float* enc_grad,
                                             bf16_t* stage,
                                             const CUtensorMap* tmap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16;
  const int g = lane >> 2, q = lane & 3;
  const bool ring = tmap != nullptr;
  WRing<TSTAGES, DPASS> R{};
  if (ring) R = ring_open<TSTAGES, DPASS, true>(stage, tmap, k_dim, 0, n_out);
  for (int c0 = 0, pass = 0; c0 < n_out; c0 += DPASS, ++pass) {
    const PassCols pc = pass_cols<DPASS>(n_out, c0, warp >> 2);
    float acc[16][4];
    if (ring)
      ring_pass_t(acc, R, pass, a, k_dim, pc);
    else
      mma_pass_t<DPASS>(acc, a, k_dim, w, n_out, c0, pc, stage);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (t >= pc.nt_n) break;
      const int c = c0 + pc.col0 + 8 * t + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ce = c + (e & 1);
        if (ce >= n_out) continue;
        float* d = enc_grad + (m0 + g + 8 * (e >> 1)) * n_out + ce;
        const float v = to_f(from_f<bf16_t>(acc[t][e]));
        *d = ADD ? *d + v : v;
      }
    }
  }
  if (ring) ring_close(R);
}

// enc_grad = [enc_grad +] (a @ W^T rounded to T), f32, for the whole tile:
// a pullback into the encoding, W the layer's (n_out = dx, k_dim) forward
// matrix.  bf16 multiplies on the tensor cores (enc_pull_mma, through W's
// delta map ``tmap``), f32 on the CUDA cores in full f32 (accumulate_t).
// Every thread of the block must call this.
template <bool ADD, typename T>
__device__ void enc_pull(const T* a, int k_dim, const T* __restrict__ w,
                         int n_out, float* enc_grad, T* stage,
                         const CUtensorMap* tmap) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    enc_pull_mma<ADD>(a, k_dim, w, n_out, enc_grad, stage, tmap);
  } else {
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
}

// Bytes of the encoding tile of ref_spa_fwd_res_kernel<false>: the f32
// d(density)/d(enc) tile is laid over the masks of z5 z6 z7 inter and the
// encoding tile, all dead once it is first written (after z5's pullback), so
// the tile is padded where those are smaller than it.  At H = O = 256 in
// bf16 that kept the block at 115,712 bytes of shared memory (with the
// shared stage grown to dense_tile's ring): two fit an SM, with none left.
__host__ __device__ inline size_t grad_xs_bytes(int dx, int h, int o,
                                                size_t t_size) {
  const size_t tail =
      (size_t)TM * (3 * mask_words(h) + mask_words(o)) * sizeof(uint32_t);
  const size_t xs = (size_t)TM * dx * t_size;
  const size_t denc = (size_t)TM * dx * sizeof(float);
  const size_t need = denc > tail + xs ? denc - tail : xs;
  return (need + 15) & ~(size_t)15;
}

// The training forward of the spatial net (bf16: spa_frame.cuh's FORM_RES
// and FORM_GRAD where their frame fits).  With STORE (ref_spa_fwd_res)
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
                       float* __restrict__ dgrad,
                       const __grid_constant__ TileMaps maps,
                       const __grid_constant__ TileMaps dm) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
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
  T* st = unit + TM * 2;                          // the W^T and weight stage
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
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(xs, dx, p.w0, none, 0, none, p.b0, h, true, buf_a, s.a[0], row0, n, st, &maps.map[0], m[0]);     // h1
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(buf_a, h, p.w1, none, 0, none, p.b1, h, true, buf_b, s.a[1], row0, n, st, &maps.map[1], m[1]);   // h2
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(buf_b, h, p.w2, none, 0, none, p.b2, h, true, buf_a, s.a[2], row0, n, st, &maps.map[2], m[2]);   // h3
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(buf_a, h, p.w3, none, 0, none, p.b3, h, true, buf_b, s.a[3], row0, n, st, &maps.map[3], m[3]);   // h4
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(xs, dx, p.w4a, buf_b, h, p.w4b, p.b4, h, true, buf_a, s.a[4], row0, n, st, &maps.map[4], m[4]); // z5
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(buf_a, h, p.w5, none, 0, none, p.b5, h, true, buf_b, s.a[5], row0, n, st, &maps.map[6], m[5]);   // z6
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(buf_b, h, p.w6, none, 0, none, p.b6, h, true, buf_a, s.a[6], row0, n, st, &maps.map[7], m[6]);   // z7
  __syncthreads();
  dense_tile<STORE, T, MK, DSTAGES, NCOLS>(buf_a, h, p.w7, none, 0, none, p.b7, o, true, buf_b, s.a[7], row0, n, st, &maps.map[8], m[7]);   // inter
  __syncthreads();
  narrow_head(buf_b, o, p.wrt, p.brt, 2, false, heads, hw, 0, row0, n);
  narrow_head(buf_b, o, p.wnct, p.bnct, 9, false, heads, hw, 2, row0, n);
  wide_head<T, NCOLS>(buf_b, o, p.wbn, p.bbn, nb, heads, hw, HEAD_FIXED, row0, n, st, &maps.map[9]);
  __syncthreads();   // also makes the stored activations visible to the block
  // the density column's pullback: [0, 1] @ wrt^T = wrt[:, 1], then the trunk
  delta_tile<false, DPASS, T, T, MK>(unit, 2, p.wrt, o, s.a[7], none, none, buf_a, drop, row0, n, st, nullptr, m[7]);      // inter
  __syncthreads();
  delta_tile<false, DPASS, T, T, MK>(buf_a, o, p.w7, h, s.a[6], none, none, buf_b, drop, row0, n, st, &dm.map[1], m[6]);   // z7
  __syncthreads();
  delta_tile<false, DPASS, T, T, MK>(buf_b, h, p.w6, h, s.a[5], none, none, buf_a, drop, row0, n, st, &dm.map[2], m[5]);   // z6
  __syncthreads();
  delta_tile<false, DPASS, T, T, MK>(buf_a, h, p.w5, h, s.a[4], none, none, buf_b, drop, row0, n, st, &dm.map[3], m[4]);   // z5
  __syncthreads();
  enc_pull<false>(buf_b, h, p.w4a, dx, denc, st, &dm.map[8]);
  delta_tile<false, DPASS, T, T, MK>(buf_b, h, p.w4b, h, s.a[3], none, none, buf_a, drop, row0, n, st, &dm.map[4], m[3]);  // h4
  __syncthreads();
  delta_tile<false, DPASS, T, T, MK>(buf_a, h, p.w3, h, s.a[2], none, none, buf_b, drop, row0, n, st, &dm.map[5], m[2]);   // h3
  __syncthreads();
  delta_tile<false, DPASS, T, T, MK>(buf_b, h, p.w2, h, s.a[1], none, none, buf_a, drop, row0, n, st, &dm.map[6], m[1]);   // h2
  __syncthreads();
  delta_tile<false, DPASS, T, T, MK>(buf_a, h, p.w1, h, s.a[0], none, none, buf_b, drop, row0, n, st, &dm.map[7], m[0]);   // h1
  __syncthreads();
  enc_pull<true>(buf_b, h, p.w0, dx, denc, st, &dm.map[9]);
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


// The 64-row tile of the spatial forwards: f32, and bf16 at widths whose
// frame does not fit a block (spa_frame_body).
template <typename T>
int launch_spa_tile(const void* x, const uint64_t* ptrs, int64_t n,
               const int* dims, float* heads, cudaStream_t stream) {
  const RefSpaWeights<T> p = spa_weights<T>(ptrs);
  const int dx = dims[0], h = dims[1], o = dims[2], nb = dims[3];
  const int maxw = h > o ? h : o;
  if (!tile_widths_ok<T>({h, o, nb})) return (int)cudaErrorInvalidValue;
  const size_t at = (size_t)TM * (dx + 2 * maxw) * sizeof(T);
  const size_t smem = at + dense_stage_bytes<T>(at);
  TileMaps maps;
  int err = spa_maps<T>(&maps, p, dx, h, o, nb);
  if (err == 0) err = set_smem(ref_spa_fwd_kernel<T>, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  ref_spa_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, p, n, dx, h, o, nb, maxw, heads, maps);
  return (int)cudaGetLastError();
}

// dims: dx h o nb; acts: the 8 (n, width) outputs h1..h4 z5 z6 z7 inter,
// or null (ref_spa_fwd_grad: the masks stay on chip)
template <typename T>
int launch_spa_res_tile(const void* x, const void* pos, const void* pe_w,
                   const void* pe_b, const uint64_t* ptrs, int64_t n,
                   const int* dims, float* heads, float* dgrad,
                   const uint64_t* acts, cudaStream_t stream) {
  const RefSpaWeights<T> p = spa_weights<T>(ptrs);
  const int dx = dims[0], h = dims[1], o = dims[2], nb = dims[3];
  const int maxw = h > o ? h : o;
  const bool store = acts != nullptr;
  if (!tile_widths_ok<T>({h, o, nb})) return (int)cudaErrorInvalidValue;
  const size_t at = (store
      ? (size_t)TM * dx * (sizeof(float) + sizeof(T))
      : (size_t)TM * (7 * mask_words(h) + mask_words(o)) * sizeof(uint32_t)
        + grad_xs_bytes(dx, h, o, sizeof(T)))
      + (size_t)TM * (2 * maxw + 2) * sizeof(T);  // buf_a buf_b unit
  const size_t smem = at + stage_bytes<T>(at);
  auto kernel = store ? ref_spa_fwd_res_kernel<true, T>
                      : ref_spa_fwd_res_kernel<false, T>;
  TileMaps maps, dm;
  int err = spa_maps<T>(&maps, p, dx, h, o, nb);
  if (err == 0) err = spa_dmaps<T>(&dm, p, dx, h, o, nb, DPASS);
  // the occupancy of the f32 body is noted; the bf16 one runs only where
  // the frame does not fit a block, at one block an SM
  const bool f32 = std::is_same<T, float>::value;
  if (err == 0)
    err = set_smem(kernel, smem,
                   !f32 ? nullptr
                   : store ? "ref_spa_fwd_res_kernel<true>"
                           : "ref_spa_fwd_res_kernel<false>",
                   1);
  if (err != 0 || n == 0) return err;
  Acts<T> s = {};
  if (store) s = acts_of<T>(acts);
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)pos, (const float*)pe_w,
      (const float*)pe_b, p, n, dx, h, o, nb, maxw, s, heads, dgrad, maps,
      dm);
  return (int)cudaGetLastError();
}


// The spatial forward of form FORM (dims: dx h o nb; acts: the 8 (n, width)
// outputs h1..h4 z5 z6 z7 inter of FORM_RES): in bf16 the frame where it
// fits (spa_frame_body), else, and in f32, the 64-row tile.  *body: the
// body launched, the frame's consumer warpgroups (1 or 2) or 0 for the
// 64-row tile.
template <int FORM, typename T>
int launch_spa_fwd(const void* x, const void* pos, const void* pe_w,
                   const void* pe_b, const uint64_t* ptrs, int64_t n,
                   const int* dims, float* heads, float* dgrad,
                   const uint64_t* acts, int* body, cudaStream_t stream) {
  *body = 0;
  if constexpr (std::is_same<T, bf16_t>::value) {
    if (!tile_widths_ok<T>({dims[1], dims[2], dims[3]}))
      return (int)cudaErrorInvalidValue;
    FrameLayout L;
    size_t smem = 0;
    int sms = 0;
    const int err = spa_frame_body(dims, FORM, &L, &smem, &sms);
    if (err != 0) return err;
    if (smem != 0) {
      *body = L.cons;
      return launch_spa_frame<FORM>(
          (const bf16_t*)x, (const float*)pos, (const float*)pe_w,
          (const float*)pe_b, spa_weights<bf16_t>(ptrs), n, dims[0],
          dims[1], dims[2], dims[3], heads, dgrad, acts, L, smem, sms,
          stream);
    }
  }
  if (FORM == FORM_EVAL)
    return launch_spa_tile<T>(x, ptrs, n, dims, heads, stream);
  return launch_spa_res_tile<T>(x, pos, pe_w, pe_b, ptrs, n, dims, heads,
                                dgrad, acts, stream);
}

// The directional forward at DIR_FULL: in bf16 the frame where it fits
// (launch_dir_frame), in f32 the 64-row tile.  *body: the body launched,
// the frame's consumer warpgroups (1 or 2) or 0 for the 64-row tile.
template <bool STORE, typename T>
int launch_dir_fwd(const void* heads, const void* noise, const void* dirs,
                   int64_t per_ray, const void* mat, const void* sigma,
                   const uint64_t* ptrs, int64_t n, const int* dims,
                   float* rgb, float* normal, float* density,
                   const uint64_t* acts, int* body, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16_t>::value)
    return launch_dir_frame<STORE>(heads, noise, dirs, per_ray, mat, sigma,
                                   ptrs, n, dims, rgb, normal, density, acts,
                                   body, stream);
  *body = 0;
  return launch_dir<STORE, DIR_FULL, T>(heads, noise, dirs, per_ray, nullptr,
                                        mat, sigma, ptrs, n, dims, rgb,
                                        normal, density, acts, stream);
}

}  // namespace

extern "C" {

#define REF_FWD(SUFFIX, T)                                                     \
  int ref_spa_fwd_##SUFFIX(const void* x, const uint64_t* ptrs, int64_t n,     \
                           const int* dims, void* heads, int* body,            \
                           void* stream) {                                     \
    return launch_spa_fwd<FORM_EVAL, T>(x, nullptr, nullptr, nullptr, ptrs, n, \
                                        dims, (float*)heads, nullptr, nullptr, \
                                        body, (cudaStream_t)stream);           \
  }                                                                            \
  int ref_spa_fwd_res_##SUFFIX(const void* x, const void* pos,                 \
                               const void* pe_w, const void* pe_b,             \
                               const uint64_t* ptrs, int64_t n,                \
                               const int* dims, void* heads, void* dgrad,      \
                               const uint64_t* acts, int* body,                \
                               void* stream) {                                 \
    return launch_spa_fwd<FORM_RES, T>(x, pos, pe_w, pe_b, ptrs, n, dims,      \
                                       (float*)heads, (float*)dgrad, acts,     \
                                       body, (cudaStream_t)stream);            \
  }                                                                            \
  int ref_spa_fwd_grad_##SUFFIX(const void* x, const void* pos,                \
                                const void* pe_w, const void* pe_b,            \
                                const uint64_t* ptrs, int64_t n,               \
                                const int* dims, void* heads, void* dgrad,     \
                                int* body, void* stream) {                     \
    return launch_spa_fwd<FORM_GRAD, T>(x, pos, pe_w, pe_b, ptrs, n, dims,     \
                                        (float*)heads, (float*)dgrad, nullptr, \
                                        body, (cudaStream_t)stream);           \
  }                                                                            \
  int ref_dir_fwd_##SUFFIX(const void* heads, const void* noise,               \
                           const void* dirs, int64_t per_ray, const void* mat, \
                           const void* sigma, const uint64_t* ptrs, int64_t n, \
                           const int* dims, void* rgb, void* normal,           \
                           void* density, int* body, void* stream) {           \
    return launch_dir_fwd<false, T>(                                           \
        heads, noise, dirs, per_ray, mat, sigma, ptrs, n, dims, (float*)rgb,  \
        (float*)normal, (float*)density, nullptr, body,                       \
        (cudaStream_t)stream);                                                 \
  }                                                                            \
  int ref_dir_fwd_res_##SUFFIX(                                                \
      const void* heads, const void* noise, const void* dirs, int64_t per_ray, \
      const void* mat, const void* sigma, const uint64_t* ptrs, int64_t n,     \
      const int* dims, void* rgb, void* normal, void* density,                 \
      const uint64_t* acts, int* body, void* stream) {                         \
    return launch_dir_fwd<true, T>(                                            \
        heads, noise, dirs, per_ray, mat, sigma, ptrs, n, dims, (float*)rgb,  \
        (float*)normal, (float*)density, acts, body, (cudaStream_t)stream);   \
  }

REF_FWD(f32, float)
REF_FWD(bf16, __nv_bfloat16)

OCCUPANCY_ENTRY(ref_fused)

const char* ref_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
