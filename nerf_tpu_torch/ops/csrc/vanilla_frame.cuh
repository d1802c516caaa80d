// The VanillaNeRF MLP's fused forwards in bf16 on the persistent frame of
// spa_frame.cuh: vanilla_mlp_fwd (FORM_VANILLA) and vanilla_mlp_fwd_res
// (FORM_VANILLA_RES, the 9 activations stored).  fused_mlp.cu launches
// these for a bf16 tensor; its f32 bodies, and the bf16 ones at widths
// whose frame does not fit a block's shared memory (vanilla_frame_body),
// keep the 64-row tile (fused_mlp.cu's vanilla_mlp_fwd_kernel).
//
// Replaces: the bf16 bodies of vanilla_mlp_fwd_kernel<STORE, T>, which
// ported the Pallas kernel nerf_tpu/ops/fused_mlp.py:128
// (_vanilla_fwd_kernel, res :150, pallas_call at :356) on dense_tile's
// 64-row frame: two blocks an SM, each weight ring opened and drained at
// every layer, a block-wide barrier after every layer, W read from L2 for
// every 64 rows, and the sigma and rgb heads one warp a (row, output).
//
// Bound on an H100 SXM (700 W), by operations (fused_mlp.cu): 0.560 ms for
// an eval chunk's 524,288 points; by bytes, 0.178 ms for a step's 131,072
// points with their 4.35 KB of activations a point.
//
// Design.  The spatial frame's, part for part: a persistent block an SM of
// two consumer warpgroups (64 rows each, 128-point tiles; one on 64-point
// tiles where a width leaves two buffers of 128 rows no room) and a
// producer warpgroup whose first thread streams every layer's weights
// through one ring (frame_produce, the map list of vanilla_maps: w0, w1 ..
// w3, w4a then w4b, w5, w6, wb, wr1a then wr1b), the products
// (frame_kloop), a layer's epilogue (spa_frame_layer; without the ReLU for
// the bottleneck bvec), the stores (frame_store), the layout and its search
// (frame_layout, frame_search) and the setmaxnreg split.  What the vanilla
// net adds:
//   two input tiles, enc_x (dx wide) and enc_d (dd wide), each warp's 16
//   rows copied in by cp.async (frame_load_x): the next tile's enc_x once
//   the skip layer has read this one's, its enc_d once the rgb layer has;
//   the trunk's widths: z7 and bvec are bn wide, r1 is r wide, and the rgb
//   layer is a split product, bvec @ wr1a + enc_d @ wr1b;
//   the two heads (vanilla_frame_head): sigma from z7 before wb writes
//   over it, and rgb = sigmoid(r1 @ wr2 + br2) at the tile's end, output by
//   output, each (point, output) summed as head_tile sums it (lane-strided
//   fmaf, then the butterfly, folded over the warp's rows by
//   frame_fold_rows); rgb leaves as (3, N) f32;
//   the training form stores h1 .. h4, z5, z6 (H wide), z7, bvec (bn) and
//   r1 (r) through frame_store; the backward reads the stored activations,
//   so no ReLU mask is kept.
//
// Arithmetic, element by element that of vanilla_mlp_fwd_kernel, so that
// every output equals the 64-row tile's bit for bit: each 16-deep k-step is
// summed from zero by wgmma and added to the f32 sum in the order of k (G =
// 1), a0's columns before a1's in the two split layers; the f32 bias, then
// the ReLU (none for bvec), then the rounding to bf16; enc_x's and enc_d's
// columns past their widths and W's rows past k read as zeros, as
// dense_tile pads its k-tail; each head output is summed as head_tile sums
// it, the bias added last, then 1 / (1 + expf(-v)) for rgb.

#pragma once

#include "spa_frame.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

// The vanilla net's widths: enc_x, enc_d, the trunk, the bottleneck and the
// rgb layer.
struct VanillaDims {
  int dx, dd, h, bn, r;
};

// Device pointers of the 9 stored activations h1 h2 h3 h4 z5 z6 z7 bvec r1,
// (n, width) each, read where the launch put them (the layer loop indexes
// them, which would copy a plain parameter to local memory).
struct VanillaFrameActs {
  bf16_t* a[9];
};

// One output column t of a head's weights w (k_dim, n_out): staged at
// cb + off as f32 rows of n_out, or read from the bf16 weights where off is
// -1 (the same values: a bf16 converts to f32 exactly).
struct VanillaHeadW {
  const float* cb;
  int off;
  const bf16_t* w;
  int n_out, t;

  __device__ __forceinline__ float operator()(int k) const {
    if (off >= 0) return cb[off + k * n_out + t];
    return to_f(w[k * n_out + t]);
  }
};

// One level of frame_fold_rows: the first 2 HALF values fold to HALF, a lane
// keeping v[2 i + 1] where ``hi`` (its lane bit ``off``), else v[2 i], and
// adding its partner's copy of it.  The trip count is a template constant,
// so that v stays in registers.
template <int HALF>
__device__ __forceinline__ void fold_pairs(float (&v)[16], int off, bool hi) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? v[2 * i] : v[2 * i + 1];
    const float keep = hi ? v[2 * i + 1] : v[2 * i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The sums of a lane's partials v[r] (the warp's row r) over the warp as
// the butterfly of head_tile takes each (xor 16, 8, 4, 2, 1).  At each of
// the first four levels a lane keeps one row of a pair and adds its
// partner's copy of it, which is the butterfly's own sum of the same two
// values (frame_reduce11 folds outputs so; here the rows fold); the last
// level takes the one value left as it stands.  Returns the row whose total
// v[0] then holds.
__device__ __forceinline__ int frame_fold_rows(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
  fold_pairs<8>(v, 16, lane & 16);
  fold_pairs<4>(v, 8, lane & 8);
  fold_pairs<2>(v, 4, lane & 4);
  fold_pairs<1>(v, 2, lane & 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return ((lane >> 4) & 1) | ((lane >> 2) & 2) | (lane & 4)
      | ((lane & 2) << 2);
}

// One head output over the warp's 16 rows of a (k_dim wide, rows of stride
// lda): each row summed as head_tile sums it, lane l over k = l, l + 32,
// ... by fmaf in order from 0, then the butterfly (frame_fold_rows).  Up
// to k_dim 256 a lane holds its 8 weights in registers.  Returns the row
// whose sum, without the bias, v[0] then holds (on two lanes: take the even
// one).  The rgb head takes its three outputs one after the other: all
// three at once kept 48 partials a lane, and ptxas spilled the res form.
__device__ __forceinline__ int vanilla_frame_head(const bf16_t* a, int lda,
                                                  int k_dim,
                                                  const VanillaHeadW& W,
                                                  float (&v)[16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = 0.f;
  if (k_dim <= 256) {
    float wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      wv[j] = k < k_dim ? W(k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      if (k < k_dim) {
#pragma unroll
        for (int r = 0; r < 16; ++r)
          v[r] = fmaf(to_f(a[r * lda + k]), wv[j], v[r]);
      }
    }
  } else {
    for (int k = lane; k < k_dim; k += 32) {
      const float w = W(k);
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = fmaf(to_f(a[r * lda + k]), w, v[r]);
    }
  }
  return frame_fold_rows(v);
}

// The consumers' nt threads stage the constants (vanilla_frame_consts) at
// cb, then meet at named barrier 1 (the producer's warpgroup has left).
__device__ __forceinline__ void vanilla_frame_stage_consts(
    float* cb, const FrameConsts& C, const VanillaWeights<bf16_t>& p,
    const VanillaDims& v, int nt) {
  const int tid = threadIdx.x;
  const float* bs[11] = {p.b0, p.b1, p.b2, p.b3, p.b4, p.b5, p.b6, p.bb,
                         p.br1, p.bsig, p.br2};
  const int len[11] = {v.h, v.h, v.h, v.h, v.h, v.h, v.bn, v.bn, v.r, 1, 3};
  for (int i = 0, at = 0; i < 11; at += len[i], ++i)
    for (int j = tid; j < len[i]; j += nt) cb[at + j] = bs[i][j];
  if (C.whead >= 0) {
    for (int j = tid; j < v.bn; j += nt) cb[C.whead + j] = to_f(p.wsig[j]);
    for (int j = tid; j < 3 * v.r; j += nt)
      cb[C.whead + v.bn + j] = to_f(p.wr2[j]);
  }
  bar_sync(1, nt);
}

// The frame (see the top of this file and of spa_frame.cuh).
template <int FORM>
__global__ void __launch_bounds__(384, 1)
vanilla_frame_kernel(const bf16_t* __restrict__ x,
                     const bf16_t* __restrict__ d, VanillaWeights<bf16_t> p,
                     int64_t n, VanillaDims v, FrameLayout L,
                     const __grid_constant__ VanillaFrameActs s,
                     float* __restrict__ rgb3, float* __restrict__ sigma,
                     const __grid_constant__ TileMaps maps) {
  extern __shared__ __align__(1024) unsigned char frame_smem[];
  unsigned char* base =
      frame_smem + ((1024 - smem_addr(frame_smem) % 1024) % 1024);
  const int warp = threadIdx.x >> 5, cons = L.cons;
  FRing R{smem_addr(base), smem_addr(base) + (uint32_t)L.bars, L.stages, 0,
          0u};
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(R.bars + 8 * i, 1);
      mbar_init(R.bars + 8 * (L.stages + i), 4 * cons);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int TM = 64 * cons;                         // points a tile
  const int64_t tiles = (n + TM - 1) / TM;
  // the warpgroup's role, from a value the compiler sees as uniform
  if (__shfl_sync(0xffffffffu, warp >> 2, 0) == cons) {    // the producer's
    setmaxnreg_dec<FREGS_PRODUCER>();
    if (threadIdx.x == 128 * cons)
      frame_produce<FORM>(R, maps, maps, tiles, v.dx, v.h, v.bn, v.r, v.dd);
    return;
  }
  setmaxnreg_inc<FREGS_CONSUMER>();
  const int lane = threadIdx.x & 31;
  const int wr = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's rows
  const int lda = L.lda;
  bf16_t* act = reinterpret_cast<bf16_t*>(base + L.act) + wr * lda;
  bf16_t* xs = reinterpret_cast<bf16_t*>(base + L.xs) + wr * v.dx;
  bf16_t* ds = reinterpret_cast<bf16_t*>(base + L.ds) + wr * v.dd;
  const FrameConsts& C = L.c;
  float* cb = reinterpret_cast<float*>(base + L.consts);
  vanilla_frame_stage_consts(cb, C, p, v, 128 * cons);
  const bf16_t* none = nullptr;
  // each layer writes nxt and then reads it as cur: the same rows in one
  // buffer, or the other buffer where a width exceeds FCOLS
  const int flip = L.two ? TM * lda : 0;
  int64_t tile = blockIdx.x;
  if (tile < tiles) {
    frame_load_x(x, v.dx, tile * TM + wr, n, xs);
    frame_load_x(d, v.dd, tile * TM + wr, n, ds);
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM + wr;
    const int64_t r_next = r0 + (int64_t)gridDim.x * TM;
    const bool more = tile + gridDim.x < tiles;
    cp_async_wait<0>();
    __syncwarp();
    bf16_t* cur = act + flip;
    bf16_t* nxt = act;
    // h1 .. h4, z5 (the skip: x @ w4a + h4 @ w4b), z6, z7, bvec (no ReLU),
    // r1 (bvec @ wr1a + d @ wr1b); the biases one after the other in cb
#pragma unroll 1
    for (int i = 0; i < 9; ++i) {
      const bool in = i == 0 || i == 4;
      const int n_out = i < 6 ? v.h : i < 8 ? v.bn : v.r;
      R = spa_frame_layer<FWG_EVAL>(
          R, in ? xs : cur, in ? v.dx : lda, in ? v.dx : i < 7 ? v.h : v.bn,
          i == 4 ? cur : i == 8 ? ds : none, i == 8 ? v.dd : lda,
          i == 4 ? v.h : i == 8 ? v.dd : 0,
          cb + (i < 7 ? i * v.h : C.bbn + (i - 7) * v.bn), n_out, nxt, lda,
          nullptr, i != 7);
      if constexpr (FORM == FORM_VANILLA_RES)
        frame_store(nxt, lda, s.a[i], n_out, r0, n);
      bf16_t* t = cur;
      cur = nxt;
      nxt = t;
      if (i == 4 && more)                       // enc_x is read
        frame_load_x(x, v.dx, r_next, n, xs);
      if (i == 6) {                             // sigma, before wb's layer
        float sv[16];
        const int row = vanilla_frame_head(
            cur, lda, v.bn, VanillaHeadW{cb, C.whead, p.wsig, 1, 0}, sv);
        if (!(lane & 1) && r0 + row < n)
          sigma[r0 + row] = sv[0] + cb[C.heads_b];
      }
    }
    if (more) frame_load_x(d, v.dd, r_next, n, ds);   // enc_d is read
#pragma unroll 1
    for (int t = 0; t < 3; ++t) {               // rgb3, output by output
      float rv[16];
      const int row = vanilla_frame_head(
          cur, lda, v.r,
          VanillaHeadW{cb, C.whead >= 0 ? C.whead + v.bn : -1, p.wr2, 3, t},
          rv);
      if (!(lane & 1) && r0 + row < n)
        rgb3[t * n + r0 + row] = sigmoidf(rv[0] + cb[C.heads_b + 1 + t]);
    }
    __syncwarp();
  }
}

// The body that a bf16 vanilla forward of these dims (dims: dx dd h bn r)
// runs on the current device: the frame's layout (frame_search; *smem its
// bytes, *sms the device's SMs), or *smem 0 where no layout fits and the
// 64-row tile of fused_mlp.cu runs instead, chosen by shape before any
// launch.  Returns 0 or a CUDA error code.
inline int vanilla_frame_body(const int* dims, bool store, FrameLayout* L,
                              size_t* smem, int* sms) {
  return frame_search(L, smem, sms, store ? FORM_VANILLA_RES : FORM_VANILLA,
                      dims[0], dims[2], dims[3], dims[4], 0, 0, dims[1]);
}

// Launches the bf16 vanilla forward on ``stream`` (launch_vanilla's
// arguments) at the layout L (smem bytes, sms the device's SMs) that
// vanilla_frame_body found: the maps of vanilla_maps, one block an SM,
// min(tiles, SMs) blocks.  Returns 0 or a CUDA error code.
template <bool STORE>
int launch_vanilla_frame(const void* x, const void* d, const uint64_t* ptrs,
                         int64_t n, const int* dims, float* rgb3,
                         float* sigma, const uint64_t* acts,
                         const FrameLayout& L, size_t smem, int sms,
                         cudaStream_t stream) {
  constexpr int FORM = STORE ? FORM_VANILLA_RES : FORM_VANILLA;
  const VanillaDims v{dims[0], dims[1], dims[2], dims[3], dims[4]};
  const VanillaWeights<bf16_t> p = vanilla_weights<bf16_t>(ptrs);
  TileMaps maps;
  int err = vanilla_maps<bf16_t>(&maps, p, v.dx, v.dd, v.h, v.bn, v.r);
  if (err != 0) return err;
  VanillaFrameActs s = {};
  for (int i = 0; STORE && i < 9; ++i) s.a[i] = (bf16_t*)acts[i];
  const int64_t tiles = (n + 64 * L.cons - 1) / (64 * L.cons);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  const auto kernel = vanilla_frame_kernel<FORM>;
  err = set_smem(kernel, smem, FRAME_NAMES[FORM], 1, 128 * (L.cons + 1));
  if (err != 0 || n == 0) return err;
  kernel<<<grid, 128 * (L.cons + 1), smem, stream>>>(
      (const bf16_t*)x, (const bf16_t*)d, p, n, v, L, s, rgb3, sigma, maps);
  return (int)cudaGetLastError();
}

}  // namespace
