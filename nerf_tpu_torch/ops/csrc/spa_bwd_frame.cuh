// The Ref-NeRF spatial net's backward delta passes in bf16 on the persistent
// frame of spa_frame.cuh: ref_spa_bwd's (FORM_SPA_BWD, over the activations
// that ref_spa_fwd_res stored) and ref_spa_bwd_recompute's (FORM_SPA_BWD_RC,
// which rebuilds the trunk from enc first).  ref_fused_bwd.cu and
// ref_fused_recompute.cu launch these for a bf16 tensor, then the split-K
// weight-grad pass and its ordered reduction (wgrad.cuh) as before; their f32
// bodies, and the bf16 ones at widths whose frame does not fit a block's
// shared memory (spa_bwd_frame_body), keep the 64-row tile
// (ref_spa_delta_kernel, ref_spa_recompute_kernel).
//
// Replaces: the bf16 bodies of ref_spa_delta_kernel and
// ref_spa_recompute_kernel, the delta passes of the ports of the Pallas
// kernels nerf_tpu/ops/ref_fused.py:729 (_make_spa_bwd_res_kernel) and :701
// (_make_spa_bwd_kernel), pallas_call at :1096, on the 64-row tile: two
// blocks an SM, a weight ring opened and drained at every delta_tile or
// dense_tile call with a block-wide barrier after every layer, W read from
// L2 for every 64 rows, and each ReLU mask of the residual form read back
// from device memory inside the epilogue.
//
// Bound on an H100 SXM (700 W), at H = O = 256, NB = 128 and a step's
// 196,608 points, by bytes: the residual form reads g (556 B a point) and the
// 8 stored activations (4,096 B) and writes the 8 deltas and the rounded
// heads' cotangents (4,374 B), 1.78 GB, 0.53 ms (0.20 ms by its 494,336 MACs
// a point); the recompute form reads enc and g and writes the 8 activations
// and the 8 deltas, 1.75 GB, 0.52 ms (0.41 ms by operations).
//
// Design.  The spatial frame's, part for part (FRing, produce_fwd /
// produce_t, frame_products, spa_frame_layer, spa_frame_delta, frame_store,
// frame_place, the setmaxnreg split): a persistent block an
// SM of two consumer warpgroups (64 rows each, 128-point tiles; one on
// 64-point tiles where a width leaves two buffers of 128 rows no room) and a
// producer warpgroup whose first thread streams the K-major boxes of
// spa_dmaps (in the recompute form after the trunk's boxes of spa_maps) of
// every tile of the block through one ring that is never drained.  A
// consumer warp reads and writes only its own 16 rows.  Per tile:
//   the recompute form rebuilds h1 .. inter as FORM_RES builds them
//   (spa_frame_layer, the masks kept as bits), each activation stored to
//   the chunk's scratch for the weight-grad pass, and copies the next
//   tile's encoding in (cp.async) once z5 has read this tile's;
//   the warp's 16 rows of g are loaded (16-byte loads where aligned, a batch
//   of each lane's loads issued before any is used) and rounded to bf16:
//   g_rt and g_nct to their small tiles, g_bn to the activation buffer, and
//   in the residual form the rounded copies also to the delta list's last
//   three entries, which the weight-grad pass reads;
//   d(inter) (spa_bwd_inter): g_bn @ wbn^T on wgmma from the ring, the two
//   narrow pullbacks g_rt @ wrt^T and g_nct @ wnct^T on mma.sync inside the
//   epilogue, n-tile by n-tile (one zero-padded k-step each, A from the
//   small tiles, B from the staged bf16 weights), summed in the form's
//   order, masked by inter, rounded;
//   then w7^T, w6^T, w5^T, w4b^T, w3^T, w2^T, w1^T (spa_frame_delta), masked
//   by z7, z6, z5, h4, h3, h2, h1, each delta stored.
// Each activation and delta goes to device memory from its rows in shared
// memory as soon as its epilogue has written them (frame_store).
// The residual form's masks come from the stored activations, 64 KB a layer
// at 128 rows, more than a second buffer could spare: each warp copies its
// own 16 rows of the next layer's activation into a stage (cp.async,
// frame_load_x) while this layer's products run, and turns them into bits
// (spa_bwd_bits) once the products of the layer they mask are in, before
// its epilogue (spa_frame_delta's hook, SpaBwdMask): one stage and one
// layer's bits.  inter's copy for the block's next tile starts once h1's
// bits are read.
// Shared memory at H = O = 256, NB = 128, 128 rows (spa_bwd_layout): the
// residual form, the activation buffer 67,584 bytes (rows of 264), the stage
// 65,536, one layer's bits 4,096, g_rt and g_nct 2,816, the heads' weights
// 8,192 and a ring of 10 slots of 8 KB; the recompute form, the buffer, the
// encoding 16,128, 8 layers' bits 32,768, g_rt and g_nct, the biases and
// weights 16,384 and 11 slots.
//
// Arithmetic, element by element that of the 64-row tile (delta_tile,
// dense_tile), so that the deltas, the rebuilt activations and so the 23
// grads equal the tile's bit for bit: each 16-deep k-step summed from zero
// by wgmma and added to the f32 sum in the order of k (G = 1); a narrow
// pullback as mma_pass_t takes it, 0 + its one k-step's product; each
// pullback rounded to bf16 before its add and the sum rounded after each
// add, in the residual order (rt + nct) + bn, or in jax.vjp's (bn + nct) +
// rt in the recompute form; a delta masked, then rounded; a rebuilt layer
// as dense_tile rounds it.

#pragma once

#include "spa_frame.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

// Device pointers of the 8 activations h1 h2 h3 h4 z5 z6 z7 inter (those
// the forward stored, or the recompute form's chunk scratch, which it
// writes) and of the deltas d1 .. d7 (H), d8 (O), then in the residual form
// g_rt, g_nct and g_bn rounded to bf16; (n, width) each.  Read where the
// launch put them (the layer loops index them, which would copy a plain
// parameter to local memory).
struct SpaBwdPtrs {
  bf16_t* a[8];
  bf16_t* d[11];
};

// The constants: in the recompute form the rebuild's biases b0 .. b6 (h
// each) and b7 (o); then (whead) the narrow heads' weights as one row of 16
// bf16 for each of the o inputs k, the B operand of their mma.sync
// (spa_bwd_inter): wnct[k, 0 .. 8], 0, wrt[k, 0 .. 1], then zeros.
inline FrameConsts spa_bwd_frame_consts(int h, int o, bool rc) {
  FrameConsts c;
  c.bbn = c.pe_w = c.pe_b = -1;
  c.heads_b = rc ? 7 * h + o : 0;
  c.whead = (c.heads_b + 3) & ~3;
  c.floats = c.whead + 8 * o;
  return c;
}

// Fills L for ``cons`` consumer warpgroups (64 cons points a tile) in
// ``limit`` bytes and returns the dynamic shared memory bytes, or 0 where
// fewer than two ring slots fit (frame_place).  FrameLayout's pieces: one
// activation buffer as wide as the widest of h, o and nb (g_bn lands there
// too), two where that exceeds FCOLS; xs the recompute form's encoding
// tile; ds the residual form's stage of one stored activation (dense rows
// of max(h, o)); masks the recompute form's 8 layers' bits or the residual
// form's one; frows the rounded g_rt and g_nct (2 and 9 bf16 a row); the
// constants (spa_bwd_frame_consts).
inline size_t spa_bwd_layout(FrameLayout* L, bool rc, int dx, int h, int o,
                             int nb, int limit, int cons) {
  auto up16 = [](size_t b) { return (b + 15) & ~(size_t)15; };
  const int rows = 64 * cons;
  int maxw = h > o ? h : o;
  const int actw = maxw;                  // the widest stored activation
  if (nb > maxw) maxw = nb;
  L->cons = cons;
  L->lda = frame_ld(maxw);
  L->ldx = dx;
  L->two = maxw > FCOLS;
  L->mw = mask_words(maxw);
  L->c = spa_bwd_frame_consts(h, o, rc);
  const size_t masks = (size_t)(rc ? 8 : 1) * rows * L->mw * 4;
  return frame_place(
      L, (size_t)(L->two ? 2 : 1) * rows * L->lda * 2,
      rc ? up16((size_t)rows * dx * 2) : 0,
      rc ? 0 : up16((size_t)rows * actw * 2), masks,
      up16((size_t)rows * 11 * 2), up16((size_t)L->c.floats * 4), limit);
}

// The producer's whole stream (the first thread of the producer's
// warpgroup): for each of the block's tiles, in the recompute form the
// rebuild's boxes of spa_maps (h1 .. inter), then the delta chain's
// K-major boxes of spa_dmaps (g_bn @ wbn^T, then w7^T .. w1^T), in the
// order the consumers take them.
template <bool RC>
__device__ void spa_bwd_produce(FRing R, const TileMaps& maps,
                                const TileMaps& dm, int64_t tiles, int dx,
                                int h, int o, int nb) {
  for (int i = 0; i < 9; ++i) {
    if (i < 8) prefetch_tensormap(&dm.map[i]);
    if (RC) prefetch_tensormap(&maps.map[i]);
  }
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (RC) {                                   // the rebuild: h1 .. inter
      produce_fwd(R, &maps.map[0], dx, 0, h);
      for (int i = 1; i < 4; ++i) produce_fwd(R, &maps.map[i], h, 0, h);
      produce_fwd(R, &maps.map[4], dx, h, h);   // z5: w4a, then w4b
      produce_fwd(R, &maps.map[6], h, 0, h);
      produce_fwd(R, &maps.map[7], h, 0, h);
      produce_fwd(R, &maps.map[8], h, 0, o);
    }
    produce_t(R, &dm.map[0], nb, o);            // g_bn into inter
    produce_t(R, &dm.map[1], o, h);             // d z7
    for (int i = 2; i < 8; ++i)                 // d z6 .. d h1
      produce_t(R, &dm.map[i], h, h);
  }
}

// Element c of the warp's row r of g, rounded to bf16: g_rt to rt (rows of
// 2), g_nct to nct (rows of 9), g_bn to bn (rows of ldb); with STORE, where
// the row is valid, also to d8 (n, 2), d9 (n, 9) and d10 (n, nb).
template <bool STORE>
__device__ __forceinline__ void spa_bwd_put(
    float v, int r, int c, int64_t r0, int64_t n, int nb, bf16_t* rt,
    bf16_t* nct, bf16_t* bn, int ldb, bf16_t* __restrict__ d8,
    bf16_t* __restrict__ d9, bf16_t* __restrict__ d10) {
  const bf16_t b = from_f<bf16_t>(v);
  const int64_t row = r0 + r;
  const bool keep = STORE && row < n;
  if (c < 2) {
    rt[r * 2 + c] = b;
    if (keep) d8[row * 2 + c] = b;
  } else if (c < HEAD_FIXED) {
    nct[r * 9 + c - 2] = b;
    if (keep) d9[row * 9 + c - 2] = b;
  } else {
    bn[r * ldb + c - HEAD_FIXED] = b;
    if (keep) d10[row * nb + c - HEAD_FIXED] = b;
  }
}

// The warp's 16 rows of the heads' cotangent g (n, 11 + nb) f32 from row r0
// on, rounded to bf16 (spa_bwd_put), rows past n as zeros.  The rows are one
// span of memory: a lane takes every 32nd group of 4 floats, 16 bytes at a
// time where the span is aligned, each batch of GB groups loaded before any
// is placed.
template <bool STORE>
__device__ __forceinline__ void spa_bwd_g(
    const float* __restrict__ g, int nb, int64_t r0, int64_t n, bf16_t* rt,
    bf16_t* nct, bf16_t* bn, int ldb, bf16_t* __restrict__ d8,
    bf16_t* __restrict__ d9, bf16_t* __restrict__ d10) {
  constexpr int GB = 6;
  const int lane = threadIdx.x & 31;
  const int hw = HEAD_FIXED + nb, total = 16 * hw;
  const int64_t left = n - r0;
  const int valid = (left <= 0 ? 0 : left < 16 ? (int)left : 16) * hw;
  const float* src = g + r0 * hw;
  const bool vec = (uintptr_t)src % 16 == 0;
  __syncwarp();                             // the rows' last readers are done
  for (int i0 = 4 * lane; i0 < total; i0 += 4 * 32 * GB) {
    float4 v[GB];
#pragma unroll
    for (int b = 0; b < GB; ++b) {
      const int i = i0 + 4 * 32 * b;
      if (vec && i + 4 <= valid) {
        v[b] = *reinterpret_cast<const float4*>(src + i);
      } else {
        v[b].x = i < valid ? src[i] : 0.f;
        v[b].y = i + 1 < valid ? src[i + 1] : 0.f;
        v[b].z = i + 2 < valid ? src[i + 2] : 0.f;
        v[b].w = i + 3 < valid ? src[i + 3] : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < GB; ++b) {
      const int i = i0 + 4 * 32 * b;
      if (i >= total) break;
      int r = i / hw, c = i - r * hw;
      const float e[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < total)
          spa_bwd_put<STORE>(e[k], r, c, r0, n, nb, rt, nct, bn, ldb, d8, d9,
                             d10);
        if (++c == hw) {
          c = 0;
          ++r;
        }
      }
    }
  }
}

// The warp's 16 rows of a stored activation (w wide, dense rows in the
// stage ``st``, as frame_load_x lands them) as the mask bits that
// spa_frame_delta reads: bit c % 32 of word c / 32 of row r is (act > 0),
// rows past n clear.  A lane reads 8 columns (16 bytes) of a row; the 4
// lanes of a 32-column word gather its bytes.
__device__ __forceinline__ void spa_bwd_bits(const bf16_t* st, int w,
                                             uint32_t* mbits, int64_t r0,
                                             int64_t n) {
  const int lane = threadIdx.x & 31;
  const int mw = mask_words(w);
  for (int r = 0; r < 16; ++r) {
    const bool live = r0 + r < n;
    for (int c0 = 0; c0 < w; c0 += 256) {
      const int c = c0 + 8 * lane;
      uint32_t b = 0u;
      if (live && c < w) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + r * w + c);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
              &u[k]);
          b |= (uint32_t)(__low2float(p) > 0.f) << (2 * k);
          b |= (uint32_t)(__high2float(p) > 0.f) << (2 * k + 1);
        }
      }
      uint32_t x = b << (8 * (lane & 3));
      x |= __shfl_xor_sync(0xffffffffu, x, 1);
      x |= __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0 && c < w) mbits[r * mw + (c >> 5)] = x;
    }
  }
}

// The residual form's hook of a delta pass (spa_frame_delta's): the warp's
// stage holds the stored activation (w wide) that masks the layer whose
// products are in: its bits to mbits, then the copy of the activation that
// masks the next layer (``next``, nw wide, rows from nr0; null: none) into
// the stage.
struct SpaBwdMask {
  bf16_t* st;
  uint32_t* mbits;
  int w;
  const bf16_t* next;
  int nw;
  int64_t r0, nr0, n;

  __device__ __forceinline__ void operator()() const {
    cp_async_wait<0>();
    __syncwarp();                           // every lane's copies are in
    spa_bwd_bits(st, w, mbits, r0, n);
    __syncwarp();                           // and read
    if (next != nullptr) frame_load_x(next, nw, nr0, n, st);
  }
};

// d(inter) of the warp's rows into out (rows of ldo): the bottleneck's
// pullback g_bn @ wbn^T (bn: rows of ldb, nb wide; its k-steps from the
// ring) and the narrow pullbacks g_rt @ wrt^T and g_nct @ wnct^T (mma.sync
// of the rows of rt and nct with the staged rows whn,
// spa_bwd_frame_consts), each rounded to bf16 and added in the order of
// the form (RC: (bn + nct) + rt, as jax.vjp adds them; else (rt + nct) +
// bn) with a rounding after each add, masked by inter's bits (mbits) and
// rows past n, rounded to bf16.  ``hook`` runs once the first pass's
// products are in, before their epilogue reads mbits.
template <int FWG, bool RC, typename Hook>
__device__ __forceinline__ FRing spa_bwd_inter(
    FRing R, const bf16_t* bn, int ldb, int nb, const bf16_t* rt,
    const bf16_t* nct, const bf16_t* whn, int o, const uint32_t* mbits,
    bf16_t* out, int ldo, int64_t r0, int64_t n, Hook hook) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mw = mask_words(o);
  uint32_t art[4], anct[4];                 // k past 2 and 9 as zeros
  frame_a(art, rt, 2, 2, 0, false);
  frame_a(anct, nct, 9, 9, 0, false);
  for (int c0 = 0; c0 < o; c0 += FCOLS) {
    const int np = o - c0 < FCOLS ? o - c0 : FCOLS, nt = np >> 3;
    float acc[FCOLS / 8][4];
    R = frame_products<true, FWG>(acc, R, bn, ldb, nb, nullptr, 0, 0,
                                  (np + 31) >> 5);
    if (c0 == 0) hook();
    const bool live[2] = {r0 + g < n, r0 + g + 8 < n};
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < FCOLS / 8; t += 2) {
      if (t >= nt) break;
      if ((t & 3) == 0) {                   // the rows' mask word of 32 columns
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)     // this lane's columns at bits 8 i
          word[hh] = live[hh]
              ? mbits[(g + 8 * hh) * mw + (c0 >> 5) + (t >> 2)] >> (2 * q)
              : 0u;
      }
      uint32_t u[4];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        // n-tile t + d of the narrow products: B's column g is inter's
        // column c0 + 8 (t + d) + g, its rows k = 2 q, 2 q + 1 (b[0]) and
        // + 8 (b[1]): g_rt's two and g_nct's nine, zeros past them
        float prt[4] = {0.f, 0.f, 0.f, 0.f}, pnc[4] = {0.f, 0.f, 0.f, 0.f};
        if (t + d < nt) {
          const bf16_t* wr = whn + (c0 + 8 * (t + d) + g) * 16;
          const uint32_t brt[2] = {
              q == 0 ? *reinterpret_cast<const uint32_t*>(wr + 10) : 0u, 0u};
          const uint32_t bnc[2] = {
              *reinterpret_cast<const uint32_t*>(wr + 2 * q),
              q == 0 ? *reinterpret_cast<const uint32_t*>(wr + 8) : 0u};
          mma_bf16(prt, art, brt);
          mma_bf16(pnc, anct, bnc);
        }
        const int sh = 8 * ((t + d) & 3);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hh + e;
            const float prod = to_f(from_f<bf16_t>(acc[t + d][i]));
            const float pr = to_f(from_f<bf16_t>(0.f + prt[i]));
            const float pn = to_f(from_f<bf16_t>(0.f + pnc[i]));
            const float two = to_f(from_f<bf16_t>(pn + (RC ? prod : pr)));
            v[e] = (word[hh] >> (sh + e)) & 1u ? (RC ? pr : prod) + two
                                               : 0.f;
          }
          const __nv_bfloat162 vv = __floats2bfloat162_rn(v[0], v[1]);
          u[2 * d + hh] = *reinterpret_cast<const uint32_t*>(&vv);
        }
      }
      frame_store_pair(out, ldo, c0 + 8 * t, t + 1 < nt, u);
    }
  }
  __syncwarp();
  return R;
}

// The consumers' nt threads stage the constants (spa_bwd_frame_consts) at
// cb: in the recompute form the rebuild's biases b0 .. b7; the narrow heads'
// weights as rows of 16 bf16; then they meet at named barrier 1 (the
// producer's warpgroup has left).
template <bool RC>
__device__ __forceinline__ void spa_bwd_stage_consts(
    float* cb, const FrameConsts& C, const RefSpaWeights<bf16_t>& p, int h,
    int o, int nt) {
  const int tid = threadIdx.x;
  if constexpr (RC) {
    const float* bs[8] = {p.b0, p.b1, p.b2, p.b3, p.b4, p.b5, p.b6, p.b7};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      for (int j = tid; j < (i == 7 ? o : h); j += nt) cb[i * h + j] = bs[i][j];
  }
  bf16_t* whn = reinterpret_cast<bf16_t*>(cb + C.whead);
  const bf16_t z = from_f<bf16_t>(0.f);
  for (int j = tid; j < 16 * o; j += nt) {
    const int k = j >> 4, t = j & 15;
    whn[j] = t < 9 ? p.wnct[k * 9 + t]
           : t == 10 || t == 11 ? p.wrt[k * 2 + t - 10] : z;
  }
  bar_sync(1, nt);
}

// The frame (see the top of this file and of spa_frame.cuh).  x: the
// recompute form's enc rows; g: the heads' cotangent (n, 11 + nb) f32; s:
// SpaBwdPtrs; maps: spa_maps (the recompute form's rebuild); dm: spa_dmaps.
template <int FORM>
__global__ void __launch_bounds__(384, 1)
spa_bwd_frame_kernel(const bf16_t* __restrict__ x,
                     const float* __restrict__ g, RefSpaWeights<bf16_t> p,
                     int64_t n, int dx, int h, int o, int nb, FrameLayout L,
                     const __grid_constant__ SpaBwdPtrs s,
                     const __grid_constant__ TileMaps maps,
                     const __grid_constant__ TileMaps dm) {
  constexpr bool RC = FORM == FORM_SPA_BWD_RC;
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
      spa_bwd_produce<RC>(R, maps, dm, tiles, dx, h, o, nb);
    return;
  }
  setmaxnreg_inc<FREGS_CONSUMER>();
  const int wr = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's rows
  const int lda = L.lda;
  bf16_t* act = reinterpret_cast<bf16_t*>(base + L.act) + wr * lda;
  bf16_t* xs = reinterpret_cast<bf16_t*>(base + L.xs) + wr * dx;
  bf16_t* st = reinterpret_cast<bf16_t*>(base + L.ds) + wr * (h > o ? h : o);
  uint32_t* mk = reinterpret_cast<uint32_t*>(base + L.masks) + wr * L.mw;
  bf16_t* grt = reinterpret_cast<bf16_t*>(base + L.frows) + wr * 2;
  bf16_t* gnct = reinterpret_cast<bf16_t*>(base + L.frows) + TM * 2 + wr * 9;
  float* cb = reinterpret_cast<float*>(base + L.consts);
  const bf16_t* whn = reinterpret_cast<const bf16_t*>(cb + L.c.whead);
  spa_bwd_stage_consts<RC>(cb, L.c, p, h, o, 128 * cons);
  // each layer writes nxt and then reads it as cur: the same rows in one
  // buffer, or the other buffer where a width exceeds FCOLS
  const int flip = L.two ? TM * lda : 0;
  const int mstep = RC ? TM * L.mw : 0;   // layer i's bits at mk + i * mstep
  int64_t tile = blockIdx.x;
  if (tile < tiles) {
    if constexpr (RC)
      frame_load_x(x, dx, tile * TM + wr, n, xs);
    else                                    // the stored inter's rows
      frame_load_x(s.a[7], o, tile * TM + wr, n, st);
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM + wr;
    const bool more = tile + gridDim.x < tiles;
    bf16_t* cur = act + flip;
    bf16_t* nxt = act;
    bf16_t* t;
    if constexpr (RC) {
      // h1 .. h4, z5 (the skip: enc @ w4a + h4 @ w4b), z6, z7, inter
      cp_async_wait<0>();
      __syncwarp();
      const bf16_t* none = nullptr;
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        const bool enc = i == 0 || i == 4;
        R = spa_frame_layer<FWG_GRAD>(
            R, enc ? xs : cur, enc ? dx : lda, enc ? dx : h,
            i == 4 ? cur : none, lda, i == 4 ? h : 0, cb + i * h,
            i == 7 ? o : h, nxt, lda, mk + i * mstep);
        frame_store(nxt, lda, s.a[i], i == 7 ? o : h, r0, n);
        t = cur;
        cur = nxt;
        nxt = t;
        if (i == 4 && more)                 // the encoding is read
          frame_load_x(x, dx, (tile + gridDim.x) * TM + wr, n, xs);
      }
    }
    spa_bwd_g<!RC>(g, nb, r0, n, grt, gnct, nxt, lda, s.d[8], s.d[9],
                   s.d[10]);
    __syncwarp();
    t = cur;
    cur = nxt;
    nxt = t;
    // d(inter), then d7 .. d1: the residual form reads each layer's bits
    // from the stage and starts the next layer's copy (SpaBwdMask)
    if constexpr (RC)
      R = spa_bwd_inter<FWG_GRAD, true>(R, cur, lda, nb, grt, gnct, whn, o,
                                        mk + 7 * mstep, nxt, lda, r0, n,
                                        FrameNoHook());
    else
      R = spa_bwd_inter<FWG_GRAD, false>(
          R, cur, lda, nb, grt, gnct, whn, o, mk, nxt, lda, r0, n,
          SpaBwdMask{st, mk, o, s.a[6], h, r0, r0, n});
    frame_store(nxt, lda, s.d[7], o, r0, n);
    t = cur;
    cur = nxt;
    nxt = t;
#pragma unroll 1
    for (int j = 0; j < 7; ++j) {
      const int li = 6 - j;                 // the masked layer: z7 .. h1
      const int k = j == 0 ? o : h;
      if constexpr (RC) {
        R = spa_frame_delta<FWG_GRAD>(R, cur, lda, k, h, mk + li * mstep,
                                      nxt, lda, r0, n);
      } else {
        // after h1's bits: inter's rows of the block's next tile
        const bool last = li == 0;
        R = spa_frame_delta<FWG_GRAD>(
            R, cur, lda, k, h, mk, nxt, lda, r0, n,
            SpaBwdMask{st, mk, h,
                       last ? (more ? s.a[7] : nullptr) : s.a[li - 1],
                       last ? o : h, r0,
                       last ? r0 + (int64_t)gridDim.x * TM : r0, n});
      }
      frame_store(nxt, lda, s.d[li], h, r0, n);
      t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

// The body that a bf16 spatial backward (``rc``: the recompute form) at
// these dims (dx h o nb) runs on the current device: the frame's layout
// (spa_bwd_layout, two consumer warpgroups first; *smem its bytes, *sms
// the device's SMs), or *smem 0 where no layout fits or a width is no
// multiple of 8, and the 64-row tile runs instead, chosen by shape before
// any launch.  Returns 0 or a CUDA error code.
inline int spa_bwd_frame_body(const int* dims, bool rc, FrameLayout* L,
                              size_t* smem, int* sms) {
  *smem = 0;
  if (dims[1] % 8 || dims[2] % 8 || dims[3] % 8) return 0;
  int limit = 0;
  const int e = frame_device(sms, &limit);
  if (e != 0) return e;
  for (int cons = 2; cons >= 1 && *smem == 0; --cons)
    *smem = spa_bwd_layout(L, rc, dims[0], dims[1], dims[2], dims[3], limit,
                           cons);
  return 0;
}

// Launches form FORM of the backward frame on ``stream`` over n rows (x: the
// recompute form's enc rows, g their heads' cotangent) at the layout L
// (smem bytes, sms the device's SMs) that spa_bwd_frame_body found, with
// the maps of spa_dmaps (dm) and, for the recompute form's rebuild, of
// spa_maps (maps), one block an SM, min(tiles, SMs) blocks; acts and deltas
// as SpaBwdPtrs takes them.  Returns 0 or a CUDA error code.
template <int FORM>
int launch_spa_bwd_frame(const bf16_t* x, const float* g,
                         const RefSpaWeights<bf16_t>& p, int64_t n,
                         const int* dims, const uint64_t* acts,
                         const uint64_t* deltas, const TileMaps& maps,
                         const TileMaps& dm, const FrameLayout& L,
                         size_t smem, int sms, cudaStream_t stream) {
  SpaBwdPtrs s = {};
  for (int i = 0; i < 8; ++i) s.a[i] = (bf16_t*)acts[i];
  for (int i = 0; i < (FORM == FORM_SPA_BWD ? 11 : 8); ++i)
    s.d[i] = (bf16_t*)deltas[i];
  const int64_t tiles = (n + 64 * L.cons - 1) / (64 * L.cons);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  const auto kernel = spa_bwd_frame_kernel<FORM>;
  const int err =
      set_smem(kernel, smem, FRAME_NAMES[FORM], 1, 128 * (L.cons + 1));
  if (err != 0 || n == 0) return err;
  kernel<<<grid, 128 * (L.cons + 1), smem, stream>>>(
      x, g, p, n, dims[0], dims[1], dims[2], dims[3], L, s, maps, dm);
  return (int)cudaGetLastError();
}

}  // namespace
