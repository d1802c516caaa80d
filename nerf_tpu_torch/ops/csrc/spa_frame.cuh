// The Ref-NeRF spatial net's fused forwards in bf16, as a persistent frame
// for Hopper: ref_spa_fwd (FORM_EVAL), ref_spa_fwd_res (FORM_RES) and
// ref_spa_fwd_grad (FORM_GRAD).  ref_fused.cu launches these for a bf16
// tensor; its f32 bodies, and the bf16 ones at widths whose frame does not
// fit a block's shared memory (spa_frame_body), keep the 64-row tile of
// mlp_tile.cuh.  The frame's
// parts (the ring, the producer, the products, a layer, the stores, the
// layout and its search, the setmaxnreg split) also run the directional
// net's forwards (FORM_DIR, FORM_DIR_RES), whose input stage and tail are
// in dir_frame.cuh, and the vanilla net's (FORM_VANILLA, FORM_VANILLA_RES),
// whose input tiles, heads and layer list are in vanilla_frame.cuh, and
// the proposal net's (FORM_PROP, FORM_PROP_RES), whose layer list and
// density head are in prop_frame.cuh.
//
// Replaces: the bf16 bodies of ref_fused.cu's ref_spa_fwd_kernel and
// ref_spa_fwd_res_kernel, which ported the Pallas kernel
// nerf_tpu/ops/ref_fused.py:643 (_make_spa_fwd_kernel, pallas_call at
// :1059) on dense_tile's 64-row frame: two blocks an SM, each weight ring
// opened and drained at every layer, W read from L2 for every 64 rows.
//
// Bound on an H100 SXM (700 W), by operations (ref_fused.cu): 0.837 ms for
// an eval chunk's 786,432 points, 0.405 ms for a step's 196,608 points with
// the density gradient.
//
// Design.  The grid is min(tiles, SMs), one block an SM, and a block walks
// the tiles of 128 points blockIdx.x, blockIdx.x + gridDim.x, ... (the
// ragged last one masked).  Its 384 threads: two consumer
// warpgroups, each owning 64 rows of the tile and every column of a layer
// up to FCOLS = 256 (128 f32 accumulators a thread: setmaxnreg raises a
// consumer to 232 registers), and a producer warpgroup lowered to 40
// (three warps share an SM partition's 16,384 registers, so 9 or 12 warps
// at one budget would leave 168 a thread), whose first thread streams the
// weights of every layer of every tile of the block, in
// the order the consumers take them, through one ring of up to FSTAGES
// slots of 8 KB (a k-step: 16 rows of W in boxes of 64 columns in the
// 128-byte swizzle for a forward layer and the bottleneck head, or 16
// columns of W's rows in the 32-byte swizzle for the density gradient's
// transposed products, the maps of spa_maps and spa_dmaps).  Full
// barriers complete on the TMA bytes, empty ones on one arrival of each
// consumer warp; the ring is never drained, so a layer's first k-steps
// arrive while the layer before it finishes, and each box feeds 128 rows.
// A consumer warp reads and writes only its own 16 rows (its A fragments,
// its epilogue, its masks, its heads), so the warps meet only at the ring's
// barriers and inside their warpgroup's wgmma: no block-wide barrier runs
// after the set-up.  A pass holds its whole output in registers, so a
// layer of at most FCOLS columns writes its output over its input: one
// activation buffer (two, ping-pong, where a width exceeds FCOLS and a
// layer takes more passes; where two buffers of 128 rows do not fit, as
// above 256 wide, the same kernel runs one consumer warpgroup on 64-point
// tiles, 256 threads, and where even those leave the ring no room, as in
// the training forms at 512 wide, the narrow heads' weights and the
// encoding's tables are read from device memory instead of staged).  The
// ReLU masks stay as bits in shared memory in both training forms: no
// activation is read back from device memory.
// The next tile's encoding rows are copied in (cp.async) once the skip
// layer has read this tile's.
//
// Arithmetic, element by element that of dense_tile and delta_tile
// (mlp_tile.cuh), so that the outputs equal the 64-row frame's bit for bit:
// each 16-deep k-step of a 32-column block is summed from zero by wgmma
// m64n32k16 (scale-d 0) and added to the f32 sum in the order of k (G = 1);
// two blocks' products are in flight at a time (wgmma_wait<1>), which
// changes no sum.  A forward layer then adds the bias in f32, applies the
// ReLU and rounds to bf16; the bottleneck head writes acc + bias in f32;
// a delta pass masks and rounds; a pullback into the encoding rounds to
// bf16 and adds in f32 (enc_pull).  The narrow heads sum each (point,
// output) as narrow_head does (lane-strided fmaf, then a butterfly).  The
// density column's first pullback, [0, 1] @ wrt^T, is wrt[:, 1] itself
// (0 + w, as the zero-padded product gives it), so no mma.sync is left.
// The encoding's transpose and the normal target run one lane a point.

#pragma once

#include "ref_common.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

// A block's consumer warpgroups, cons (FrameLayout, chosen at launch): two,
// on tiles of 128 points; one, on tiles of 64, where a width above FCOLS
// leaves the two activation buffers of 128 rows no room (two buffers of
// 128 rows of 512 are 266 KB, more than a block's 227).  Its threads: 128
// (cons + 1), the producer's warpgroup last.
constexpr int FREGS_PRODUCER = 40;        // setmaxnreg: registers a thread
constexpr int FREGS_CONSUMER = 232;
// A block starts at the 168 registers a thread of its __launch_bounds__
// (384 threads); a consumer's raise waits until the producer's cut has
// freed them, as many at one consumer warpgroup as at two.
static_assert((168 - FREGS_PRODUCER) * 128 >= (FREGS_CONSUMER - 168) * 256,
              "the consumers' registers would wait for ever");
constexpr int FCOLS = 256;                // output columns a pass
constexpr int FSLOT = 8192;               // bytes of a ring slot
constexpr int FSTAGES = 12;               // slots at most
// Columns of one wgmma (two in flight): 64 in ref_spa_fwd, 32 in
// the training forms, whose other state leaves no room for two partials of
// 64 columns beside the 128 accumulators (ptxas spilled).  The tensor
// cores' sum of a column does not depend on the product's width: the
// identities with dense_layer hold at every width (tools/tile_variants).
constexpr int FWG_EVAL = 64;
constexpr int FWG_GRAD = 32;
constexpr int FORM_EVAL = 0, FORM_RES = 1, FORM_GRAD = 2;
// the directional net's forms (dir_frame.cuh): ref_dir_fwd and
// ref_dir_fwd_res
constexpr int FORM_DIR = 3, FORM_DIR_RES = 4;
// the vanilla net's (vanilla_frame.cuh): vanilla_mlp_fwd and
// vanilla_mlp_fwd_res
constexpr int FORM_VANILLA = 5, FORM_VANILLA_RES = 6;
// the proposal net's (prop_frame.cuh): prop_mlp_fwd and prop_mlp_fwd_res
constexpr int FORM_PROP = 7, FORM_PROP_RES = 8;
// the spatial net's backward delta passes (spa_bwd_frame.cuh): ref_spa_bwd's
// and ref_spa_bwd_recompute's
constexpr int FORM_SPA_BWD = 9, FORM_SPA_BWD_RC = 10;
// the names under which set_smem notes each form's occupancy
constexpr const char* FRAME_NAMES[11] = {
    "spa_frame_kernel<eval>", "spa_frame_kernel<res>",
    "spa_frame_kernel<grad>", "dir_frame_kernel<eval>",
    "dir_frame_kernel<res>", "vanilla_frame_kernel<eval>",
    "vanilla_frame_kernel<res>", "prop_frame_kernel<eval>",
    "prop_frame_kernel<res>", "spa_bwd_frame_kernel<res>",
    "spa_bwd_frame_kernel<recompute>"};
static_assert(FCOLS == DPASS && DK == TK && FSLOT == DSLOT * 2
              && FSLOT == TSLOT * 2, "a slot holds one k-step of a pass");

// setmaxnreg: this warpgroup's registers a thread, lowered (the producer)
// or raised (a consumer) from the 168 of the launch's bounds.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Row stride of an activation buffer of width w: whole 16-byte pieces, an
// odd number of them, so that an ldmatrix's 8 rows meet no bank conflict.
__host__ __device__ constexpr int frame_ld(int w) {
  return (w + 15) / 16 * 16 + 8;
}

// The constants that the consumers stage in shared memory once (f32, in
// floats from the start of their piece): the biases b0 .. b6 (h each), b7
// (o), bbn (nb), brt (2) and bnct (9) one after the other; the narrow
// heads' weights [wrt | wnct] as (o, 11) rows (whead); the positional
// encoding's pe_w (3, dx - 3) and pe_b (dx - 3) for the density gradient.
// (Read from device memory in every epilogue, they missed the small L1
// that the frame's shared memory leaves.)  Without ``staged`` only the
// biases: whead, pe_w and pe_b are -1, and the kernel reads those from
// device memory.  The directional net's (dir_frame_consts) lie in the same
// fields.
struct FrameConsts {
  int bbn, heads_b, whead, pe_w, pe_b, floats;

  FrameConsts() = default;
  __host__ __device__ FrameConsts(int dx, int h, int o, int nb, bool grad,
                                  bool staged) {
    bbn = 7 * h + o;
    heads_b = bbn + nb;
    whead = (heads_b + 11 + 3) & ~3;
    pe_w = whead + 11 * o;
    pe_b = pe_w + 3 * (dx - 3);
    floats = grad ? pe_b + dx - 3 : pe_w;
    if (!staged) {
      floats = heads_b + 11;
      whead = pe_w = pe_b = -1;
    }
  }
};

// The directional net's constants: the biases b0 .. b5 (h each), b6 and b7
// (o each) and bh (3, at heads_b); the specular head's weights wh as (o, 3)
// f32 rows (whead); the IDE's tables mat ((l_max + 1) x C, at pe_w) and
// sigma (C, at pe_b).  Without ``staged`` the biases alone.
inline FrameConsts dir_frame_consts(int h, int o, int l_max, int n_ch,
                                    bool staged) {
  FrameConsts c;
  c.bbn = -1;
  c.heads_b = 6 * h + 2 * o;
  c.whead = (c.heads_b + 3 + 3) & ~3;
  c.pe_w = c.whead + 3 * o;
  c.pe_b = c.pe_w + (l_max + 1) * n_ch;
  c.floats = c.pe_b + n_ch;
  if (!staged) {
    c.floats = c.heads_b + 3;
    c.whead = c.pe_w = c.pe_b = -1;
  }
  return c;
}

// The vanilla net's constants: the biases b0 .. b5 (h each), b6 (bn), bb
// (bn, at bbn), br1 (r), then bsig (1) and br2 (3) at heads_b; the heads'
// weights as f32 (whead): wsig (bn), then wr2 as (r, 3) rows.  Without
// ``staged`` the biases alone.
inline FrameConsts vanilla_frame_consts(int h, int bn, int r, bool staged) {
  FrameConsts c;
  c.bbn = 6 * h + bn;
  c.heads_b = 6 * h + 2 * bn + r;
  c.whead = (c.heads_b + 4 + 3) & ~3;
  c.pe_w = c.pe_b = -1;
  c.floats = c.whead + bn + 3 * r;
  if (!staged) {
    c.floats = c.heads_b + 4;
    c.whead = -1;
  }
  return c;
}

// The proposal net's constants: the biases b0 .. b3 (h each), then bo (1)
// at heads_b; the density head's weights wo as h f32 values (whead).
// Without ``staged`` the biases alone.
inline FrameConsts prop_frame_consts(int h, bool staged) {
  FrameConsts c;
  c.bbn = -1;
  c.heads_b = 4 * h;
  c.whead = (c.heads_b + 1 + 3) & ~3;
  c.pe_w = c.pe_b = -1;
  c.floats = c.whead + h;
  if (!staged) {
    c.floats = c.heads_b + 1;
    c.whead = -1;
  }
  return c;
}

// The narrow heads' weights [wrt | wnct] as (o, 11) f32 rows: staged at
// cb + off, or read from the bf16 weights where off is -1 (the same values:
// a bf16 converts to f32 exactly).  Made where it is used from what the
// consumers hold anyway (cb) and kernel parameters, so that it keeps no
// register across the tile loop.
struct HeadW {
  const float* cb;
  int off;
  const bf16_t* wrt;
  const bf16_t* wnct;

  __device__ __forceinline__ float operator()(int k, int t) const {
    if (off >= 0) return cb[off + k * 11 + t];
    return to_f(t < 2 ? wrt[2 * k + t] : wnct[9 * k + t - 2]);
  }
};

// Where the frame's pieces lie, in bytes from the first 1024-byte boundary
// of the block's dynamic shared memory: the ring (slot s at s * FSLOT), the
// activation buffer(s), the input tile (rows of ldx), the vanilla net's
// second input tile (ds: enc_d, dense rows of dd), the 8 layers' masks,
// the f32 row tile (frows: the density gradient's d(density)/d(enc), or the
// directional net's sigmoid(tint) and sigmoid(diffuse), 6 a row), the
// constants (FrameConsts), the barriers (full[stages], empty[stages]).
struct FrameLayout {
  int cons, stages, lda, ldx, mw, two;    // two: ping-pong buffers
  int act, xs, ds, masks, frows, consts, bars;
  FrameConsts c;                          // (a kernel parameter: no register
};                                        // holds its offsets)

// Places the ring before pieces of these bytes (FrameLayout's order) in
// ``limit`` bytes: as many slots as fit, up to FSTAGES; returns the dynamic
// shared memory bytes, or 0 where fewer than two slots fit.
inline size_t frame_place(FrameLayout* L, size_t act, size_t xs, size_t ds,
                          size_t masks, size_t frows, size_t consts,
                          int limit) {
  const size_t rest = act + xs + ds + masks + frows + consts;
  const long room = (long)limit - 1024 - (long)rest;
  const long fit = room > 0 ? room / (FSLOT + 16) : 0;
  L->stages = fit < FSTAGES ? (int)fit : FSTAGES;
  if (L->stages < 2) return 0;
  size_t at = (size_t)L->stages * FSLOT;
  L->act = (int)at;
  L->xs = (int)(at += act);
  L->ds = (int)(at += xs);
  L->masks = (int)(at += ds);
  L->frows = (int)(at += masks);
  L->consts = (int)(at += frows);
  L->bars = (int)(at += consts);
  return 1024 + at + (size_t)16 * L->stages;
}

// Fills L for a kernel of form ``form`` with ``cons`` consumer warpgroups,
// its constants ``staged`` or not (FrameConsts), and returns its dynamic
// shared memory bytes (1024 of them to align the ring), or 0 where fewer
// than two slots fit beside the rest in ``limit`` bytes.  dx: the width of
// the input rows (the spatial net's encoding, dense as its copy lands; the
// directional net's x, at frame_ld's stride, which the glue writes);
// l_max and n_ch: the directional net's IDE tables.  The vanilla forms read
// o as bn and nb as r (vanilla_frame.cuh's widths) and dd, enc_d's width;
// the proposal forms take o = h and nb = 0 (its trunk is h wide).
inline size_t frame_layout(FrameLayout* L, int form, int cons, bool staged,
                           int dx, int h, int o, int nb, int limit,
                           int l_max = 0, int n_ch = 0, int dd = 0) {
  const int rows = 64 * cons;
  L->cons = cons;
  auto up16 = [](size_t b) { return (b + 15) & ~(size_t)15; };
  const bool dir = form == FORM_DIR || form == FORM_DIR_RES;
  const bool van = form == FORM_VANILLA || form == FORM_VANILLA_RES;
  const bool prop = form == FORM_PROP || form == FORM_PROP_RES;
  int maxw = h > o ? h : o;
  if (van && nb > maxw) maxw = nb;
  L->lda = frame_ld(maxw);
  L->ldx = dir ? frame_ld(dx) : dx;
  L->two = maxw > FCOLS;
  L->mw = mask_words(maxw);
  const bool grad = form == FORM_RES || form == FORM_GRAD;
  const size_t act = (size_t)(L->two ? 2 : 1) * rows * L->lda * 2;
  const size_t xs = up16((size_t)rows * L->ldx * 2);
  const size_t ds = van ? up16((size_t)rows * dd * 2) : 0;
  const size_t masks = grad ? (size_t)8 * rows * L->mw * 4 : 0;
  const size_t frows = grad ? up16((size_t)rows * dx * 4)
                            : dir ? (size_t)rows * 6 * 4 : 0;
  L->c = dir ? dir_frame_consts(h, o, l_max, n_ch, staged)
      : van ? vanilla_frame_consts(h, o, nb, staged)
      : prop ? prop_frame_consts(h, staged)
             : FrameConsts(dx, h, o, nb, grad, staged);
  return frame_place(L, act, xs, ds, masks, frows,
                     up16((size_t)L->c.floats * 4), limit);
}

// The current device's SMs (*sms) and the shared memory a block may opt in
// to (*limit).  Returns 0 or a CUDA error code.
inline int frame_device(int* sms, int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)e;
}

// The layout of form ``form`` at these widths on the current device (L,
// its dynamic shared memory bytes at *smem, the device's SMs at *sms): two
// consumer warpgroups on 128-point tiles, or one on 64-point tiles where
// those do not fit (a width above FCOLS), each with its constants staged,
// or not where even that leaves the ring no room.  *smem is 0 where no
// layout fits.  Returns 0 or a CUDA error code.
inline int frame_search(FrameLayout* L, size_t* smem, int* sms, int form,
                        int dx, int h, int o, int nb, int l_max = 0,
                        int n_ch = 0, int dd = 0) {
  int limit = 0;
  const int e = frame_device(sms, &limit);
  if (e != 0) return e;
  *smem = 0;
  int cons = 2;   // 128-point tiles first
  for (; cons >= 1 && *smem == 0; --cons)
    for (int staged = 1; staged >= 0 && *smem == 0; --staged)
      *smem = frame_layout(L, form, cons, staged, dx, h, o, nb, limit, l_max,
                           n_ch, dd);
  return 0;
}

// The ring as every thread of the block walks it: its slots and barriers
// (shared-memory addresses) and the next k-step's slot and phase.  The
// consumers wait full[slot] for parity ``phase``, the producer empty[slot]
// for the parity before it (which a fresh barrier reads as complete).
struct FRing {
  uint32_t base, bars;
  int stages, slot;
  uint32_t phase;

  __device__ uint32_t addr() const { return base + slot * FSLOT; }
  __device__ uint32_t full() const { return bars + 8 * slot; }
  __device__ uint32_t empty() const { return bars + 8 * (stages + slot); }
  __device__ void next() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// Producer: the k-steps of a forward layer (or the bottleneck head),
// w0's (k0 rows) then w1's (k1; map + 1), pass by pass of FCOLS columns:
// one TMA box a 64-column atom of the pass, W's rows past k and columns
// past n_out as zeros (weight_map).
__device__ __forceinline__ void produce_fwd(FRing& R, const CUtensorMap* map,
                                            int k0, int k1, int n_out) {
  const int s0 = (k0 + DK - 1) / DK, per = s0 + (k1 + DK - 1) / DK;
  for (int c0 = 0; c0 < n_out; c0 += FCOLS) {
    const int np = n_out - c0 < FCOLS ? n_out - c0 : FCOLS;
    const int boxes = (np + DATOM - 1) / DATOM;
    for (int j = 0; j < per; ++j) {
      const bool second = j >= s0;
      mbar_wait(R.empty(), R.phase ^ 1u);
      mbar_expect_tx(R.full(), boxes * DK * DATOM * 2);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(R.addr() + b * DK * DATOM * 2, second ? map + 1 : map,
                    R.full(), c0 + b * DATOM, (second ? j - s0 : j) * DK);
      R.next();
    }
  }
}

// Producer: the k-steps of a transposed product a @ W^T, W the layer's
// (n_out, k_dim) forward matrix: one box of TK columns by
// tbox_rows(n_out, FCOLS) rows of W a k-step, pass by pass (delta_map).
__device__ __forceinline__ void produce_t(FRing& R, const CUtensorMap* map,
                                          int k_dim, int n_out) {
  const int per = (k_dim + TK - 1) / TK;
  const uint32_t bytes = TK * tbox_rows(n_out, FCOLS) * 2;
  for (int c0 = 0; c0 < n_out; c0 += FCOLS)
    for (int j = 0; j < per; ++j) {
      mbar_wait(R.empty(), R.phase ^ 1u);
      mbar_expect_tx(R.full(), bytes);
      tma_load_2d(R.addr(), map, R.full(), j * TK, c0);
      R.next();
    }
}

// The producer's whole stream: the layers of each of the block's tiles in
// the consumers' order (the map indices of spa_maps and spa_dmaps, of
// dir_maps for the directional forms, whose trunk ends in two O-wide
// layers, of vanilla_maps for the vanilla forms, o = bn and nb = r, or of
// prop_maps for the proposal forms, whose trunk ends at h4; dx the input
// rows' width, dd enc_d's).
template <int FORM>
__device__ void frame_produce(FRing R, const TileMaps& maps,
                              const TileMaps& dm, int64_t tiles, int dx,
                              int h, int o, int nb, int dd = 0) {
  constexpr bool DIR = FORM == FORM_DIR || FORM == FORM_DIR_RES;
  constexpr bool VAN = FORM == FORM_VANILLA || FORM == FORM_VANILLA_RES;
  constexpr bool PROP = FORM == FORM_PROP || FORM == FORM_PROP_RES;
  constexpr bool GRAD = FORM == FORM_RES || FORM == FORM_GRAD;
  for (int i = 0; i < (PROP ? 4 : VAN ? 11 : DIR ? 9 : 10); ++i) {
    prefetch_tensormap(&maps.map[i]);
    if (GRAD) prefetch_tensormap(&dm.map[i]);
  }
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    produce_fwd(R, &maps.map[0], dx, 0, h);       // h1
    produce_fwd(R, &maps.map[1], h, 0, h);        // h2
    produce_fwd(R, &maps.map[2], h, 0, h);        // h3
    produce_fwd(R, &maps.map[3], h, 0, h);        // h4
    if constexpr (PROP) continue;
    produce_fwd(R, &maps.map[4], dx, h, h);       // z5: w4a, then w4b (5)
    produce_fwd(R, &maps.map[6], h, 0, h);        // z6
    if constexpr (VAN) {
      produce_fwd(R, &maps.map[7], h, 0, o);      // z7 (w6)
      produce_fwd(R, &maps.map[8], o, 0, o);      // bvec (wb)
      produce_fwd(R, &maps.map[9], o, dd, nb);    // r1: wr1a, then wr1b (10)
      continue;
    }
    if constexpr (DIR) {
      produce_fwd(R, &maps.map[7], h, 0, o);      // z7
      produce_fwd(R, &maps.map[8], o, 0, o);      // z8
      continue;
    }
    produce_fwd(R, &maps.map[7], h, 0, h);        // z7
    produce_fwd(R, &maps.map[8], h, 0, o);        // inter
    produce_fwd(R, &maps.map[9], o, 0, nb);       // the bottleneck head
    if (GRAD) {
      produce_t(R, &dm.map[1], o, h);             // d z7
      produce_t(R, &dm.map[2], h, h);             // d z6
      produce_t(R, &dm.map[3], h, h);             // d z5
      produce_t(R, &dm.map[8], h, dx);            // into the encoding
      produce_t(R, &dm.map[4], h, h);             // d h4
      produce_t(R, &dm.map[5], h, h);             // d h3
      produce_t(R, &dm.map[6], h, h);             // d h2
      produce_t(R, &dm.map[7], h, h);             // d h1
      produce_t(R, &dm.map[9], h, dx);            // into the encoding
    }
  }
}

// stmatrix: four (x4) or two (x2) 8 x 8 bf16 blocks, each thread's r[i]
// the mma fragment of block i (row lane / 4, columns 2 (lane % 4) and + 1),
// to rows at the shared-memory addresses that lanes 8 i .. 8 i + 7 give.
__device__ __forceinline__ void stsm_x4(bf16_t* p, uint32_t r0, uint32_t r1,
                                        uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_addr(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ void stsm_x2(bf16_t* p, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n"
               ::"r"(smem_addr(p)), "r"(r0), "r"(r1) : "memory");
}

// n-tiles t and t + 1 of the warp's 16 rows (t + 1 < nt: both, else t
// alone), u[2 d + hh] the packed pair of tile t + d at row g + 8 hh, to the
// rows of stride ldo at ``out`` from column col0 = 8 t on.
__device__ __forceinline__ void frame_store_pair(bf16_t* out, int ldo,
                                                 int col0, bool two,
                                                 const uint32_t (&u)[4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  bf16_t* at = out + ((lane & 7) + 8 * (mi & 1)) * ldo + col0 + 8 * (mi >> 1);
  if (two)
    stsm_x4(at, u[0], u[1], u[2], u[3]);
  else
    stsm_x2(at, u[0], u[1]);
}

// The A fragment of the warp's 16 rows (row stride ld), columns kk .. kk +
// 15, as load_a takes it: one ldmatrix where the rows are 16-byte aligned
// and the k-step lies inside k_dim, else element loads with columns past
// k_dim as zeros.
__device__ __forceinline__ void frame_a(uint32_t (&af)[4], const bf16_t* a,
                                        int ld, int k_dim, int kk,
                                        bool aligned) {
  const int lane = threadIdx.x & 31;
  if (aligned && kk + 16 <= k_dim) {
    ldsm_x4(af[0], af[1], af[2], af[3],
            a + (lane & 15) * ld + kk + (lane >> 4) * 8);
    return;
  }
  const int g = lane >> 2, c = kk + 2 * (lane & 3);
  const bf16_t* ra = a + g * ld;
  const bf16_t* rb = ra + 8 * ld;
  const bf16_t z = __float2bfloat16_rn(0.f);
  af[0] = pack_bf16(c < k_dim ? ra[c] : z, c + 1 < k_dim ? ra[c + 1] : z);
  af[1] = pack_bf16(c < k_dim ? rb[c] : z, c + 1 < k_dim ? rb[c + 1] : z);
  af[2] = pack_bf16(c + 8 < k_dim ? ra[c + 8] : z,
                    c + 9 < k_dim ? ra[c + 9] : z);
  af[3] = pack_bf16(c + 8 < k_dim ? rb[c + 8] : z,
                    c + 9 < k_dim ? rb[c + 9] : z);
}

// d (the warpgroup's 64 x N f32 tile; this thread's N / 8 n-tiles of the
// mma.sync fragment layout, d[4 t + e] as wgmma_m64n32k16's d[t][e]) =
// a @ b, summed from zero (scale-d 0): a the warp's 16 x 16 bf16 rows in
// registers, b 16 x N bf16 in shared memory through ``desc``, MN-major
// with TRANS_B 1 (a forward layer's W), K-major with 0 (W^T).  N = 32, 64
// or 128.  Asynchronous: complete it with wgmma_commit and wgmma_wait.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B),
        "r"(0));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B),
        "r"(0));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B),
        "r"(0));
}

// The products of one pass for the warpgroup's 64 rows: acc[t] = n-tile t
// (columns 8 t .. 8 t + 7 of the pass) of a0 @ w0 [+ a1 @ w1], or with
// KMAJOR of a0 @ W^T, over NB blocks of 32 columns (the pass's, rounded up
// to 2, 4 or 8: a block past the pass's columns multiplies what its slot
// holds there and is not read); a0 and a1 the warp's rows.  The k-steps in
// order, a0's then a1's; for each, the products of FWG columns (or the
// pass's NB blocks, if fewer) summed from zero, each added to acc once it
// lands while the next is in flight.  No product or wait is conditional
// (ptxas serializes the wgmma of a path it cannot prove uniform).  The warp
// releases a slot once its products are done.
template <bool KMAJOR, int NB, int FWG>
__device__ __forceinline__ FRing frame_kloop(
    float (&acc)[FCOLS / 8][4], FRing R, const bf16_t* a0, int ld0, int k0,
    const bf16_t* a1, int ld1, int k1) {
  constexpr int W = FWG < NB * 32 ? FWG : NB * 32;   // a product's columns
  constexpr int NP = NB * 32 / W;                    // products a k-step
  const int lane = threadIdx.x & 31;
  const bool al0 = (uintptr_t)a0 % 16 == 0 && ld0 % 8 == 0;
  const bool al1 = (uintptr_t)a1 % 16 == 0 && ld1 % 8 == 0;
  const int s0 = (k0 + DK - 1) / DK, per = s0 + (k1 + DK - 1) / DK;
  float part[2][W / 2];
#pragma unroll
  for (int t = 0; t < FCOLS / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) part[i][e] = 0.f;
  for (int k = 0; k < per; ++k) {
    const bool on1 = k >= s0;
    uint32_t af[4];
    frame_a(af, on1 ? a1 : a0, on1 ? ld1 : ld0, on1 ? k1 : k0,
            (on1 ? k - s0 : k) * DK, on1 ? al1 : al0);
    const uint32_t slot = R.addr();
    mbar_wait(R.full(), R.phase);
#pragma unroll
    for (int w = 0; w < NP; ++w) {
      wgmma_fence();
      if constexpr (KMAJOR)
        wgmma_rs<0>(part[w & 1], af,
                    wgmma_desc_sw32(slot + w * W * TK * 2, 8 * TK * 2));
      else
        wgmma_rs<1>(part[w & 1], af,
                    wgmma_desc_sw128(slot + (w * W / DATOM) * DK * DATOM * 2
                                     + (w * W % DATOM) * 2,
                                     DK * DATOM * 2, 8 * DATOM * 2));
      wgmma_commit();
      if (w >= 1) {                         // product w - 1 has landed
        wgmma_wait<1>();
        wgmma_hold(part[(w - 1) & 1]);
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[(w - 1) * (W / 8) + j][e] += part[(w - 1) & 1][4 * j + e];
      }
    }
    wgmma_wait<0>();                        // and the last
    wgmma_hold(part[(NP - 1) & 1]);
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[(NP - 1) * (W / 8) + j][e] += part[(NP - 1) & 1][4 * j + e];
    wgmma_hold(af);
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty());
    R.next();
  }
  return R;
}

// frame_kloop over the pass's nblk blocks of 32 columns, rounded up to 2,
// 4 or 8, FWG columns a product.
template <bool KMAJOR, int FWG>
__device__ __forceinline__ FRing frame_products(
    float (&acc)[FCOLS / 8][4], FRing R, const bf16_t* a0, int ld0, int k0,
    const bf16_t* a1, int ld1, int k1, int nblk) {
  if (nblk > 4)
    return frame_kloop<KMAJOR, 8, FWG>(acc, R, a0, ld0, k0, a1, ld1, k1);
  if (nblk > 2)
    return frame_kloop<KMAJOR, 4, FWG>(acc, R, a0, ld0, k0, a1, ld1, k1);
  return frame_kloop<KMAJOR, 2, FWG>(acc, R, a0, ld0, k0, a1, ld1, k1);
}

// What a delta pass runs between its first pass's products and their
// epilogue: nothing (the forwards' density gradient), or the spatial
// backward's reading of its next mask (spa_bwd_frame.cuh).
struct FrameNoHook {
  __device__ __forceinline__ void operator()() const {}
};

// A forward layer of the warp's rows: out = relu(a0 @ w0 [+ a1 @ w1] +
// bias) rounded to bf16 (rows of stride ldo, over the input where out is
// a0's buffer and n_out <= FCOLS); with mbits the mask (out > 0) as bits,
// mask_words(n_out) words a row.  Without ``relu`` (the vanilla net's
// bottleneck) the sum is rounded as it stands.
template <int FWG>
__device__ __forceinline__ FRing spa_frame_layer(
    FRing R, const bf16_t* a0, int ld0, int k0, const bf16_t* a1, int ld1,
    int k1, const float* __restrict__ bias, int n_out, bf16_t* out, int ldo,
    uint32_t* mbits, bool relu = true) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mw = mask_words(n_out);
  for (int c0 = 0; c0 < n_out; c0 += FCOLS) {
    const int np = n_out - c0 < FCOLS ? n_out - c0 : FCOLS, nt = np >> 3;
    float acc[FCOLS / 8][4];
    R = frame_products<false, FWG>(acc, R, a0, ld0, k0, a1, ld1, k1,
                              (np + 31) >> 5);
    uint32_t bits[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < FCOLS / 8; t += 2) {
      if (t >= nt) break;
      uint32_t u[4];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int c = c0 + 8 * (t + d) + 2 * q;
        const float2 bb = t + d < nt
            ? *reinterpret_cast<const float2*>(bias + c) : make_float2(0.f, 0.f);
        const int sh = 8 * ((t + d) & 3);   // + 2 q at the flush
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v0 = acc[t + d][2 * hh] + bb.x;
          const float v1 = acc[t + d][2 * hh + 1] + bb.y;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              relu ? fmaxf(v0, 0.f) : v0, relu ? fmaxf(v1, 0.f) : v1);
          u[2 * d + hh] = *reinterpret_cast<const uint32_t*>(&v);
          // bf16 > 0 after the ReLU: a magnitude (a -0 has none)
          bits[hh] |= ((uint32_t)((u[2 * d + hh] & 0x7fffu) != 0u) << sh)
              | ((uint32_t)((u[2 * d + hh] & 0x7fff0000u) != 0u) << (sh + 1));
        }
      }
      frame_store_pair(out, ldo, c0 + 8 * t, t + 1 < nt, u);
      if (mbits != nullptr && ((t & 3) == 2 || t + 2 >= nt)) {
        // a 32-column word of rows g and g + 8 lies on the quad's 4 lanes;
        // bits of columns past n_out are 0
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t w = bits[hh] << (2 * q);
          w |= __shfl_xor_sync(0xffffffffu, w, 1);
          w |= __shfl_xor_sync(0xffffffffu, w, 2);
          if (q == 0) mbits[(g + 8 * hh) * mw + (c0 >> 5) + (t >> 2)] = w;
          bits[hh] = 0u;
        }
      }
    }
  }
  __syncwarp();                             // the warp's rows are written
  return R;
}

// The warp's valid rows of a layer's output (rows of stride ldo in shared
// memory) to the (n, n_out) array gout, 16 bytes at a time where gout is
// 16-byte aligned.
__device__ __forceinline__ void frame_store(const bf16_t* out, int ldo,
                                            bf16_t* __restrict__ gout,
                                            int n_out, int64_t r0,
                                            int64_t n) {
  const int lane = threadIdx.x & 31;
  const int vec = n_out >> 3;
  const bool gvec = (uintptr_t)gout % 16 == 0;
  for (int idx = lane; idx < 16 * vec; idx += 32) {
    const int rr = idx / vec, c = 8 * (idx - rr * vec);
    const int64_t row = r0 + rr;
    if (row >= n) continue;
    const bf16_t* src = out + rr * ldo + c;
    bf16_t* dst = gout + row * n_out + c;
    if (gvec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
}

// The bottleneck head of the warp's rows: heads[row, col0 + c] = a @ w[:, c]
// + bias[c] in f32, unrounded (wide_head).
template <int FWG>
__device__ __forceinline__ FRing spa_frame_head(FRing R, const bf16_t* a,
                                             int lda, int k_dim,
                                             const float* __restrict__ bias,
                                             int n_out,
                                             float* __restrict__ heads,
                                             int64_t ld, int col0, int64_t r0,
                                             int64_t n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int c0 = 0; c0 < n_out; c0 += FCOLS) {
    const int np = n_out - c0 < FCOLS ? n_out - c0 : FCOLS, nt = np >> 3;
    float acc[FCOLS / 8][4];
    R = frame_products<false, FWG>(acc, R, a, lda, k_dim, nullptr, 0, 0,
                              (np + 31) >> 5);
#pragma unroll
    for (int t = 0; t < FCOLS / 8; ++t) {
      if (t >= nt) break;
      const int c = c0 + 8 * t + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      const float b0 = bb.x, b1 = bb.y;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = r0 + g + 8 * hh;
        if (row < n) {
          heads[row * ld + col0 + c] = acc[t][2 * hh] + b0;
          heads[row * ld + col0 + c + 1] = acc[t][2 * hh + 1] + b1;
        }
      }
    }
  }
  return R;
}

// A delta pass of the density gradient over the warp's rows: out =
// mask (a @ W^T) rounded to bf16, W the layer's (n_out, k_dim) forward
// matrix, the mask the layer's bits (mbits), rows past n as zeros
// (delta_tile with MBITS); ``hook`` runs once the first pass's products
// are in, before their epilogue reads mbits.
template <int FWG, typename Hook = FrameNoHook>
__device__ __forceinline__ FRing spa_frame_delta(FRing R, const bf16_t* a,
                                              int lda, int k_dim, int n_out,
                                              const uint32_t* mbits,
                                              bf16_t* out, int ldo,
                                              int64_t r0, int64_t n,
                                              Hook hook = Hook()) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mw = mask_words(n_out);
  for (int c0 = 0; c0 < n_out; c0 += FCOLS) {
    const int np = n_out - c0 < FCOLS ? n_out - c0 : FCOLS, nt = np >> 3;
    float acc[FCOLS / 8][4];
    R = frame_products<true, FWG>(acc, R, a, lda, k_dim, nullptr, 0, 0,
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
        const int sh = 8 * ((t + d) & 3);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              (word[hh] >> sh) & 1u ? acc[t + d][2 * hh] : 0.f,
              (word[hh] >> (sh + 1)) & 1u ? acc[t + d][2 * hh + 1] : 0.f);
          u[2 * d + hh] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
      frame_store_pair(out, ldo, c0 + 8 * t, t + 1 < nt, u);
    }
  }
  __syncwarp();
  return R;
}

// A pullback into the encoding of the warp's rows: denc [+]= (a @ W^T
// rounded to bf16) in f32, W the layer's (n_out = dx, k_dim) forward
// matrix, one element at a time (n_out is odd; enc_pull).
template <int FWG>
__device__ __forceinline__ FRing spa_frame_pull(FRing R, const bf16_t* a,
                                             int lda, int k_dim, int n_out,
                                             float* denc, bool add) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int c0 = 0; c0 < n_out; c0 += FCOLS) {
    const int np = n_out - c0 < FCOLS ? n_out - c0 : FCOLS;
    const int nt = (np + 7) >> 3;
    float acc[FCOLS / 8][4];
    R = frame_products<true, FWG>(acc, R, a, lda, k_dim, nullptr, 0, 0,
                             (np + 31) >> 5);
#pragma unroll
    for (int t = 0; t < FCOLS / 8; ++t) {
      if (t >= nt) break;
      const int c = c0 + 8 * t + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ce = c + (e & 1);
        if (ce >= n_out) continue;
        float* d = denc + (g + 8 * (e >> 1)) * n_out + ce;
        const float v = to_f(from_f<bf16_t>(acc[t][e]));
        *d = add ? *d + v : v;
      }
    }
  }
  __syncwarp();
  return R;
}

// The 11 sums of a lane's partials v over the warp as the butterfly of
// narrow_head takes each (xor 16, 8, 4, 2, 1), the outputs folded into
// fewer values a level: at each level a lane keeps one output of a pair and
// adds its partner's copy of it, which is the butterfly's own sum of the
// same two values.  Returns the output whose total v[0] then holds.
__device__ __forceinline__ int frame_reduce11(float (&v)[11]) {
  const int lane = threadIdx.x & 31;
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {           // 11 -> 6: (0, 1) .. (8, 9), 10
    const float send = b16 ? v[2 * i] : v[2 * i + 1];
    const float keep = b16 ? v[2 * i + 1] : v[2 * i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  v[5] = v[10] + __shfl_xor_sync(0xffffffffu, v[10], 16);
#pragma unroll
  for (int i = 0; i < 3; ++i) {           // 6 -> 3
    const float send = b8 ? v[2 * i] : v[2 * i + 1];
    const float keep = b8 ? v[2 * i + 1] : v[2 * i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  {                                       // 3 -> 2: (0, 1), 2
    const float send = b4 ? v[0] : v[1];
    const float keep = b4 ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    v[1] = v[2] + __shfl_xor_sync(0xffffffffu, v[2], 4);
  }
  {                                       // 2 -> 1
    const float send = b2 ? v[0] : v[1];
    const float keep = b2 ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  const int s2 = b2 ? 2 : (b4 ? 1 : 0);   // the slots back up the levels
  const int s1 = 2 * s2 + (b8 ? 1 : 0);
  return s1 < 5 ? 2 * s1 + (b16 ? 1 : 0) : 10;
}

// The narrow heads of the warp's rows from inter (k_dim wide): rho_tau
// into heads columns 0-1 and normal, diffuse, tint into 2-10, in f32, from
// the (k_dim, 11) weights [wrt | wnct] (W) and their 11 staged biases
// (hb).  Each (row, output) is summed as narrow_head sums it: lane l over
// k = l, l + 32, ... by fmaf in order, then the butterfly (frame_reduce11),
// the bias added last.  Up to k_dim 256 a lane holds its weights in
// registers (8 k x 11).
__device__ __forceinline__ void spa_frame_narrow(
    const bf16_t* a, int lda, int k_dim, const HeadW& W, const float* hb,
    float* __restrict__ heads, int64_t ld, int64_t r0, int64_t n) {
  const int lane = threadIdx.x & 31;
  if (k_dim <= 256) {
    float wv[8][11];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
#pragma unroll
      for (int t = 0; t < 11; ++t)
        wv[j][t] = k < k_dim ? W(k, t) : 0.f;
    }
    for (int r = 0; r < 16; ++r) {
      float v[11];
#pragma unroll
      for (int t = 0; t < 11; ++t) v[t] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = lane + 32 * j;
        if (k < k_dim) {
          const float av = to_f(a[r * lda + k]);
#pragma unroll
          for (int t = 0; t < 11; ++t) v[t] = fmaf(av, wv[j][t], v[t]);
        }
      }
      const int o = frame_reduce11(v);
      if (!(lane & 1) && r0 + r < n) heads[(r0 + r) * ld + o] = v[0] + hb[o];
    }
    return;
  }
  for (int r = 0; r < 16; ++r) {
    float v[11];
#pragma unroll
    for (int t = 0; t < 11; ++t) v[t] = 0.f;
    for (int k = lane; k < k_dim; k += 32) {
      const float av = to_f(a[r * lda + k]);
#pragma unroll
      for (int t = 0; t < 11; ++t) v[t] = fmaf(av, W(k, t), v[t]);
    }
    const int o = frame_reduce11(v);
    if (!(lane & 1) && r0 + r < n) heads[(r0 + r) * ld + o] = v[0] + hb[o];
  }
}

// The density column's first pullback for the warp's rows: d(inter)[r, c] =
// mask (0 + wrt[c, 1]) rounded to bf16, [0, 1] @ wrt^T as the zero-padded
// product of the 64-row frame gives it (a zero weight as +0), wrt[c, 1]
// as W(c, 1); a lane takes pairs of columns.
__device__ __forceinline__ void frame_unit(const HeadW& W, int n_out,
                                           const uint32_t* mbits, bf16_t* out,
                                           int ldo, int64_t r0, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int mw = mask_words(n_out);
  for (int c = 2 * lane; c < n_out; c += 64) {
    const float w0 = 0.f + W(c, 1);
    const float w1 = 0.f + W(c + 1, 1);
    for (int r = 0; r < 16; ++r) {
      const uint32_t word = mbits[r * mw + (c >> 5)];
      const bool live = r0 + r < n;
      const float v0 = live && ((word >> (c & 31)) & 1u) ? w0 : 0.f;
      const float v1 = live && ((word >> ((c + 1) & 31)) & 1u) ? w1 : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncwarp();
}

// The encoding's transpose and the normal target of the warp's rows, one
// lane a point (ref_fused.cu's ref_spa_fwd_res_kernel): g = denc[:3] +
// (denc[3:] cos(pos @ pe_w + pe_b)) @ pe_w^T, target -g / max(1e-5, |g|),
// pe_w and pe_b staged (at cb + C.pe_w, cb + C.pe_b) or, where C.pe_w is
// -1, read from device memory.
__device__ __forceinline__ void spa_frame_target(
    const float* denc, int dx, const float* __restrict__ pos,
    const FrameConsts& C, const float* cb, const float* __restrict__ pe_w,
    const float* __restrict__ pe_b, float* __restrict__ dgrad, int64_t r0,
    int64_t n) {
  const int r = threadIdx.x & 31;
  const int64_t row = r0 + r;
  if (r >= 16 || row >= n) return;
  const int pc = dx - 3;
  const float* dr = denc + r * dx;
  const float* pr = pos + row * 3;
  float g0 = dr[0], g1 = dr[1], g2 = dr[2];
  const bool staged = C.pe_w >= 0;
  for (int j = 0; j < pc; ++j) {
    const float w0 = staged ? cb[C.pe_w + j] : pe_w[j];
    const float w1 = staged ? cb[C.pe_w + pc + j] : pe_w[pc + j];
    const float w2 = staged ? cb[C.pe_w + 2 * pc + j] : pe_w[2 * pc + j];
    const float b = staged ? cb[C.pe_b + j] : pe_b[j];
    const float proj = pr[0] * w0 + pr[1] * w1 + pr[2] * w2 + b;
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

// The warp's 16 encoding rows from r0 on into dst (dx wide, dense): 16-byte
// cp.async where the rows are aligned, rows past n as zeros.  Complete it
// with cp_async_wait<0>() and __syncwarp().
__device__ __forceinline__ void frame_load_x(const bf16_t* __restrict__ x,
                                             int dx, int64_t r0, int64_t n,
                                             bf16_t* dst) {
  const int lane = threadIdx.x & 31;
  const int64_t left = n - r0;
  const int count = (left <= 0 ? 0 : left < 16 ? (int)left : 16) * dx;
  const bf16_t* src = x + r0 * dx;
  int done = 0;
  if (count > 0 && ((uintptr_t)src | (uintptr_t)dst) % 16 == 0) {
    for (int j = lane; j < count / 8; j += 32) cp_async16(dst + 8 * j, src + 8 * j);
    done = count / 8 * 8;
  }
  cp_async_commit();
  for (int idx = done + lane; idx < 16 * dx; idx += 32)
    dst[idx] = idx < count ? src[idx] : from_f<bf16_t>(0.f);
}

// The consumers' nt threads stage the constants (FrameConsts) at cb, then
// meet at named barrier 1 (the producer's warpgroup has left).
template <bool GRAD>
__device__ __forceinline__ void frame_stage_consts(
    float* cb, const FrameConsts& C, const RefSpaWeights<bf16_t>& p, int dx,
    int h, int o, int nb, const float* __restrict__ pe_w,
    const float* __restrict__ pe_b, int nt) {
  const int tid = threadIdx.x;
  const float* bs[11] = {p.b0, p.b1, p.b2, p.b3, p.b4, p.b5, p.b6, p.b7,
                         p.bbn, p.brt, p.bnct};
  const int len[11] = {h, h, h, h, h, h, h, o, nb, 2, 9};
  for (int i = 0, at = 0; i < 11; at += len[i], ++i)
    for (int j = tid; j < len[i]; j += nt) cb[at + j] = bs[i][j];
  for (int j = tid; C.whead >= 0 && j < 11 * o; j += nt) {
    const int k = j / 11, t = j - 11 * k;
    cb[C.whead + j] = to_f(t < 2 ? p.wrt[k * 2 + t] : p.wnct[k * 9 + t - 2]);
  }
  if (GRAD && C.pe_w >= 0) {
    for (int j = tid; j < 4 * (dx - 3); j += nt)
      cb[C.pe_w + j] = j < 3 * (dx - 3) ? pe_w[j] : pe_b[j - 3 * (dx - 3)];
  }
  bar_sync(1, nt);
}

// The frame (see the top of this file).  s: the 8 stored activations
// (FORM_RES); pos, pe_w, pe_b and dgrad: the density gradient's
// (FORM_RES, FORM_GRAD).
template <int FORM>
__global__ void __launch_bounds__(384, 1)
spa_frame_kernel(const bf16_t* __restrict__ x, const float* __restrict__ pos,
                 const float* __restrict__ pe_w,
                 const float* __restrict__ pe_b, RefSpaWeights<bf16_t> p,
                 int64_t n, int dx, int h, int o, int nb, FrameLayout L,
                 Acts<bf16_t> s, float* __restrict__ heads,
                 float* __restrict__ dgrad,
                 const __grid_constant__ TileMaps maps,
                 const __grid_constant__ TileMaps dm) {
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
      frame_produce<FORM>(R, maps, dm, tiles, dx, h, o, nb);
    return;
  }
  setmaxnreg_inc<FREGS_CONSUMER>();
  constexpr bool GRAD = FORM != FORM_EVAL;
  constexpr int PW = GRAD ? FWG_GRAD : FWG_EVAL;
  const int wr = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's rows
  const int lda = L.lda;
  bf16_t* act = reinterpret_cast<bf16_t*>(base + L.act) + wr * lda;
  bf16_t* xs = reinterpret_cast<bf16_t*>(base + L.xs) + wr * dx;
  uint32_t* mk = reinterpret_cast<uint32_t*>(base + L.masks) + wr * L.mw;
  float* denc = reinterpret_cast<float*>(base + L.frows) + wr * dx;
  const FrameConsts& C = L.c;
  float* cb = reinterpret_cast<float*>(base + L.consts);
  frame_stage_consts<GRAD>(cb, C, p, dx, h, o, nb, pe_w, pe_b, 128 * cons);
  const bf16_t* none = nullptr;
  // each layer writes nxt and then reads it as cur: the same rows in one
  // buffer, or the other buffer where a width exceeds FCOLS
  const int flip = L.two ? TM * lda : 0;
  int64_t tile = blockIdx.x;
  if (tile < tiles) frame_load_x(x, dx, tile * TM + wr, n, xs);
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM + wr;
    cp_async_wait<0>();
    __syncwarp();
    bf16_t* cur = act + flip;
    bf16_t* nxt = act;
    // h1 .. h4, z5 (the skip: enc @ w4a + h4 @ w4b), z6, z7, inter
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const bool enc = i == 0 || i == 4;
      R = spa_frame_layer<PW>(R, enc ? xs : cur, enc ? dx : lda, enc ? dx : h,
                          i == 4 ? cur : none, lda, i == 4 ? h : 0, cb + i * h,
                          i == 7 ? o : h, nxt, lda,
                          GRAD ? mk + i * TM * L.mw : nullptr);
      if constexpr (FORM == FORM_RES)
        frame_store(nxt, lda, s.a[i], i == 7 ? o : h, r0, n);
      bf16_t* t = cur;
      cur = nxt;
      nxt = t;
      if (i == 4 && tile + gridDim.x < tiles)   // the encoding is read
        frame_load_x(x, dx, (tile + gridDim.x) * TM + wr, n, xs);
    }
    spa_frame_narrow(cur, lda, o, HeadW{cb, C.whead, p.wrt, p.wnct},
                     cb + C.heads_b, heads, HEAD_FIXED + nb, r0, n);
    R = spa_frame_head<PW>(R, cur, lda, o, cb + C.bbn, nb, heads, HEAD_FIXED + nb,
                       HEAD_FIXED, r0, n);
    if constexpr (GRAD) {
      // the density column's pullback: [0, 1] @ wrt^T (masked by inter),
      // then w7^T .. w5^T, the pullback into the encoding through w4a,
      // w4b^T .. w1^T and the one through w0
      frame_unit(HeadW{cb, C.whead, p.wrt, p.wnct}, o, mk + 7 * TM * L.mw,
                 nxt, lda, r0, n);
      bf16_t* t = cur;
      cur = nxt;
      nxt = t;
#pragma unroll 1
      for (int j = 0; j < 9; ++j) {
        if (j == 3 || j == 8) {
          R = spa_frame_pull<PW>(R, cur, lda, h, dx, denc, j == 8);
          continue;
        }
        const int li = j < 3 ? 6 - j : 7 - j;     // the masked layer
        R = spa_frame_delta<PW>(R, cur, lda, j == 0 ? o : h, h,
                            mk + li * TM * L.mw, nxt, lda, r0, n);
        t = cur;
        cur = nxt;
        nxt = t;
      }
      spa_frame_target(denc, dx, pos, C, cb, pe_w, pe_b, dgrad, r0, n);
      __syncwarp();
    }
  }
}

// The body that a bf16 spatial forward of form ``form`` at these dims
// (dims: dx h o nb) runs on the current device: the frame's layout
// (frame_search; *smem its bytes, *sms the device's SMs), or *smem 0 where
// no layout fits and the 64-row tile of ref_fused.cu runs instead, chosen
// by shape before any launch.  Returns 0 or a CUDA error code.
inline int spa_frame_body(const int* dims, int form, FrameLayout* L,
                          size_t* smem, int* sms) {
  return frame_search(L, smem, sms, form, dims[0], dims[1], dims[2],
                      dims[3]);
}

// Launches form FORM of the frame on ``stream`` at the layout L (smem
// bytes, sms the device's SMs) that spa_frame_body found: the maps of the
// weights (spa_maps; spa_dmaps for the density gradient), one block an SM,
// min(tiles, SMs) blocks.  Returns 0 or a CUDA error code.
template <int FORM>
int launch_spa_frame(const bf16_t* x, const float* pos, const float* pe_w,
                     const float* pe_b, const RefSpaWeights<bf16_t>& p,
                     int64_t n, int dx, int h, int o, int nb,
                     float* heads, float* dgrad, const uint64_t* acts,
                     const FrameLayout& L, size_t smem, int sms,
                     cudaStream_t stream) {
  TileMaps maps, dm;
  int err = spa_maps<bf16_t>(&maps, p, dx, h, o, nb);
  if (err == 0 && FORM != FORM_EVAL)
    err = spa_dmaps<bf16_t>(&dm, p, dx, h, o, nb, FCOLS);
  if (err != 0) return err;
  Acts<bf16_t> s = {};
  if (acts != nullptr) s = acts_of<bf16_t>(acts);
  const int64_t tiles = (n + 64 * L.cons - 1) / (64 * L.cons);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  const auto kernel = spa_frame_kernel<FORM>;
  err = set_smem(kernel, smem, FRAME_NAMES[FORM], 1, 128 * (L.cons + 1));
  if (err != 0 || n == 0) return err;
  kernel<<<grid, 128 * (L.cons + 1), smem, stream>>>(
      x, pos, pe_w, pe_b, p, n, dx, h, o, nb, L, s, heads, dgrad, maps, dm);
  return (int)cudaGetLastError();
}

}  // namespace
