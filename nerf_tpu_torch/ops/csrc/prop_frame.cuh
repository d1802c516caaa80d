// The proposal net's fused forwards in bf16 on the persistent frame of
// spa_frame.cuh: prop_mlp_fwd (FORM_PROP) and prop_mlp_fwd_res
// (FORM_PROP_RES, h1 .. h4 stored).  fused_mlp.cu launches these for a bf16
// tensor; its f32 bodies, and the bf16 ones at widths whose frame does not
// fit a block's shared memory (prop_frame_body), keep the 64-row tile
// (fused_mlp.cu's prop_mlp_fwd_kernel).
//
// Replaces: the bf16 bodies of prop_mlp_fwd_kernel<STORE, T>, which ported
// the Pallas kernel nerf_tpu/ops/fused_mlp.py:478 (_prop_fwd_kernel, res
// :483, pallas_call at :569) on dense_tile's 64-row frame: two blocks an
// SM, each weight ring opened and drained at every layer, a block-wide
// barrier after every layer, W read from L2 for every 64 rows, and the
// density head one warp a row.
//
// Bound on an H100 SXM (700 W), by operations (fused_mlp.cu): 0.113 ms for
// an eval chunk's 262,144 points; by bytes, 0.043 ms for a step's 65,536
// points with their 2 KB of activations a point.
//
// Design.  The vanilla frame's (vanilla_frame.cuh), on the net with the
// fewest parts: a persistent block an SM of two consumer warpgroups (64
// rows each, 128-point tiles; one on 64-point tiles where a width leaves
// two buffers of 128 rows no room) and a producer warpgroup whose first
// thread streams w0 (dx -> h), then w1 .. w3 (h -> h) of every tile through
// one ring (frame_produce, the map list of prop_maps), never drained; the
// products (frame_kloop), a layer's epilogue with the ReLU
// (spa_frame_layer), the stores (frame_store), the layout and its search
// (frame_layout, frame_search) and the setmaxnreg split.  What the
// proposal net adds:
//   one input tile, enc (dx wide), each warp's 16 rows copied in by
//   cp.async (frame_load_x), the next tile's once layer 1 has read this
//   one's (no later layer reads it);
//   the density head over h4, vanilla_frame_head with one output (the
//   vanilla net's sigma head): each point summed as head_tile sums it
//   (lane-strided fmaf from k = 0, then the butterfly, folded over the
//   warp's 16 rows by frame_fold_rows), the bias added last, no
//   activation; density leaves as (N,) f32;
//   the training form stores h1 .. h4 through frame_store to pointers
//   read where the launch put them (a __grid_constant__ parameter: the
//   layer loop indexes them, which would copy a plain parameter to local
//   memory).
//
// Arithmetic, element by element that of prop_mlp_fwd_kernel, so that every
// output equals the 64-row tile's bit for bit: each 16-deep k-step is summed
// from zero by wgmma and added to the f32 sum in the order of k (G = 1);
// the f32 bias, then the ReLU, then the rounding to bf16; enc's columns
// past dx and W's rows past k read as zeros, as dense_tile pads its
// k-tail; the head is summed as head_tile sums it.

#pragma once

#include "vanilla_frame.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

// Device pointers of the 4 stored activations h1 h2 h3 h4, (n, h) each.
struct PropFrameActs {
  bf16_t* a[4];
};

// The frame (see the top of this file and of spa_frame.cuh).
template <int FORM>
__global__ void __launch_bounds__(384, 1)
prop_frame_kernel(const bf16_t* __restrict__ x, PropWeights<bf16_t> p,
                  int64_t n, int dx, int h, FrameLayout L,
                  const __grid_constant__ PropFrameActs s,
                  float* __restrict__ out,
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
      frame_produce<FORM>(R, maps, maps, tiles, dx, h, h, 0);
    return;
  }
  setmaxnreg_inc<FREGS_CONSUMER>();
  const int lane = threadIdx.x & 31;
  const int wr = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's rows
  const int lda = L.lda;
  bf16_t* act = reinterpret_cast<bf16_t*>(base + L.act) + wr * lda;
  bf16_t* xs = reinterpret_cast<bf16_t*>(base + L.xs) + wr * dx;
  const FrameConsts& C = L.c;
  float* cb = reinterpret_cast<float*>(base + L.consts);
  {   // the consumers stage b0 .. b3, bo and (where staged) wo, then meet
    const int tid = threadIdx.x, nt = 128 * cons;
    const float* bs[4] = {p.b0, p.b1, p.b2, p.b3};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      for (int j = tid; j < h; j += nt) cb[i * h + j] = bs[i][j];
    if (tid == 0) cb[C.heads_b] = p.bo[0];
    for (int j = tid; C.whead >= 0 && j < h; j += nt)
      cb[C.whead + j] = to_f(p.wo[j]);
    bar_sync(1, nt);
  }
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
    // h1 .. h4, the biases one after the other in cb
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      R = spa_frame_layer<FWG_EVAL>(R, i == 0 ? xs : cur, i == 0 ? dx : lda,
                                    i == 0 ? dx : h, none, lda, 0,
                                    cb + i * h, h, nxt, lda, nullptr);
      if constexpr (FORM == FORM_PROP_RES)
        frame_store(nxt, lda, s.a[i], h, r0, n);
      bf16_t* t = cur;
      cur = nxt;
      nxt = t;
      if (i == 0 && tile + gridDim.x < tiles)   // enc is read
        frame_load_x(x, dx, (tile + gridDim.x) * TM + wr, n, xs);
    }
    float v[16];                                // the density, from h4
    const int row = vanilla_frame_head(
        cur, lda, h, VanillaHeadW{cb, C.whead, p.wo, 1, 0}, v);
    if (!(lane & 1) && r0 + row < n) out[r0 + row] = v[0] + cb[C.heads_b];
    __syncwarp();
  }
}

// The body that a bf16 proposal forward of these widths runs on the
// current device: the frame's layout (frame_search; *smem its bytes, *sms
// the device's SMs), or *smem 0 where no layout fits and the 64-row tile of
// fused_mlp.cu runs instead, chosen by shape before any launch.  Returns 0
// or a CUDA error code.
inline int prop_frame_body(int dx, int h, bool store, FrameLayout* L,
                           size_t* smem, int* sms) {
  return frame_search(L, smem, sms, store ? FORM_PROP_RES : FORM_PROP, dx,
                      h, h, 0);
}

// Launches the bf16 proposal forward on ``stream`` (launch_prop's
// arguments) at the layout L (smem bytes, sms the device's SMs) that
// prop_frame_body found: the maps of prop_maps, one block an SM,
// min(tiles, SMs) blocks.  Returns 0 or a CUDA error code.
template <bool STORE>
int launch_prop_frame(const void* x, const uint64_t* ptrs, int64_t n, int dx,
                      int h, float* out, const uint64_t* acts,
                      const FrameLayout& L, size_t smem, int sms,
                      cudaStream_t stream) {
  constexpr int FORM = STORE ? FORM_PROP_RES : FORM_PROP;
  const PropWeights<bf16_t> p = prop_weights<bf16_t>(ptrs);
  TileMaps maps;
  int err = prop_maps<bf16_t>(&maps, p, dx, h);
  if (err != 0) return err;
  PropFrameActs s = {};
  for (int i = 0; STORE && i < 4; ++i) s.a[i] = (bf16_t*)acts[i];
  const int64_t tiles = (n + 64 * L.cons - 1) / (64 * L.cons);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  const auto kernel = prop_frame_kernel<FORM>;
  err = set_smem(kernel, smem, FRAME_NAMES[FORM], 1, 128 * (L.cons + 1));
  if (err != 0 || n == 0) return err;
  kernel<<<grid, 128 * (L.cons + 1), smem, stream>>>(
      (const bf16_t*)x, p, n, dx, h, L, s, out, maps);
  return (int)cudaGetLastError();
}

}  // namespace
