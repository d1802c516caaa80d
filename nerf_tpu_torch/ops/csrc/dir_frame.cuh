// The Ref-NeRF directional net's fused forwards in bf16 on the persistent
// frame of spa_frame.cuh: ref_dir_fwd (FORM_DIR) and ref_dir_fwd_res
// (FORM_DIR_RES, the 8 activations stored).  ref_fused.cu launches these for
// a bf16 tensor; its f32 bodies, and the bf16 ones at widths whose frame
// does not fit a block's shared memory (dir_frame_body), keep the 64-row
// tile of ref_dir_fwd.cuh, which the dissection (ref_dissect.cu) runs too.
//
// Replaces: the bf16 bodies of ref_dir_fwd.cuh's ref_dir_fwd_kernel at
// DIR_FULL, which ported the Pallas kernel nerf_tpu/ops/ref_fused.py:841
// (_make_dir_fwd_kernel, pallas_call at :1173) with its glue
// _dir_glue_pure_rowland (:575) on dense_tile's 64-row frame: two blocks an
// SM, each weight ring opened and drained at every layer, W read from L2
// for every 64 rows.
//
// Bound on an H100 SXM (700 W), by operations (ref_fused.cu): 0.867 ms for
// an eval chunk's 786,432 points; by bytes, 0.290 ms for a step's 196,608
// points with their 4 KB of activations a point.
//
// Design.  The spatial frame's, part for part: a persistent block an SM of
// two consumer warpgroups (64 rows each, 128-point tiles; one on 64-point
// tiles where a width leaves two buffers of 128 rows no room) and a
// producer warpgroup whose first thread streams every layer's weights
// through one ring (frame_produce, the map list of dir_maps), the products
// (frame_kloop), a layer's epilogue (spa_frame_layer), the stores
// (frame_store), the layout and its search (frame_layout, frame_search) and
// the setmaxnreg split.  What the directional net adds:
//   the input stage (dir_frame_input): each consumer warp writes its own 16
//   rows of x = [bottleneck + noise | IDE | d.n] into the frame's input
//   tile (rows of frame_ld(dd), so that ldmatrix reads the k-steps),
//   the glue one lane a point through ref_common.cuh's dir_glue<DIR_FULL>,
//   the 64-row tile's own code, with the IDE tables staged beside the
//   biases; the normal and the density go to device memory, sigmoid(tint)
//   and sigmoid(diffuse) to the f32 row tile until the tail;
//   the trunk's widths: z7 and z8 are O wide (the spatial net has one O-wide
//   layer);
//   the tail (dir_frame_tail): spec = sigmoid(z8 @ wh + bh), each (point,
//   output) summed as narrow_head sums it (lane-strided fmaf, then the
//   butterfly, folded as spa_frame_narrow folds 11 outputs), then rgb =
//   spec tint + diffuse [-> sRGB], as ref_dir_fwd.cuh writes it;
//   the training form stores h1 .. h4, z5, z6 (H wide), z7 and z8 (O wide)
//   through frame_store; the directional forward has no gradient pass, so
//   no ReLU mask is kept.
// The glue runs at each tile's start, so one slot of tint and diffuse
// serves; the next tile's heads rows are prefetched into L2 meanwhile.
//
// Arithmetic, element by element that of ref_dir_fwd.cuh at DIR_FULL, so
// that every output equals the 64-row tile's bit for bit: the same dir_glue,
// the trunk's products and epilogues as the spatial frame's (each 16-deep
// k-step summed from zero by wgmma and added to the f32 sum in k order,
// the bias in f32, the ReLU, rounding to bf16; x's columns past dd and W's
// rows past dd read as zeros, as dense_tile pads its k-tail), the head and
// the tail as narrow_head and the 64-row tile's last loop write them.

#pragma once

#include "ref_dir_fwd.cuh"
#include "spa_frame.cuh"

namespace {   // each library that includes this keeps its own copy

using namespace mlp;

// The specular head's weights wh (o, 3): staged at cb + off as f32 rows, or
// read from the bf16 weights where off is -1 (HeadW's rule).
struct DirHeadW {
  const float* cb;
  int off;
  const bf16_t* wh;

  __device__ __forceinline__ float operator()(int k, int t) const {
    if (off >= 0) return cb[off + k * 3 + t];
    return to_f(wh[3 * k + t]);
  }
};

// L2 prefetch of the line that holds p.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The heads rows (and the noise rows) of the warp's 16 points from r0 on,
// line by line into L2, for the input stage of the warp's next tile.
__device__ __forceinline__ void dir_frame_prefetch(
    const float* __restrict__ heads, const bf16_t* __restrict__ noise,
    const DirDims& d, int64_t r0, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t left = n - r0;
  const int rows = left <= 0 ? 0 : left < 16 ? (int)left : 16;
  const int64_t hw = HEAD_FIXED + d.nb;
  const char* h = reinterpret_cast<const char*>(heads + r0 * hw);
  for (int64_t b = (int64_t)lane * 128; b < (int64_t)rows * hw * 4; b += 32 * 128)
    prefetch_l2(h + b);
  if (noise == nullptr) return;
  const char* z = reinterpret_cast<const char*>(noise + r0 * d.nb);
  for (int64_t b = (int64_t)lane * 128; b < (int64_t)rows * d.nb * 2; b += 32 * 128)
    prefetch_l2(z + b);
}

// The input stage of the warp's 16 points from r0 on (ref_dir_fwd.cuh's
// first two loops, for the warp's rows): x = [bottleneck + noise | IDE |
// d.n] in bf16 into xs (rows of stride ldx), sigmoid(tint) and
// sigmoid(diffuse [- ln 3]) into td (6 floats a row), the normal and the
// density to device memory; rows past n as zeros.  The bottleneck's
// loads are issued a half of 64 columns at a time, 32 in flight a lane;
// the glue runs one lane a point (dir_glue<DIR_FULL>) on the IDE tables
// mat and sig (staged or in device memory).
__device__ __forceinline__ void dir_frame_input(
    const float* __restrict__ heads, const bf16_t* __restrict__ noise,
    const float* __restrict__ dirs, int64_t per_ray, const float* mat,
    const float* sig, const DirDims& d, int64_t r0, int64_t n, bf16_t* xs,
    int ldx, float* td, float* __restrict__ normal,
    float* __restrict__ density) {
  const int lane = threadIdx.x & 31;
  const int64_t hw = HEAD_FIXED + d.nb;
  for (int c0 = 0; c0 < d.nb; c0 += 64) {
    float v[2][16];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int c = c0 + lane + 32 * j;
        const int64_t row = r0 + r;
        v[j][r] = 0.f;
        if (c < d.nb && row < n) {
          v[j][r] = heads[row * hw + HEAD_FIXED + c];
          if (noise != nullptr) v[j][r] += to_f(noise[row * d.nb + c]);
        }
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int c = c0 + lane + 32 * j;
        if (c < d.nb) xs[r * ldx + c] = from_f<bf16_t>(v[j][r]);
      }
  }
  if (lane < 16) {
    const int64_t row = r0 + lane;
    bf16_t* xr = xs + lane * ldx;
    float* t = td + lane * 6;
    if (row < n) {
      dir_glue<DIR_FULL>(heads + row * hw, dirs + (row / per_ray) * 3, mat,
                         sig, d, xr, t, t + 3, normal + row * 3,
                         density + row);
    } else {
      for (int c = d.nb; c < d.dd; ++c) xr[c] = from_f<bf16_t>(0.f);
      for (int k = 0; k < 6; ++k) t[k] = 0.f;
    }
  }
  __syncwarp();
}

// The 3 sums of a lane's partials v over the warp as the butterfly of
// narrow_head takes each (xor 16, 8, 4, 2, 1), folded as frame_reduce11
// folds 11: outputs (0, 1) share the first level, then the pair and output 2
// the second.  Returns the output whose total v[0] then holds: 2 on lanes
// with bit 8, else 1 on lanes with bit 16, else 0.
__device__ __forceinline__ int frame_reduce3(float (&v)[3]) {
  const int lane = threadIdx.x & 31;
  const bool b16 = lane & 16, b8 = lane & 8;
  {                                       // 3 -> 2: (0, 1), 2
    const float send = b16 ? v[0] : v[1];
    const float keep = b16 ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    v[1] = v[2] + __shfl_xor_sync(0xffffffffu, v[2], 16);
  }
  {                                       // 2 -> 1
    const float send = b8 ? v[0] : v[1];
    const float keep = b8 ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return b8 ? 2 : (b16 ? 1 : 0);
}

// The specular head and the rgb tail of the warp's rows from z8 (a, k_dim =
// o wide, rows of stride lda): spec = sigmoid(z8 @ wh + bh), each (row,
// output) summed as narrow_head sums it (lane l over k = l, l + 32, ... by
// fmaf in order, then the butterfly, frame_reduce3; the bias last, then the
// sigmoid), then rgb = spec tint + diffuse [-> sRGB] from the row's td.  Up
// to k_dim 256 a lane holds its weights in registers (8 k x 3).
__device__ __forceinline__ void dir_frame_tail(
    const bf16_t* a, int lda, int k_dim, const DirHeadW& W, const float* hb,
    const float* td, bool srgb, float* __restrict__ rgb, int64_t r0,
    int64_t n) {
  const int lane = threadIdx.x & 31;
  const bool writer = (lane & 7) == 0 && lane != 24;   // lanes 0, 8, 16
  auto emit = [&](int r, float (&v)[3]) {
    const int t = frame_reduce3(v);
    if (writer && r0 + r < n) {
      const float spec = sigmoidf(v[0] + hb[t]);
      const float c = spec * td[r * 6 + t] + td[r * 6 + 3 + t];
      rgb[(r0 + r) * 3 + t] = srgb ? srgbf(c) : c;
    }
  };
  if (k_dim <= 256) {
    float wv[8][3];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
#pragma unroll
      for (int t = 0; t < 3; ++t) wv[j][t] = k < k_dim ? W(k, t) : 0.f;
    }
    for (int r = 0; r < 16; ++r) {
      float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = lane + 32 * j;
        if (k < k_dim) {
          const float av = to_f(a[r * lda + k]);
#pragma unroll
          for (int t = 0; t < 3; ++t) v[t] = fmaf(av, wv[j][t], v[t]);
        }
      }
      emit(r, v);
    }
    return;
  }
  for (int r = 0; r < 16; ++r) {
    float v[3] = {0.f, 0.f, 0.f};
    for (int k = lane; k < k_dim; k += 32) {
      const float av = to_f(a[r * lda + k]);
#pragma unroll
      for (int t = 0; t < 3; ++t) v[t] = fmaf(av, W(k, t), v[t]);
    }
    emit(r, v);
  }
}

// The consumers' nt threads stage the constants (dir_frame_consts) at cb,
// then meet at named barrier 1 (the producer's warpgroup has left).
__device__ __forceinline__ void dir_frame_stage_consts(
    float* cb, const FrameConsts& C, const RefDirWeights<bf16_t>& p,
    const DirDims& d, const float* __restrict__ mat,
    const float* __restrict__ sigma, int nt) {
  const int tid = threadIdx.x;
  const float* bs[9] = {p.b0, p.b1, p.b2, p.b3, p.b4, p.b5, p.b6, p.b7,
                        p.bh};
  const int len[9] = {d.h, d.h, d.h, d.h, d.h, d.h, d.o, d.o, 3};
  for (int i = 0, at = 0; i < 9; at += len[i], ++i)
    for (int j = tid; j < len[i]; j += nt) cb[at + j] = bs[i][j];
  if (C.whead >= 0) {
    for (int j = tid; j < 3 * d.o; j += nt) cb[C.whead + j] = to_f(p.wh[j]);
    for (int j = tid; j < (d.l_max + 1) * d.n_ch; j += nt)
      cb[C.pe_w + j] = mat[j];
    for (int j = tid; j < d.n_ch; j += nt) cb[C.pe_b + j] = sigma[j];
  }
  bar_sync(1, nt);
}

// The frame (see the top of this file and of spa_frame.cuh).  s: the 8
// stored activations (FORM_DIR_RES), read where the launch put them (the
// layer loop indexes them, which would copy a plain parameter to local
// memory).
template <int FORM>
__global__ void __launch_bounds__(384, 1)
dir_frame_kernel(const float* __restrict__ heads,
                 const bf16_t* __restrict__ noise,
                 const float* __restrict__ dirs, int64_t per_ray,
                 const float* __restrict__ mat,
                 const float* __restrict__ sigma, RefDirWeights<bf16_t> p,
                 int64_t n, DirDims d, FrameLayout L,
                 const __grid_constant__ Acts<bf16_t> s,
                 float* __restrict__ rgb, float* __restrict__ normal,
                 float* __restrict__ density,
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
      frame_produce<FORM>(R, maps, maps, tiles, d.dd, d.h, d.o, d.nb);
    return;
  }
  setmaxnreg_inc<FREGS_CONSUMER>();
  const int wr = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's rows
  const int lda = L.lda, ldx = L.ldx;
  bf16_t* act = reinterpret_cast<bf16_t*>(base + L.act) + wr * lda;
  bf16_t* xs = reinterpret_cast<bf16_t*>(base + L.xs) + wr * ldx;
  float* td = reinterpret_cast<float*>(base + L.frows) + wr * 6;
  const FrameConsts& C = L.c;
  float* cb = reinterpret_cast<float*>(base + L.consts);
  dir_frame_stage_consts(cb, C, p, d, mat, sigma, 128 * cons);
  const bf16_t* none = nullptr;
  // each layer writes nxt and then reads it as cur: the same rows in one
  // buffer, or the other buffer where a width exceeds FCOLS
  const int flip = L.two ? TM * lda : 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM + wr;
    dir_frame_input(heads, noise, dirs, per_ray,
                    C.pe_w >= 0 ? cb + C.pe_w : mat,
                    C.pe_b >= 0 ? cb + C.pe_b : sigma, d, r0, n, xs, ldx, td,
                    normal, density);
    if (tile + gridDim.x < tiles)
      dir_frame_prefetch(heads, noise, d, r0 + (int64_t)gridDim.x * TM, n);
    bf16_t* cur = act + flip;
    bf16_t* nxt = act;
    // h1 .. h4, z5 (the skip: x @ w4a + h4 @ w4b), z6 (H wide), z7, z8 (O)
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const bool in = i == 0 || i == 4;
      const int n_out = i < 6 ? d.h : d.o;
      R = spa_frame_layer<FWG_EVAL>(
          R, in ? xs : cur, in ? ldx : lda, in ? d.dd : i == 7 ? d.o : d.h,
          i == 4 ? cur : none, lda, i == 4 ? d.h : 0,
          cb + (i < 7 ? i * d.h : 6 * d.h + d.o), n_out, nxt, lda, nullptr);
      if constexpr (FORM == FORM_DIR_RES)
        frame_store(nxt, lda, s.a[i], n_out, r0, n);
      bf16_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    dir_frame_tail(cur, lda, d.o, DirHeadW{cb, C.whead, p.wh},
                   cb + C.heads_b, td, d.srgb, rgb, r0, n);
    __syncwarp();
  }
}

// The body that a bf16 directional forward of these dims runs on the
// current device: the frame's layout (frame_search; *smem its bytes, *sms
// the device's SMs), or *smem 0 where no layout fits and the 64-row tile of
// ref_dir_fwd.cuh runs instead, chosen by shape before any launch.  Returns
// 0 or a CUDA error code.
inline int dir_frame_body(const DirDims& d, bool store, FrameLayout* L,
                          size_t* smem, int* sms) {
  return frame_search(L, smem, sms, store ? FORM_DIR_RES : FORM_DIR, d.dd,
                      d.h, d.o, d.nb, d.l_max, d.n_ch);
}

// Launches the bf16 directional forward on ``stream`` (launch_dir's
// arguments at DIR_FULL): the frame where it fits (dir_frame_body; the maps
// of dir_maps, one block an SM, min(tiles, SMs) blocks), else the 64-row
// tile.  *body: the body launched, the frame's consumer warpgroups (1 or 2)
// or 0 for the 64-row tile.  Returns 0 or a CUDA error code.
template <bool STORE>
int launch_dir_frame(const void* heads, const void* noise, const void* dirs,
                     int64_t per_ray, const void* mat, const void* sigma,
                     const uint64_t* ptrs, int64_t n, const int* dims,
                     float* rgb, float* normal, float* density,
                     const uint64_t* acts, int* body, cudaStream_t stream) {
  constexpr int FORM = STORE ? FORM_DIR_RES : FORM_DIR;
  const DirDims d = dir_dims(dims);
  if (!tile_widths_ok<bf16_t>({d.h, d.o})) return (int)cudaErrorInvalidValue;
  FrameLayout L;
  size_t smem = 0;
  int sms = 0;
  int err = dir_frame_body(d, STORE, &L, &smem, &sms);
  if (err != 0) return err;
  *body = smem == 0 ? 0 : L.cons;
  if (smem == 0)
    return launch_dir<STORE, DIR_FULL, bf16_t>(
        heads, noise, dirs, per_ray, nullptr, mat, sigma, ptrs, n, dims, rgb,
        normal, density, acts, stream);
  const RefDirWeights<bf16_t> p = dir_weights<bf16_t>(ptrs);
  TileMaps maps;
  err = dir_maps<bf16_t>(&maps, p, d);
  if (err != 0) return err;
  Acts<bf16_t> s = {};
  if (STORE) s = acts_of<bf16_t>(acts);
  const int64_t tiles = (n + 64 * L.cons - 1) / (64 * L.cons);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  const auto kernel = dir_frame_kernel<FORM>;
  err = set_smem(kernel, smem, FRAME_NAMES[FORM], 1, 128 * (L.cons + 1));
  if (err != 0 || n == 0) return err;
  kernel<<<grid, 128 * (L.cons + 1), smem, stream>>>(
      (const float*)heads, (const bf16_t*)noise, (const float*)dirs, per_ray,
      (const float*)mat, (const float*)sigma, p, n, d, L, s, rgb, normal,
      density, maps);
  return (int)cudaGetLastError();
}

}  // namespace
