// Tile building blocks shared by the fused MLP kernels (every csrc/*.cu).
//
// One block of THREADS threads owns a tile of TM points.  Activations of the
// tile live in shared memory as (TM, width) row-major arrays in the compute
// dtype T (float or __nv_bfloat16).  Products accumulate in f32.  The hidden
// layers (dense_tile) and the transposed products of the backwards'
// trunks (delta_tile) multiply bf16 operands on the tensor cores with
// Hopper's wgmma (m64n32k16, the weights in a swizzled ring in shared
// memory), the backwards' narrow heads with mma.sync m16n8k16; f32
// operands on the CUDA cores in full f32.  The other
// products (the narrow heads) and the f32 bodies run on the CUDA cores: each
// thread holds an RPT x CPT register tile (its warp's RPT rows, CPT columns
// strided by 32), and a layer wider than CHUNK columns is done in passes of
// CHUNK.  Kernels that hold dense_tile's ring align their dynamic shared
// memory to 1024 bytes (the ring's swizzle).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cuda.h>

#include <initializer_list>
#include <mutex>
#include <stdio.h>
#include <type_traits>

#include "mma_sm90.cuh"

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

// The transposed product of the backward in f32 (bf16: mma_pass_t), delta
// @ W^T: acc[i][j] += sum_k a[row_i][k] * w[col_j][k], with w the layer's
// (n_out, k_dim) = (in, out) forward matrix.  Read directly, neighbouring
// lanes would read neighbouring rows of w; instead the block stages KC rows
// of W^T at a time in shared memory (``stage``, KC x stage_ld<T>()
// elements), loading each row segment of w with consecutive lanes, and the
// row stride is padded to an odd number of 4-byte words so the transposing
// stores do not collide.
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

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// dst[(row0 + r) * ld + col0 + o] = act(a[r] @ w[:, o] + bias[o]) for the
// tile's rows r with row0 + r < n and o < n_out, with a (TM, k_dim) in
// shared memory and w (k_dim, n_out): one warp per (r, o), lanes stride over
// k and reduce with shuffles.  For the narrow heads.
template <typename T>
__device__ void narrow_head(const T* a, int k_dim, const T* __restrict__ w,
                            const float* __restrict__ bias, int n_out,
                            bool sigmoid, float* dst, int64_t ld, int col0,
                            int64_t row0, int64_t n) {
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
      if (sigmoid) v = sigmoidf(v);
      dst[(row0 + r) * ld + col0 + o] = v;
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[RPT][CPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
}

// Words of a ReLU bit mask row: bit c % 32 of word c / 32 is (act[c] > 0).
__host__ __device__ constexpr int mask_words(int width) {
  return (width + 31) >> 5;
}

// The bf16 layer tile's weight ring: STAGES slots, each one k-step of W
// (DK rows) by DCOLS output columns, filled by TMA in the 128-byte swizzle
// that wgmma's MN-major B descriptor reads: a slot is DCOLS / DATOM atoms
// of DATOM columns, each DK rows of 128 bytes, the 16-byte piece u of row r
// of an atom at piece u ^ (r % 8) of the row.  A slot is 8 KB and starts on
// a 1024-byte boundary (the swizzle's period); the ring starts at the first
// boundary at least RING_BARS bytes into the stage, and those bytes below
// it hold the ring's mbarriers and its loader's state.  So the stage's
// bytes depend on where it lies in the block's shared memory (``at``, from
// its 1024-byte-aligned base).  DSTAGES slots keep every forward at two
// blocks an SM; the rebuilds of the Ref-NeRF recompute backwards, whose
// other buffers leave less room, take RSTAGES.  The backwards share the
// stage with the delta pass's ring (TSTAGES slots of the same size, placed
// the same way), which never runs at the same time (stage_bytes).
constexpr int DK = 16;                    // a slot is one k-step
constexpr int DSTAGES = 3;
constexpr int RSTAGES = 2;
constexpr int DCOLS = 256;                // output columns a pass
constexpr int NCOLS = 128;                // ... in the narrow tile
constexpr int DATOM = 64;                 // columns of a swizzle atom
constexpr int DSLOT = DK * DCOLS;         // elements of a slot
constexpr int RING_ALIGN = 1024;
constexpr int RING_BARS = 128;            // bytes kept below the ring
constexpr int DPASS = 256;                // output columns a delta pass

__host__ __device__ constexpr size_t ring_at(size_t at) {
  return (at + RING_BARS + RING_ALIGN - 1) & ~(size_t)(RING_ALIGN - 1);
}

// Shared-memory bytes of dense_tile's stage at byte ``at`` of the block's
// dynamic shared memory: the ring and the bytes below it in bf16, none in
// f32.
template <typename T, int STAGES = DSTAGES>
__host__ __device__ constexpr size_t dense_stage_bytes(size_t at) {
  return sizeof(T) == 2
      ? ring_at(at) - at + (size_t)STAGES * DSLOT * sizeof(T) : 0;
}

// The bf16 delta pass's weight stage (delta_tile, enc_pull): a ring of
// TSTAGES slots, each up to DPASS rows of W (one output column each) by TK
// columns (one k-step), 32 bytes a row.  W (n_out, k_dim) is row-major, so
// k is contiguous for each output column: wgmma's K-major B operand (the
// transpose bit 0), and the B operand's "col" layout for the heads'
// ldmatrix without .trans.  Rows 32 bytes apart would put the 8 rows that
// one 16-byte read of each row reaches on 4 bank quads, a 2-way conflict;
// the two 16-byte halves of rows 4-7 of every 8 swap places, which spreads
// them over all 8 quads without padding: the 32-byte swizzle, in which TMA
// writes a trunk pass's slots and wgmma reads them (wgmma_desc_sw32), and
// which the heads' cp.async copies lay out by hand (tslot_off).  A box of
// one k-step fills the swizzle's 32 bytes; a slot of W's 16 k by 256 rows is
// 8 KB, the layer tile's slot size.  (The layer tile's map, 64 columns by
// 16 rows in the 128-byte swizzle, is a K-major atom of this operand too,
// but its slot would hold 64 k by 256 rows, 32 KB a slot, which the
// backwards' stage cannot hold beside their other buffers.)  The ring
// holds TSTAGES slots in every kernel: the stage that the Ref-NeRF
// recompute backwards share with their rebuild's RSTAGES slots holds no
// more.
constexpr int TK = 16;                    // a slot is one k-step
constexpr int TSTAGES = 2;
constexpr int TSLOT = DPASS * TK;         // elements of a slot

__device__ __forceinline__ int tslot_off(int rr, int half) {
  return rr * TK + ((half ^ (rr >> 2)) & 1) * 8;
}

// Shared-memory bytes of the delta pass's stage at byte ``at`` of the
// block's 1024-byte-aligned dynamic shared memory: in bf16 the ring and the
// bytes below it, as dense_stage_bytes places them (the heads' cp.async
// ring takes the stage's first 16 KB); accumulate_t's KC rows of W^T in
// f32.
template <typename T>
__host__ __device__ constexpr size_t delta_stage_bytes(size_t at) {
  return sizeof(T) == 2
      ? ring_at(at) - at + (size_t)TSTAGES * TSLOT * sizeof(T)
      : (size_t)KC * stage_ld<T>() * sizeof(T);
}

// Shared-memory bytes of a stage ``st`` at byte ``at`` that the delta pass
// and dense_tile take in turn (the rebuilding backwards, the density
// gradient).
template <typename T, int STAGES = DSTAGES>
__host__ __device__ constexpr size_t stage_bytes(size_t at) {
  return delta_stage_bytes<T>(at) > dense_stage_bytes<T, STAGES>(at)
      ? delta_stage_bytes<T>(at) : dense_stage_bytes<T, STAGES>(at);
}

// Whether every width that a bf16 dense_tile writes is a multiple of 8 (the
// n-tiles of the mma and the 16-byte rows of the weight stage); the f32 tile
// takes any width.  Launchers return cudaErrorInvalidValue otherwise.
template <typename T>
inline bool tile_widths_ok(std::initializer_list<int> widths) {
  if (sizeof(T) != 2) return true;
  for (int w : widths)
    if (w % 8 != 0) return false;
  return true;
}

// The f32 body of dense_tile, on the CUDA cores (see dense_tile).
template <bool STORE, typename T, bool MASK>
__device__ void dense_tile_fma(const T* a0, int k0, const T* __restrict__ w0,
                               const T* a1, int k1, const T* __restrict__ w1,
                               const float* __restrict__ bias, int n_out,
                               bool relu, T* out, T* __restrict__ gout,
                               int64_t row0, int64_t n, uint32_t* mbits) {
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
    if (MASK) {
      // each lane reads back the values it wrote itself: no barrier needed
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int cw = c0 + 32 * j;   // the warp's first column, uniform
        if (cw >= n_out) break;
        const int c = cw + lane;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const bool on = c < n_out && to_f(out[(r0 + i) * n_out + c]) > 0.f;
          const uint32_t bits = __ballot_sync(0xffffffffu, on);
          if (lane == 0) mbits[(r0 + i) * mask_words(n_out) + (cw >> 5)] = bits;
        }
      }
    }
  }
}

typedef __nv_bfloat16 bf16_t;

// The ring in a stage: its first 1024-byte boundary at least RING_BARS
// bytes in (dense_stage_bytes).
__device__ __forceinline__ bf16_t* ring_of(bf16_t* stage) {
  const uint32_t at = smem_addr(stage);
  return stage + (ring_at(at) - at) / sizeof(bf16_t);
}

// The TMA tensor maps of the bf16 weights that a kernel's tiles read, in the
// order of its map list (prop_maps, vanilla_maps, spa_maps, dir_maps, the
// tile's own pair): one kernel parameter (__grid_constant__).  A call site
// passes its layer's entry, &maps.map[i], and a layer of two products has
// w1's map in the entry after w0's.
constexpr int MAX_MAPS = 12;

struct TileMaps {
  CUtensorMap map[MAX_MAPS];
};

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (the libraries link no libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a (k_dim, n_out) row-major bf16 weight for the ring:
// boxes of DK rows by DATOM columns in the 128-byte swizzle, rows and
// columns past the matrix read as zeros.  Encoded on the host at every
// launch (the wrappers hand the kernels fresh bf16 copies of the weights,
// so a pointer says nothing of a matrix's contents from one step to the
// next; what an encoding costs: ops.dense.map_encode_us).  Returns 0 or a
// CUDA error code.
inline int weight_map(CUtensorMap* out, const void* w, int k_dim, int n_out) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n_out, (cuuint64_t)k_dim};
  const cuuint64_t strides[1] = {(cuuint64_t)n_out * sizeof(bf16_t)};
  const cuuint32_t box[2] = {DATOM, DK};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
      ? 0 : (int)cudaErrorInvalidValue;
}

// Rows of W in a box of the delta pass's map for passes of ``pass``
// columns: a pass's columns, or n_out rounded up to the 32 columns of a
// wgmma n-block, so that every row that a pass's products read arrives (as
// zeros past n_out).
__host__ __device__ constexpr int tbox_rows(int n_out, int pass) {
  return n_out >= pass ? pass : (n_out + 31) & ~31;
}

// Whether a delta pass of w (n_out, k_dim) can run on the ring
// (ring_pass_t): TMA reads rows whose stride is a multiple of 16 bytes from
// a 16-byte aligned matrix.  Every trunk pass of the fused kernels is one
// (tile_maps refuses a trunk weight that is not); the narrow heads (k_dim
// 0, 2, 3 and 9), which are bound by bytes, keep mma_pass_t, one
// zero-padded k-step staged by cp.async.
__host__ __device__ inline bool ring_ok(const void* w, int k_dim) {
  return k_dim > 0 && k_dim % 8 == 0 && (uintptr_t)w % 16 == 0;
}

// The tensor map of the delta pass's ring over w, the layer's (n_out,
// k_dim) row-major bf16 forward matrix, for passes of ``pass`` columns:
// boxes of TK columns (one k-step) by tbox_rows(n_out, pass) rows in the
// 32-byte swizzle, rows and columns past the matrix read as zeros.
// Encoded at every launch, as weight_map.  Returns 0 or a CUDA error code.
inline int delta_map(CUtensorMap* out, const void* w, int k_dim, int n_out,
                     int pass) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k_dim, (cuuint64_t)n_out};
  const cuuint64_t strides[1] = {(cuuint64_t)k_dim * sizeof(bf16_t)};
  const cuuint32_t box[2] = {TK, (cuuint32_t)tbox_rows(n_out, pass)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
      ? 0 : (int)cudaErrorInvalidValue;
}

// A weight that a kernel's tiles read: its pointer and (k_dim, n_out), the
// product's own (for the delta pass: the layer's output and input widths).
struct WeightShape {
  const void* w;
  int k_dim, n_out;
};

// The maps of ``weights`` for a bf16 kernel, map i of the i-th (a null
// pointer leaves its entry unset): the layer tile's (weight_map), or with
// ``delta`` the delta pass's for passes of ``pass`` columns (delta_map; a
// weight that is no ring_ok is refused); an f32 kernel reads none and gets
// an unset set.  Returns 0 or a CUDA error code.
template <typename T>
int tile_maps(TileMaps* maps, std::initializer_list<WeightShape> weights,
              bool delta = false, int pass = DPASS) {
  if (sizeof(T) != 2) return 0;
  if (weights.size() > MAX_MAPS) return (int)cudaErrorInvalidValue;
  int i = 0;
  for (const WeightShape& ws : weights) {
    if (delta && ws.w != nullptr && !ring_ok(ws.w, ws.k_dim))
      return (int)cudaErrorInvalidValue;
    if (ws.w != nullptr) {
      const int err = delta
          ? delta_map(&maps->map[i], ws.w, ws.k_dim, ws.n_out, pass)
          : weight_map(&maps->map[i], ws.w, ws.k_dim, ws.n_out);
      if (err != 0) return err;
    }
    ++i;
  }
  return 0;
}

__device__ __forceinline__ uint32_t pack_bf16(bf16_t lo, bf16_t hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
      | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The A fragment of rows m0 .. m0 + 15, columns kk .. kk + 15 of a (TM, k_dim)
// tile in shared memory: one ldmatrix where the rows are 16-byte aligned and
// the k-step lies inside k_dim, else element loads with columns past k_dim
// as zeros (the 63-, 27- and 167-wide trunk inputs, a ragged last k-step).
// At width 256 the 8 rows of an ldmatrix share their banks (512 bytes
// apart).  Padding the rows by 16 bytes ran the tile alone 5-12% faster on
// an H100 (tools/tile_variants, PERF.md); every reader of the activation
// tiles would change with it, which is left to a later redesign.
__device__ __forceinline__ void load_a(uint32_t (&af)[4], const bf16_t* a,
                                       int k_dim, int m0, int kk,
                                       bool aligned) {
  const int lane = threadIdx.x & 31;
  if (aligned && kk + 16 <= k_dim) {
    ldsm_x4(af[0], af[1], af[2], af[3],
            a + (m0 + (lane & 15)) * k_dim + kk + (lane >> 4) * 8);
    return;
  }
  // a0 a1: row g, columns 2 q, 2 q + 1; a2 a3: row g + 8; a4 .. a7: the same
  // eight columns on
  const int g = lane >> 2, c = kk + 2 * (lane & 3);
  const bf16_t* ra = a + (m0 + g) * k_dim;
  const bf16_t* rb = ra + 8 * k_dim;
  const bf16_t z = __float2bfloat16_rn(0.f);
  af[0] = pack_bf16(c < k_dim ? ra[c] : z, c + 1 < k_dim ? ra[c + 1] : z);
  af[1] = pack_bf16(c < k_dim ? rb[c] : z, c + 1 < k_dim ? rb[c + 1] : z);
  af[2] = pack_bf16(c + 8 < k_dim ? ra[c + 8] : z,
                    c + 9 < k_dim ? ra[c + 9] : z);
  af[3] = pack_bf16(c + 8 < k_dim ? rb[c + 8] : z,
                    c + 9 < k_dim ? rb[c + 9] : z);
}

// The columns of one pass of up to DP output columns (the delta pass's
// DPASS, or NCOLS where a kernel's other state leaves too few registers)
// that a warp of column half ``half`` owns: whole 32-column words of the
// pass, the first half's ceil(words / 2), the second's the rest.  (The
// delta pass's last n-tile may hang past n_out.)
struct PassCols {
  int np;          // columns in the pass
  int wb, we;      // the warp's words [wb, we) of the pass
  int col0;        // its first column, from the pass's first
  int nt_n;        // its n-tiles of 8 columns
};

template <int DP>
__device__ __forceinline__ PassCols pass_cols(int n_out, int c0, int half) {
  PassCols pc;
  pc.np = n_out - c0 < DP ? n_out - c0 : DP;
  const int words = (pc.np + 31) >> 5;
  const int wsplit = (words + 1) >> 1;
  pc.wb = half ? wsplit : 0;
  pc.we = half ? words : wsplit;
  pc.col0 = 32 * pc.wb;
  const int cend = 32 * pc.we < pc.np ? 32 * pc.we : pc.np;
  pc.nt_n = cend > pc.col0 ? (cend - pc.col0 + 7) >> 3 : 0;
  return pc;
}

// acc += one k-step's 16-term products, summed by the tensor cores from
// zero and added to acc in f32 (round to nearest): the delta pass's heads'
// products (mma.sync).  The tensor cores' accumulation truncates; chaining
// the k-steps through it set 1.6 times as many bf16 outputs off the
// correctly rounded pass as an f32 sum in order does, this 0.8 times (the
// delta phase's rounding gate, tools/tile_variants' dchain, PERF.md).
__device__ __forceinline__ void step_mma(float (&acc)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(part, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// The columns of one pass of up to PASS output columns that warpgroup
// ``half`` of the layer tile owns: whole 64-column atoms of the ring, the
// first warpgroup's ceil(atoms / 2), the second's the rest, so that each
// warpgroup's B operand starts on an atom.  (Which warpgroup computes a
// column changes none of its sums.)
template <int PASS>
__device__ __forceinline__ PassCols wg_cols(int n_out, int c0, int half) {
  PassCols pc;
  pc.np = n_out - c0 < PASS ? n_out - c0 : PASS;
  const int split = DATOM * ((pc.np + 2 * DATOM - 1) / (2 * DATOM));
  const int cb = half ? split : 0;
  const int ce = half ? pc.np : (pc.np < split ? pc.np : split);
  pc.col0 = cb;
  pc.nt_n = ce > cb ? (ce - cb) >> 3 : 0;
  pc.wb = cb >> 5;
  pc.we = ce > cb ? (ce + 31) >> 5 : pc.wb;
  return pc;
}

// The weight ring of one dense_tile (or wide head) call, passes of PASS
// columns, as every thread holds it: the shared-memory address of its
// slots, and the k-steps of w0 (s0) and of a pass (per).  The k-steps of
// all the call's passes form one stream: k-step g is k-step g % per of pass
// g / per, lies in slot g % STAGES, and is the (g / STAGES)-th use of that
// slot's barriers.  Slot j completes on full[j] (the TMA copies' bytes) and
// is released on empty[j] = full[STAGES + j] by one arrival of each warp
// once its products are done, so no block-wide barrier runs a k-step, and
// the next pass's first k-steps load while this one's finish.  The
// barriers live just below the ring, and below them what only thread 0,
// which loads the ring, reads (RingLoader), so that the other threads keep
// no register for it.  Both serve one call: ring_open sets them up,
// ring_close invalidates the barriers (the backwards' delta pass writes
// that memory).
template <int STAGES, int PASS>
struct WRing {
  uint32_t ring;                            // shared-memory address
  int s0, per;
  static constexpr int SLOT = DK * PASS;    // elements of a slot

  __device__ uint32_t slot(int g) const {
    return ring + (g % STAGES) * SLOT * (uint32_t)sizeof(bf16_t);
  }
  __device__ uint32_t full_bar(int g) const {
    return ring - 2 * STAGES * 8 + (g % STAGES) * 8;
  }
  __device__ uint32_t empty_bar(int g) const {
    return ring - STAGES * 8 + (g % STAGES) * 8;
  }
};

// The loader's part of a ring, at the foot of its RING_BARS bytes: w0's
// map (w1's the next), the call's k-steps and its output width.
struct RingLoader {
  const CUtensorMap* map;
  int total, n_out;
};

template <int STAGES, int PASS>
__device__ __forceinline__ RingLoader* loader_of(const WRing<STAGES, PASS>& R) {
  static_assert(sizeof(RingLoader) + 2 * STAGES * 8 <= RING_BARS,
                "the ring's barriers and loader do not fit below it");
  return reinterpret_cast<RingLoader*>(
      __cvta_shared_to_generic(R.ring - RING_BARS));
}

// Thread 0: k-step g's boxes (one a 64-column atom of its pass) into its
// slot, W's rows past k_dim and columns past n_out as zeros.
template <int STAGES, int PASS>
__device__ __forceinline__ void ring_load(const WRing<STAGES, PASS>& R,
                                          const RingLoader& L, int g) {
  const int pass = g / R.per, j = g - pass * R.per;
  const int c0 = pass * PASS;
  const int np = L.n_out - c0 < PASS ? L.n_out - c0 : PASS;
  const int boxes = (np + DATOM - 1) / DATOM;
  const bool second = j >= R.s0;
  const CUtensorMap* map = second ? L.map + 1 : L.map;
  mbar_expect_tx(R.full_bar(g), boxes * DK * DATOM * sizeof(bf16_t));
  for (int b = 0; b < boxes; ++b)
    tma_load_2d(R.slot(g) + b * DK * DATOM * sizeof(bf16_t), map,
                R.full_bar(g), c0 + b * DATOM, (second ? j - R.s0 : j) * DK);
}

// Thread 0: k-step g of the delta pass's ring (KMAJOR, ring_pass_t) into
// its slot: one box of TK columns of W's rows from pass g / per's first
// (delta_map), columns past k_dim and rows past n_out as zeros.
template <int STAGES, int PASS>
__device__ __forceinline__ void tring_load(const WRing<STAGES, PASS>& R,
                                           const RingLoader& L, int g) {
  const int pass = g / R.per, j = g - pass * R.per;
  mbar_expect_tx(R.full_bar(g),
                 TK * tbox_rows(L.n_out, PASS) * sizeof(bf16_t));
  tma_load_2d(R.slot(g), L.map, R.full_bar(g), j * TK, pass * PASS);
}

// Every thread: the ring of ``stage`` for w0 (k0, n_out) [and w1 (k1,
// n_out); k1 = 0 for none], their maps from ``wmap`` on, its barriers set
// up and its first STAGES k-steps loading: the layer tile's, or with
// KMAJOR the delta pass's (w0 the layer's (n_out, k0) forward matrix, no
// w1).  The ring must be free.
template <int STAGES, int PASS, bool KMAJOR = false>
__device__ __forceinline__ WRing<STAGES, PASS> ring_open(
    bf16_t* stage, const CUtensorMap* wmap, int k0, int k1, int n_out) {
  static_assert(PASS <= DCOLS, "a slot holds at most DCOLS columns");
  WRing<STAGES, PASS> R;
  R.ring = smem_addr(ring_of(stage));
  R.s0 = (k0 + DK - 1) / DK;
  R.per = R.s0 + (k1 + DK - 1) / DK;
  fence_proxy_async();                      // earlier writes to the stage
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(R.full_bar(i), 1);
      mbar_init(R.empty_bar(i), WARPS);
    }
    fence_mbar_init();
    RingLoader& L = *loader_of(R);
    L.map = wmap;
    L.total = R.per * ((n_out + PASS - 1) / PASS);
    L.n_out = n_out;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const RingLoader L = *loader_of(R);
    for (int g = 0; g < STAGES && g < L.total; ++g) {
      if constexpr (KMAJOR)
        tring_load(R, L, g);
      else
        ring_load(R, L, g);
    }
  }
  return R;
}

// Every thread, once every k-step is consumed: the barriers invalidated.
template <int STAGES, int PASS>
__device__ __forceinline__ void ring_close(const WRing<STAGES, PASS>& R) {
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) {
      mbar_inval(R.full_bar(i));
      mbar_inval(R.empty_bar(i));
    }
}

// The products of pass ``pass`` on the tensor cores: acc[t] = the 16 x 8
// block of n-tile t of a0 @ w0 [+ a1 @ w1] at the warp's rows m0 .. m0 + 15
// and the columns of ``pc`` (wg_cols: at width 256, two atoms of 64 columns
// a warpgroup, 16 n-tiles, 64 f32 accumulators a thread).  The warpgroups'
// four warps are the tile's row groups of 16, and each warp's A fragment
// (load_a) is wgmma's register operand as it stands.
//
// The pass's k-steps, a0's then a1's, in order: for each half-atom of 32
// columns of the warpgroup in turn, a k-step's product is summed from zero
// by the tensor cores (wgmma m64n32k16 into ``part``, scale-d 0) and then
// added to acc in f32, so the f32 sum takes one rounding a k-step (the
// contract's G = 1; tools/tile_variants' g2 and g4 chain 2 and 4 k-steps
// in the tensor cores before each add).  Half-atoms keep the partial at 16
// registers beside acc's 64, which the 128 a thread of two blocks an SM
// leave room for.  Chaining every k-step through the tensor cores'
// truncating accumulator sets more outputs off the correctly rounded layer
// (the dense phase's rounding gate, tools/tile_variants' chain).  The order
// of the sums does not depend on the block, the caller or the pass's width,
// so a rebuild gives the forward's values bit for bit.  Once a warp has
// added k-step g it releases g's slot, and thread 0 loads k-step g - 1 +
// STAGES when every warp has released k-step g - 1.  Every thread of the
// block must call this.
template <int STAGES, int PASS>
__device__ __forceinline__ void mma_pass(float (&acc)[PASS / 16][4],
                                         const WRing<STAGES, PASS>& R,
                                         int pass,
                                         const bf16_t* a0, int k0,
                                         const bf16_t* a1, int k1,
                                         const PassCols& pc) {
  const int lane = threadIdx.x & 31;
  const int m0 = ((threadIdx.x >> 5) & 3) * 16;
  const bool al0 = (uintptr_t)a0 % 16 == 0 && k0 % 8 == 0;
  const bool al1 = (uintptr_t)a1 % 16 == 0 && k1 % 8 == 0;
  const int g0 = pass * R.per;              // the pass's first k-step
  const int nsub = (pc.nt_n + 3) >> 2;      // the warpgroup's half-atoms
  const uint32_t boff = (pc.col0 / DATOM) * DK * DATOM * sizeof(bf16_t);
  float part[4][4];
#pragma unroll
  for (int t = 0; t < PASS / 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = part[t & 3][e] = 0.f;
  for (int k = 0; k < R.per; ++k) {
    const int g = g0 + k;
    const bool on1 = k >= R.s0;
    uint32_t af[4];
    load_a(af, on1 ? a1 : a0, on1 ? k1 : k0, m0,
           (on1 ? k - R.s0 : k) * DK, on1 ? al1 : al0);
    mbar_wait(R.full_bar(g), (g / STAGES) & 1);
#pragma unroll
    for (int sub = 0; sub < PASS / 64; ++sub) {
      if (sub < nsub) {
        wgmma_fence();
        wgmma_m64n32k16(part, af,
                        wgmma_desc_sw128(R.slot(g) + boff
                                         + (sub >> 1) * DK * DATOM * 2
                                         + (sub & 1) * DATOM,
                                         DK * DATOM * 2, 8 * DATOM * 2),
                        0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
        wgmma_hold(af);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * sub + t][e] += part[t][e];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty_bar(g));
    if (threadIdx.x == 0 && g >= 1) {
      const RingLoader L = *loader_of(R);
      if (g - 1 + STAGES < L.total) {
        mbar_wait(R.empty_bar(g - 1), ((g - 1) / STAGES) & 1);
        ring_load(R, L, g - 1 + STAGES);
      }
    }
  }
}

// The bf16 body of dense_tile (see there), on the tensor cores (mma_pass),
// in passes of PASS columns over one weight ring.  The epilogue adds the
// bias in f32, applies the ReLU and rounds to bf16 into ``out``; then the
// warp's own rows and columns go on to gout (STORE) and its own 32-column
// words to the mask (MASK), after a __syncwarp.
template <bool STORE, bool MASK, int STAGES, int PASS>
__device__ void dense_tile_mma(const bf16_t* a0, int k0, const bf16_t* a1,
                               int k1, const float* __restrict__ bias,
                               int n_out, bool relu, bf16_t* out,
                               bf16_t* __restrict__ gout, int64_t row0,
                               int64_t n, bf16_t* stage,
                               const CUtensorMap* wmap, uint32_t* mbits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16;           // the warp's rows
  const int g = lane >> 2, q = lane & 3;
  const bool gvec = (uintptr_t)gout % 16 == 0;
  const WRing<STAGES, PASS> R = ring_open<STAGES, PASS>(
      stage, wmap, k0, a1 != nullptr ? k1 : 0, n_out);
  for (int c0 = 0, pass = 0; c0 < n_out; c0 += PASS, ++pass) {
    const PassCols pc = wg_cols<PASS>(n_out, c0, warp >> 2);
    float acc[PASS / 16][4];
    mma_pass(acc, R, pass, a0, k0, a1, k1, pc);
    // c0 c1 of an n-tile: row g, columns 2 q, 2 q + 1; c2 c3: row g + 8
#pragma unroll
    for (int t = 0; t < PASS / 16; ++t) {
      if (t >= pc.nt_n) break;
      const int c = c0 + pc.col0 + 8 * t + 2 * q;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[t][2 * h] + b0, v1 = acc[t][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (m0 + g + 8 * h) * n_out + c)
            = __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncwarp();                           // the warp's part of out is written
    if (STORE) {
      // the warp's 16 rows x 8 nt_n columns to gout, 16 bytes at a time
      for (int idx = lane; idx < 16 * pc.nt_n; idx += 32) {
        const int rr = idx / pc.nt_n;
        const int c = c0 + pc.col0 + 8 * (idx - rr * pc.nt_n);
        const int64_t row = row0 + m0 + rr;
        if (row >= n) continue;
        const bf16_t* src = out + (m0 + rr) * n_out + c;
        bf16_t* dst = gout + row * n_out + c;
        if (gvec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) dst[e] = src[e];
        }
      }
    }
    if (MASK) {
      // the warp owns whole words of its rows, so it reads back only values
      // its own lanes wrote
      for (int wd = pc.wb; wd < pc.we; ++wd) {
        const int c = c0 + 32 * wd + lane;
        for (int rr = 0; rr < 16; ++rr) {
          const int r = m0 + rr;
          const bool on = c < n_out && to_f(out[r * n_out + c]) > 0.f;
          const uint32_t bits = __ballot_sync(0xffffffffu, on);
          if (lane == 0) mbits[r * mask_words(n_out) + (c0 >> 5) + wd] = bits;
        }
      }
    }
  }
  ring_close(R);
}

// out = act(a0 @ w0 [+ a1 @ w1] + bias) for the whole tile, cast to T.
// a0, a1 and out are (TM, width) row-major in shared memory.  With STORE the
// tile's valid rows are also written to gout, an (n, n_out) array in device
// memory (rows row0 .. row0 + TM).  With MASK the ReLU mask (out > 0) of
// every row goes to mbits, (TM, mask_words(n_out)) words in shared memory.
// bf16 multiplies on the tensor cores (dense_tile_mma), W brought by TMA
// into a ring of STAGES slots in ``stage`` (dense_stage_bytes<T, STAGES>(at)
// bytes at byte ``at`` of the block's 1024-byte-aligned shared memory)
// through w0's tensor map ``wmap`` (and w1's, wmap[1]; TileMaps; n_out a
// multiple of 8), in passes of PASS columns (DCOLS, or NCOLS where a
// kernel's other state leaves too few registers: the accumulators are
// PASS / 4 a thread); f32 on the CUDA cores in full f32 (dense_tile_fma, no
// stage, no maps).  Every thread of the block must call this.
template <bool STORE, typename T, bool MASK = false, int STAGES = DSTAGES,
          int PASS = DCOLS>
__device__ void dense_tile(const T* a0, int k0, const T* __restrict__ w0,
                           const T* a1, int k1, const T* __restrict__ w1,
                           const float* __restrict__ bias, int n_out,
                           bool relu, T* out, T* __restrict__ gout,
                           int64_t row0, int64_t n, T* stage,
                           const CUtensorMap* wmap,
                           uint32_t* mbits = nullptr) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dense_tile_mma<STORE, MASK, STAGES, PASS>(a0, k0, a1, k1, bias, n_out,
                                              relu, out, gout, row0, n, stage,
                                              wmap, mbits);
  else
    dense_tile_fma<STORE, T, MASK>(a0, k0, w0, a1, k1, w1, bias, n_out, relu,
                                   out, gout, row0, n, mbits);
}

// The f32 body of delta_tile, on the CUDA cores (see delta_tile).
template <bool ADD, typename T, typename OutT, bool MBITS>
__device__ void delta_tile_fma(const T* a, int k_dim, const T* __restrict__ w,
                               int n_out, const T* __restrict__ act,
                               const T* gs, const T* __restrict__ wcol,
                               T* out, OutT* __restrict__ gout, int64_t row0,
                               int64_t n, T* stage, const uint32_t* mbits) {
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
        if (MBITS) {
          const uint32_t word = mbits[t * mask_words(n_out) + (c >> 5)];
          v = (row < n && ((word >> (c & 31)) & 1u)) ? v : 0.f;
        } else if (act != nullptr) {
          v = (row < n && to_f(act[row * n_out + c]) > 0.f) ? v : 0.f;
        }
        out[t * n_out + c] = from_f<T>(v);
        if (gout != nullptr && row < n) gout[row * n_out + c] = from_f<OutT>(v);
      }
    }
  }
}

// Columns [kb, kb + TK) of rows [c0, c0 + npad) of w (n_out, k_dim) into a
// slot of the delta ring: each row's two 16-byte halves by cp.async
// (element loads where w is not 16-byte aligned or k_dim is not a multiple
// of 8, zeros past k_dim), rows at or past n_out as zeros.  Neighbouring
// threads take the two halves of a row, so a warp reads 16 rows' 32-byte
// spans.
__device__ __forceinline__ void stage_wt(bf16_t* slot,
                                         const bf16_t* __restrict__ w,
                                         int k_dim, int kb, int n_out, int c0,
                                         int npad, bool vec) {
  for (int idx = threadIdx.x; idx < 2 * npad; idx += THREADS) {
    const int rr = idx >> 1, half = idx & 1;
    const int c = c0 + rr, k = kb + 8 * half;
    bf16_t* d = slot + tslot_off(rr, half);
    const bf16_t* src = w + (size_t)c * k_dim + k;
    if (c >= n_out || k >= k_dim) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(d, src);
    } else {
      const bf16_t z = __float2bfloat16_rn(0.f);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = k + e < k_dim ? src[e] : z;
    }
  }
}

// One k-step's products of the delta pass into the warp's first nt_n
// n-tiles: the A fragment af and the B fragments of the slot's rows from pb
// on (16 rows of the slot, a non-transposing ldmatrix, per pair of n-tiles).
template <int DP>
__device__ __forceinline__ void kstep_mma_t(float (&acc)[DP / 16][4],
                                            const uint32_t (&af)[4],
                                            const bf16_t* pb, int nt_n) {
#pragma unroll
  for (int p = 0; p < DP / 32; ++p) {
    if (p * 2 >= nt_n) break;
    uint32_t b[2][2];
    ldsm_x4(b[0][0], b[0][1], b[1][0], b[1][1], pb + p * 16 * TK);
    step_mma(acc[2 * p], af, b[0]);
    if (p * 2 + 1 < nt_n) step_mma(acc[2 * p + 1], af, b[1]);
  }
}

// The transposed products of one pass on mma.sync, for the narrow heads
// (and delta_layer's passes that are no ring_ok): acc[t] = the 16 x 8
// block of n-tile t of a @ W^T at the warp's rows m0 .. m0 + 15 and the
// columns of ``pc``, from column c0 of the pass on; a (TM, k_dim) in shared
// memory, w the layer's (n_out, k_dim) forward matrix.  The warps split the tile as ring_pass_t
// does, each k-step's product is added to acc in f32 (step_mma) in the
// order of k, and W's rows are staged by cp.async into the stage's first
// two slots, one slot ahead.  k_dim may be anything: A and B past k_dim are
// zeros (load_a, stage_wt), so a head of 2, 3 or 9 is one zero-padded
// k-step, and k_dim = 0 multiplies nothing.  Opens with a barrier, so the
// stage is free whatever ran before; every thread of the block must call
// this.
template <int DP>
__device__ __forceinline__ void mma_pass_t(float (&acc)[DP / 16][4],
                                           const bf16_t* a, int k_dim,
                                           const bf16_t* __restrict__ w,
                                           int n_out, int c0,
                                           const PassCols& pc,
                                           bf16_t* stage) {
  const int lane = threadIdx.x & 31;
  const int m0 = ((threadIdx.x >> 5) & 3) * 16;
  const bool al = (uintptr_t)a % 16 == 0 && k_dim % 8 == 0;
  const bool vec = (uintptr_t)w % 16 == 0 && k_dim % 8 == 0;
  const int npad = (pc.np + 7) & ~7;
  const int slots = (k_dim + TK - 1) / TK;
#pragma unroll
  for (int t = 0; t < DP / 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  if (slots == 0) return;
  __syncthreads();                          // the ring's last reader is done
#pragma unroll
  for (int j = 0; j < TSTAGES - 1; ++j) {
    if (j < slots)
      stage_wt(stage + j * TSLOT, w, k_dim, j * TK, n_out, c0, npad, vec);
    cp_async_commit();
  }
  // lane l reads row (l & 7) + 8 (l >> 4) of a pair, half (l >> 3) & 1:
  // the B fragments b0 b1 of n-tiles 2 p and 2 p + 1
  const int boff =
      tslot_off(pc.col0 + (lane & 7) + (lane >> 4) * 8, (lane >> 3) & 1);
  for (int s = 0; s < slots; ++s) {
    cp_async_wait<TSTAGES - 2>();           // this thread's copies of slot s
    __syncthreads();                        // everyone's; slot s - 1 is done
    const int next = s + TSTAGES - 1;
    if (next < slots)
      stage_wt(stage + (next % TSTAGES) * TSLOT, w, k_dim, next * TK, n_out,
               c0, npad, vec);
    cp_async_commit();
    uint32_t af[4];
    load_a(af, a, k_dim, m0, s * TK, al);
    kstep_mma_t<DP>(acc, af, stage + (s % TSTAGES) * TSLOT + boff, pc.nt_n);
  }
}

// The transposed products of pass ``pass`` on wgmma: acc[t] = the 16 x 8
// block of n-tile t of a @ W^T at the warp's rows m0 .. m0 + 15 and the
// columns of ``pc`` (pass_cols), from the pass's first column on, with W's
// rows brought by TMA into the delta ring ``R`` (ring_open<..., true>:
// slot rows are the pass's output columns, k contiguous, the 32-byte
// swizzle).  The warpgroups' four warps are the tile's row groups of 16,
// each warp's A fragment (load_a) wgmma's register operand, and B is
// K-major (transpose bit 0), read straight from the slot (wgmma_desc_sw32,
// 8 rows of 32 bytes a group).  The pass's k-steps in order: for each
// 32-column block of the warpgroup in turn, a k-step's product is summed
// from zero by the tensor cores (wgmma m64n32k16 into ``part``, scale-d 0)
// and added to acc in f32, one rounding a k-step (the contract's G = 1, as
// mma_pass and mma_pass_t take it; tools/tile_variants' dchain chains the
// k-steps in the tensor cores instead, which the delta phase's rounding
// gate catches).  The order of the sums depends neither on the block nor
// on the caller.  Once a warp has added k-step g it releases g's slot, and
// thread 0, before its products of k-step g, loads k-step g - 1 + STAGES
// into g - 1's slot once every warp has released it: with the ring's two
// slots a load then has a whole k-step to land (refilled after the
// products, as mma_pass does, it had none).  No block-wide barrier runs
// inside a pass.  Every thread of the block must call this.
template <int STAGES, int DP>
__device__ __forceinline__ void ring_pass_t(float (&acc)[DP / 16][4],
                                            const WRing<STAGES, DP>& R,
                                            int pass, const bf16_t* a,
                                            int k_dim, const PassCols& pc) {
  const int lane = threadIdx.x & 31;
  const int m0 = ((threadIdx.x >> 5) & 3) * 16;
  const bool al = (uintptr_t)a % 16 == 0;   // k_dim % 8 == 0 (ring_ok)
  const int g0 = pass * R.per;              // the pass's first k-step
  const int nblk = (pc.nt_n + 3) >> 2;      // the warpgroup's 32-column blocks
  const uint32_t boff = pc.col0 * TK * sizeof(bf16_t);
  float part[4][4];
#pragma unroll
  for (int t = 0; t < DP / 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = part[t & 3][e] = 0.f;
  for (int k = 0; k < R.per; ++k) {
    const int g = g0 + k;
    if (threadIdx.x == 0 && g >= 1) {
      const RingLoader L = *loader_of(R);
      if (g - 1 + STAGES < L.total) {
        mbar_wait(R.empty_bar(g - 1), ((g - 1) / STAGES) & 1);
        tring_load(R, L, g - 1 + STAGES);
      }
    }
    uint32_t af[4];
    load_a(af, a, k_dim, m0, k * TK, al);
    mbar_wait(R.full_bar(g), (g / STAGES) & 1);
#pragma unroll
    for (int blk = 0; blk < DP / 64; ++blk) {
      if (blk < nblk) {
        wgmma_fence();
        wgmma_m64n32k16<0>(part, af,
                           wgmma_desc_sw32(R.slot(g) + boff
                                           + blk * 32 * TK * 2,
                                           8 * TK * 2),
                           0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
        wgmma_hold(af);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * blk + t][e] += part[t][e];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty_bar(g));
  }
}

// The bf16 body of delta_tile (see there), on the tensor cores: through the
// TMA-fed ring on wgmma (ring_pass_t) where ``tmap`` is given, else on
// mma.sync (mma_pass_t).  A call site passes its layer's map or a literal
// null, so each inlined call holds one of the two bodies.  The ring serves
// all of the call's passes and is closed at its end.
// The epilogue works in the mma's fragment layout: a thread holds columns
// 2 q, 2 q + 1 of rows g and g + 8 of each n-tile, taken as a pair where
// n_out is even (4-byte loads and stores) and one by one where it is odd
// (167, 63: a pair would straddle two rows).  T rows then go on to gout from
// shared memory after a __syncwarp, 16 bytes at a time where the width
// allows; f32 rows go straight from the registers, unrounded.
template <bool ADD, int DP, typename OutT, bool MBITS>
__device__ __forceinline__ void delta_tile_mma(
    const bf16_t* a, int k_dim, const bf16_t* __restrict__ w, int n_out,
    const bf16_t* __restrict__ act, const bf16_t* gs,
    const bf16_t* __restrict__ wcol, bf16_t* out, OutT* __restrict__ gout,
    int64_t row0, int64_t n, bf16_t* stage, const CUtensorMap* tmap,
    const uint32_t* mbits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16;           // the warp's rows
  const int g = lane >> 2, q = lane & 3;
  const int mw = mask_words(n_out);
  const bool ring = tmap != nullptr;
  WRing<TSTAGES, DP> R{};
  if (ring) R = ring_open<TSTAGES, DP, true>(stage, tmap, k_dim, 0, n_out);
  const bool even = n_out % 2 == 0;
  const bool opair = even && (uintptr_t)out % 4 == 0;
  const bool apair = even && (uintptr_t)act % 4 == 0;
  const bool gpair = even && (uintptr_t)gout % 8 == 0;
  const bool gvec = n_out % 8 == 0 && (uintptr_t)gout % 16 == 0
      && (uintptr_t)out % 16 == 0;
  for (int c0 = 0, pass = 0; c0 < n_out; c0 += DP, ++pass) {
    const PassCols pc = pass_cols<DP>(n_out, c0, warp >> 2);
    float acc[DP / 16][4];
    if (ring)
      ring_pass_t(acc, R, pass, a, k_dim, pc);
    else
      mma_pass_t<DP>(acc, a, k_dim, w, n_out, c0, pc, stage);
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      if (t >= pc.nt_n) break;
      const int c = c0 + pc.col0 + 8 * t + 2 * q;
      if (c >= n_out) continue;
      const bool two = c + 1 < n_out;
      float wc0 = 0.f, wc1 = 0.f;
      if (wcol != nullptr) {
        wc0 = to_f(wcol[c]);
        if (two) wc1 = to_f(wcol[c + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        const int64_t row = row0 + r;
        bf16_t* o = out + r * n_out + c;
        float v0 = acc[t][2 * h], v1 = acc[t][2 * h + 1];
        if (wcol != nullptr) {
          const float gv = to_f(gs[r]);
          v0 += gv * wc0;
          v1 += gv * wc1;
        }
        if (ADD) {
          float p0, p1 = 0.f;
          if (opair) {
            const __nv_bfloat162 pv =
                *reinterpret_cast<const __nv_bfloat162*>(o);
            p0 = __low2float(pv);
            p1 = __high2float(pv);
          } else {
            p0 = to_f(o[0]);
            if (two) p1 = to_f(o[1]);
          }
          v0 = to_f(from_f<bf16_t>(v0)) + p0;
          v1 = to_f(from_f<bf16_t>(v1)) + p1;
        }
        if (MBITS) {
          const uint32_t word = mbits[r * mw + (c >> 5)];
          if (row >= n || !((word >> (c & 31)) & 1u)) v0 = 0.f;
          if (row >= n || !((word >> ((c + 1) & 31)) & 1u)) v1 = 0.f;
        } else if (act != nullptr) {
          bool on0 = false, on1 = false;
          if (row < n) {
            const bf16_t* ar = act + row * n_out + c;
            if (apair) {
              const __nv_bfloat162 av =
                  *reinterpret_cast<const __nv_bfloat162*>(ar);
              on0 = __low2float(av) > 0.f;
              on1 = __high2float(av) > 0.f;
            } else {
              on0 = to_f(ar[0]) > 0.f;
              on1 = two && to_f(ar[1]) > 0.f;
            }
          }
          if (!on0) v0 = 0.f;
          if (!on1) v1 = 0.f;
        }
        if (opair) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = from_f<bf16_t>(v0);
          if (two) o[1] = from_f<bf16_t>(v1);
        }
        if constexpr (std::is_same<OutT, float>::value) {
          if (gout != nullptr && row < n) {
            float* gd = gout + row * n_out + c;
            if (gpair) {
              *reinterpret_cast<float2*>(gd) = make_float2(v0, v1);
            } else {
              gd[0] = v0;
              if (two) gd[1] = v1;
            }
          }
        }
      }
    }
    if constexpr (std::is_same<OutT, bf16_t>::value) {
      // the warp's 16 rows x its columns of the pass, which its own lanes
      // wrote, on to gout
      const int cb = c0 + pc.col0;
      const int ncol = min(8 * pc.nt_n, n_out - cb);
      if (gout != nullptr && ncol > 0) {
        __syncwarp();
        if (gvec) {
          for (int idx = lane; idx < 16 * pc.nt_n; idx += 32) {
            const int rr = idx / pc.nt_n;
            const int c = cb + 8 * (idx - rr * pc.nt_n);
            const int64_t row = row0 + m0 + rr;
            if (row < n)
              *reinterpret_cast<uint4*>(gout + row * n_out + c) =
                  *reinterpret_cast<const uint4*>(out + (m0 + rr) * n_out + c);
          }
        } else {
          for (int idx = lane; idx < 16 * ncol; idx += 32) {
            const int rr = idx / ncol;
            const int c = cb + idx - rr * ncol;
            const int64_t row = row0 + m0 + rr;
            if (row < n) gout[row * n_out + c] = out[(m0 + rr) * n_out + c];
          }
        }
      }
    }
  }
  if (ring) ring_close(R);
}

// delta = mask(act) (a @ W^T [+ gs[row] * wcol[c]]) for the whole tile, where
// W is the layer's (n_out, k_dim) = (in, out) forward matrix, a the next
// layer's (TM, k_dim) delta in shared memory, act the stored (n, n_out)
// activation in device memory (null: no ReLU), and gs/wcol an optional K = 1
// outer-product term added in f32 before the mask.  With MBITS the mask is
// read from the tile's bit mask mbits (dense_tile's MASK) instead of act.
// With ADD the product is first rounded to T and added to what ``out`` holds
// (a sum of T-valued pullbacks that rounds after each add).  The result goes
// to shared memory in T (the operand of the next product) and, when gout is
// not null, its valid rows to gout, in OutT (T, or f32).  bf16 multiplies on
// the tensor cores (delta_tile_mma) in ``stage`` (delta_stage_bytes<T>(at)
// bytes at byte ``at`` of the block's 1024-byte-aligned shared memory):
// a trunk pass on wgmma with W brought by TMA through its layer's delta map
// ``tmap`` (tile_maps with ``delta``, which refuses a weight that is no
// ring_ok; the call site passes its layer's entry), a narrow head (tmap
// null) on mma.sync; f32 on
// the CUDA cores in full f32 (delta_tile_fma, accumulate_t's stage; no
// map).  bf16 passes are DP columns wide (DPASS, or NCOLS where a kernel's
// other state leaves too few registers for DPASS / 4 f32 accumulators a
// thread; its delta maps are encoded for DP, tile_maps' ``pass``).  Opens
// with a barrier wherever it stages W (k_dim > 0); every thread of the
// block must call this.
template <bool ADD = false, int DP = DPASS, typename T, typename OutT,
          bool MBITS = false>
__device__ void delta_tile(const T* a, int k_dim, const T* __restrict__ w,
                           int n_out, const T* __restrict__ act,
                           const T* gs, const T* __restrict__ wcol, T* out,
                           OutT* __restrict__ gout, int64_t row0, int64_t n,
                           T* stage, const CUtensorMap* tmap,
                           const uint32_t* mbits = nullptr) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    delta_tile_mma<ADD, DP, OutT, MBITS>(a, k_dim, w, n_out, act, gs, wcol,
                                         out, gout, row0, n, stage, tmap,
                                         mbits);
  else
    delta_tile_fma<ADD, T, OutT, MBITS>(a, k_dim, w, n_out, act, gs, wcol,
                                        out, gout, row0, n, stage, mbits);
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

// Rows [row0, row0 + TM) of an (n, width) array into shared memory, rows
// past n as zeros, for the tiles' own entries (dense.cu, delta.cu).  The
// tile's rows are one span of memory: copied by 16-byte cp.async where it
// is 16-byte aligned (always, for an aligned array and an even width), so
// that the entry's own loads do not hide the tile's time.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int width, int64_t row0,
                          int64_t n, T* dst) {
  constexpr int PER = 16 / sizeof(T);
  const int64_t valid = n - row0 < TM ? n - row0 : TM;
  const T* base = src + row0 * width;
  const int count = (int)valid * width;
  int done = 0;
  if ((uintptr_t)base % 16 == 0) {
    for (int j = threadIdx.x; j < count / PER; j += THREADS)
      cp_async16(dst + j * PER, base + j * PER);
    cp_async_commit();
    done = count / PER * PER;
  }
  for (int idx = done + threadIdx.x; idx < TM * width; idx += THREADS)
    dst[idx] = idx < count ? base[idx] : from_f<T>(0.f);
  cp_async_wait<0>();
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

// The tensor maps of the proposal net's trunk (its dense_tile layers), in
// the order of the layers: map i is layer i's.
template <typename T>
int prop_maps(TileMaps* maps, const PropWeights<T>& p, int dx, int h) {
  return tile_maps<T>(maps, {{p.w0, dx, h}, {p.w1, h, h}, {p.w2, h, h},
                             {p.w3, h, h}});
}

// The tensor maps of the vanilla net's dense_tile layers: w0 .. w3 at 0 ..
// 3, the skip's w4a w4b at 4 5, w5 6, w6 7, wb 8, wr1a wr1b at 9 10.
template <typename T>
int vanilla_maps(TileMaps* maps, const VanillaWeights<T>& p, int dx, int dd,
                 int h, int bn, int r) {
  return tile_maps<T>(maps, {{p.w0, dx, h}, {p.w1, h, h}, {p.w2, h, h},
                             {p.w3, h, h}, {p.w4a, dx, h}, {p.w4b, h, h},
                             {p.w5, h, h}, {p.w6, h, bn}, {p.wb, bn, bn},
                             {p.wr1a, bn, r}, {p.wr1b, dd, r}});
}

// The delta maps of the proposal net's trunk passes (the pass's k_dim,
// n_out): w3 w2 w1 at 0 1 2.
template <typename T>
int prop_dmaps(TileMaps* maps, const PropWeights<T>& p, int h) {
  return tile_maps<T>(maps, {{p.w3, h, h}, {p.w2, h, h}, {p.w1, h, h}},
                      true);
}

// The delta maps of the vanilla net's trunk passes: wr1a (dbvec) 0, wb
// (dz7) 1, w6 2, w5 3, w4b 4, w3 5, w2 6, w1 7.
template <typename T>
int vanilla_dmaps(TileMaps* maps, const VanillaWeights<T>& p, int h, int bn,
                  int r, int pass) {
  return tile_maps<T>(maps, {{p.wr1a, r, bn}, {p.wb, bn, bn}, {p.w6, bn, h},
                             {p.w5, h, h}, {p.w4b, h, h}, {p.w3, h, h},
                             {p.w2, h, h}, {p.w1, h, h}}, true, pass);
}

// The occupancy of the kernels that run the delta pass and of the
// weight-grad pass's bf16 body, as this source file launched them: for each
// (kernel, shared memory) pair its name, the blocks an SM that the
// runtime's occupancy query gives at the launch's threads, and the blocks
// an SM it was built for (MinBlocks, or one for the weight-grad body).  A
// pair is queried once; the library's <lib>_occupancy entry
// (OCCUPANCY_ENTRY) reports them, one "name smem blocks want" line each,
// and chip_smoke.py holds every bf16 backward at its two blocks an SM.  The log, and set_smem that writes it,
// are static (one per source file): a function-local static of an inline
// function would be one object for every library of the process.
struct OccupancyEntry {
  const void* kernel;
  const char* name;
  size_t smem;
  int blocks, want;
};

struct OccupancyLog {
  std::mutex lock;
  int count = 0;
  OccupancyEntry e[32];
};

static inline OccupancyLog& occupancy_log() {
  static OccupancyLog log;
  return log;
}

template <typename K>
static void note_occupancy(K kernel, size_t smem, const char* name,
                           int want, int threads) {
  OccupancyLog& log = occupancy_log();
  std::lock_guard<std::mutex> hold(log.lock);
  for (int i = 0; i < log.count; ++i)
    if (log.e[i].kernel == (const void*)kernel && log.e[i].smem == smem)
      return;
  if (log.count == 32) return;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    blocks = -1;
  }
  log.e[log.count++] = {(const void*)kernel, name, smem, blocks, want};
}

// The log's lines into buf (len bytes, NUL-terminated); returns the bytes
// the whole report needs.
static inline int occupancy_report(char* buf, int len) {
  OccupancyLog& log = occupancy_log();
  std::lock_guard<std::mutex> hold(log.lock);
  int used = 0;
  for (int i = 0; i < log.count; ++i) {
    const OccupancyEntry& e = log.e[i];
    used += snprintf(buf + (used < len ? used : len),
                     used < len ? (size_t)(len - used) : 0, "%s %zu %d %d\n",
                     e.name, e.smem, e.blocks, e.want);
  }
  return used + 1;
}

#define OCCUPANCY_ENTRY(LIB)                                                  \
  int LIB##_occupancy(char* buf, int len) {                                   \
    return mlp::occupancy_report(buf, len);                                   \
  }

// Allow `bytes` of dynamic shared memory for `kernel`; a request beyond the
// card's limit (at wide layers) returns its error code, which is then cleared
// so that it does not surface at the next unrelated launch.  With a
// ``name`` (the kernels that run the delta pass, the weight-grad pass's
// bf16 body) the occupancy of a launch of ``threads`` threads is noted
// (note_occupancy) beside ``want``, the blocks an SM it was built for.
template <typename K>
static int set_smem(K kernel, size_t bytes, const char* name = nullptr,
                    int want = 0, int threads = THREADS) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  else if (name != nullptr)
    note_occupancy(kernel, bytes, name, want, threads);
  return (int)err;
}

}  // namespace mlp
