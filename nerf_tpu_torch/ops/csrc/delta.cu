// The backwards' delta pass (mlp_tile.cuh's delta_tile) on its own, for
// holding it against its plain version and timing it at the layer shapes of
// the fused kernels.  No fused kernel calls this entry: each runs the same
// delta_tile<ADD, T, OutT, MBITS> inside its own block.
//
//   delta_layer <- the chain rule of the Pallas backwards,
//                  jnp.where(act > 0, _dwt(delta, w), 0).astype(cd)
//                  (nerf_tpu/ops/fused_mlp.py:69, the vanilla chain :203-221,
//                  the proposal chain :516-524; the same products and masks
//                  inside the hand-written jax.vjps of nerf_tpu/ops/
//                  ref_fused.py :643 (the density gradient), :701, :729,
//                  :867, :901): out = mask(a @ W^T [+ gs wcol^T]) in T, with
//                  W the layer's (n_out, k_dim) forward matrix, the products
//                  accumulated in f32
//
// One block per TM = 64 rows: the rows of a (and of the optional operands)
// are loaded into shared memory, the pass runs as the fused kernels run it,
// and its rows go to ``out``; with ``stored`` its gout path also writes them
// there, in T or (stored_f32) unrounded f32.  ``prev`` gives ADD its
// starting values (the T sum of earlier pullbacks); ``mbits`` replaces
// ``act`` as the mask (mask_words(n_out) words a row).
//
// Bound on an H100 at widths of 128 and more: 2 n n_out k_dim FLOPs against
// the bytes of a, act and gout (2 (k_dim + 2 n_out) a row in bf16), by
// operations; the heads (k_dim <= 9) are bound by bytes.  The design keeps
// the product on the tensor cores at any width.  Where k_dim is a multiple
// of 8 (every trunk layer), W's rows come 256 x 16 at a time (one k-step)
// by TMA into a two-slot ring paced by mbarriers, and each warpgroup's
// k-step is four wgmma m64n32k16 with B read from the swizzled slot; the
// heads (k_dim 0, 2, 3, 9) stage one zero-padded k-step by cp.async and
// multiply with mma.sync.  The epilogue works in the fragments' registers.

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

template <bool ADD, bool MBITS, typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
delta_layer_kernel(const T* __restrict__ a, int k_dim,
                   const T* __restrict__ w, int n_out,
                   const T* __restrict__ act, const T* __restrict__ gs,
                   const T* __restrict__ wcol, const T* __restrict__ prev,
                   const uint32_t* __restrict__ mbits, int64_t n,
                   T* __restrict__ out, OutT* __restrict__ stored,
                   const __grid_constant__ TileMaps dm) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);             // (TM, k_dim)
  T* ys = as + TM * k_dim;                        // (TM, n_out)
  T* gss = ys + TM * n_out;                       // (TM,)
  uint32_t* mb = reinterpret_cast<uint32_t*>(gss + TM);
  const int mw = mask_words(n_out);
  T* st = reinterpret_cast<T*>(mb + (MBITS ? TM * mw : 0));
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t valid = n - row0 < TM ? n - row0 : TM;
  if (k_dim > 0) load_tile(a, k_dim, row0, n, as);
  if (ADD) load_tile(prev, n_out, row0, n, ys);
  if (gs != nullptr)
    for (int t = threadIdx.x; t < TM; t += THREADS)
      gss[t] = t < valid ? gs[row0 + t] : from_f<T>(0.f);
  if (MBITS)
    for (int idx = threadIdx.x; idx < TM * mw; idx += THREADS)
      mb[idx] = idx < valid * mw ? mbits[row0 * mw + idx] : 0u;
  __syncthreads();
  // a pass that is no ring_ok (the heads) has no map and runs on mma.sync
  const CUtensorMap* tmap = ring_ok(w, k_dim) ? &dm.map[0] : nullptr;
  delta_tile<ADD, DPASS, T, OutT, MBITS>(as, k_dim, w, n_out, act,
                                         gs != nullptr ? gss : nullptr, wcol,
                                         ys, stored, row0, n, st, tmap, mb);
  __syncthreads();
  // the valid rows, one span of out: 16 bytes a store where the span is
  // 16-byte aligned
  constexpr int PER = 16 / sizeof(T);
  const int count = (int)valid * n_out;
  T* dst = out + row0 * n_out;
  int done = 0;
  if ((uintptr_t)dst % 16 == 0) {
    for (int j = threadIdx.x; j < count / PER; j += THREADS)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(ys)[j];
    done = count / PER * PER;
  }
  for (int idx = done + threadIdx.x; idx < count; idx += THREADS)
    dst[idx] = ys[idx];
}

template <bool ADD, bool MBITS, typename T, typename OutT>
int launch_delta(const T* a, int k_dim, const T* w, int n_out, const T* act,
                 const T* gs, const T* wcol, const T* prev,
                 const uint32_t* mbits, int64_t n, T* out, OutT* stored,
                 cudaStream_t stream) {
  const size_t at = (size_t)TM * (k_dim + n_out + 1) * sizeof(T)
      + (MBITS ? (size_t)TM * mask_words(n_out) * sizeof(uint32_t) : 0);
  const size_t smem = at + delta_stage_bytes<T>(at);
  auto kernel = delta_layer_kernel<ADD, MBITS, T, OutT>;
  TileMaps dm;
  int err = ring_ok(w, k_dim) ? tile_maps<T>(&dm, {{w, k_dim, n_out}}, true)
                              : 0;
  if (err == 0) err = set_smem(kernel, smem, "delta_layer_kernel", MinBlocks<T>::value);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  kernel<<<grid, THREADS, smem, stream>>>(a, k_dim, w, n_out, act, gs, wcol,
                                          prev, mbits, n, out, stored, dm);
  return (int)cudaGetLastError();
}

// act, gs/wcol (together), prev (ADD), mbits and stored: null unless asked
// for; act and mbits not both.
template <typename T, typename OutT>
int run_delta_layer(const T* a, int k_dim, const T* w, int n_out,
                    const T* act, const T* gs, const T* wcol, const T* prev,
                    const uint32_t* mbits, int64_t n, T* out, OutT* stored,
                    cudaStream_t stream) {
  if (k_dim < 0 || n_out < 1 || n < 0 || (act != nullptr && mbits != nullptr)
      || ((gs == nullptr) != (wcol == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool add = prev != nullptr, bits = mbits != nullptr;
  auto run = add ? (bits ? launch_delta<true, true, T, OutT>
                         : launch_delta<true, false, T, OutT>)
                 : (bits ? launch_delta<false, true, T, OutT>
                         : launch_delta<false, false, T, OutT>);
  return run(a, k_dim, w, n_out, act, gs, wcol, prev, mbits, n, out, stored,
             stream);
}

}  // namespace

extern "C" {

// stored_f32: stored is f32 (the unrounded values), else T
#define DELTA(SUFFIX, T)                                                       \
  int delta_layer_##SUFFIX(const void* a, int k_dim, const void* w,           \
                           int n_out, const void* act, const void* gs,        \
                           const void* wcol, const void* prev,                \
                           const void* mbits, int64_t n, void* out,           \
                           void* stored, int stored_f32, void* stream) {      \
    if (stored_f32)                                                            \
      return run_delta_layer<T, float>(                                        \
          (const T*)a, k_dim, (const T*)w, n_out, (const T*)act,              \
          (const T*)gs, (const T*)wcol, (const T*)prev,                        \
          (const uint32_t*)mbits, n, (T*)out, (float*)stored,                  \
          (cudaStream_t)stream);                                               \
    return run_delta_layer<T, T>(                                              \
        (const T*)a, k_dim, (const T*)w, n_out, (const T*)act, (const T*)gs,  \
        (const T*)wcol, (const T*)prev, (const uint32_t*)mbits, n, (T*)out,   \
        (T*)stored, (cudaStream_t)stream);                                     \
  }

DELTA(f32, float)
DELTA(bf16, __nv_bfloat16)

OCCUPANCY_ENTRY(delta)

const char* delta_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
