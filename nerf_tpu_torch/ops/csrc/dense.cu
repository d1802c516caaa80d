// The forward layer tile (mlp_tile.cuh's dense_tile) on its own, for holding
// it against its plain version and timing it at the layer shapes of the
// fused kernels.  No fused kernel calls this entry: each runs the same
// dense_tile<STORE, T, MASK> inside its own block.
//
//   dense_layer <- the layer math of the Pallas MLP kernels,
//                  act(_dense(h, w, b)).astype(cd) (nerf_tpu/ops/
//                  fused_mlp.py:58, :101-116; nerf_tpu/ops/ref_fused.py's
//                  trunks): out = act(a0 @ w0 [+ a1 @ w1] + b) in T, the
//                  products accumulated in f32, the bias added in f32
//
// One block per TM = 64 rows: the rows of a0 (and a1) are loaded into shared
// memory, the tile runs as the fused kernels run it, and its output rows go
// to ``out``; with ``stored`` the tile's own STORE path also writes them
// there (the stored activations of the *_fwd_res kernels), with ``mbits``
// its MASK path's ReLU bits (ref_spa_fwd_grad's masks), mask_words(n_out)
// words a row.  Bound by operations on an H100 at widths of 128 and more
// (2 n n_out (k0 + k1) FLOPs against 2 (k0 + k1 + n_out) bytes a row).

#include <chrono>

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

template <bool STORE, bool MASK, typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
dense_layer_kernel(const T* __restrict__ a0, int k0, const T* __restrict__ w0,
                   const T* __restrict__ a1, int k1,
                   const T* __restrict__ w1, const float* __restrict__ bias,
                   int64_t n, int n_out, bool relu, T* __restrict__ out,
                   T* __restrict__ stored, uint32_t* __restrict__ mbits,
                   const __grid_constant__ TileMaps maps) {
  extern __shared__ __align__(RING_ALIGN) unsigned char smem[];
  T* xs0 = reinterpret_cast<T*>(smem);
  T* xs1 = xs0 + TM * k0;
  T* ys = xs1 + TM * k1;
  uint32_t* mb = reinterpret_cast<uint32_t*>(ys + TM * n_out);
  const int mw = mask_words(n_out);
  T* st = reinterpret_cast<T*>(mb + TM * mw);     // dense_tile's stage
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  load_tile(a0, k0, row0, n, xs0);
  if (a1 != nullptr) load_tile(a1, k1, row0, n, xs1);
  __syncthreads();
  dense_tile<STORE, T, MASK>(xs0, k0, w0, a1 != nullptr ? xs1 : nullptr, k1,
                             w1, bias, n_out, relu, ys, stored, row0, n, st,
                             &maps.map[0], mb);
  __syncthreads();
  // the valid rows, one span of out: 16 bytes a store (out is aligned, and
  // so is each tile's span of it)
  constexpr int PER = 16 / sizeof(T);
  const int64_t valid = n - row0 < TM ? n - row0 : TM;
  const int count = (int)valid * n_out;
  T* dst = out + row0 * n_out;
  for (int j = threadIdx.x; j < count / PER; j += THREADS)
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(ys)[j];
  for (int idx = count / PER * PER + threadIdx.x; idx < count; idx += THREADS)
    dst[idx] = ys[idx];
  if (MASK)
    for (int idx = threadIdx.x; idx < valid * mw; idx += THREADS)
      mbits[row0 * mw + idx] = mb[idx];
}

// a1, w1: null for a layer of one product (k1 is then 0); stored, mbits:
// null unless asked for.
template <typename T>
int run_dense_layer(const T* a0, int k0, const T* w0, const T* a1, int k1,
                    const T* w1, const float* bias, int64_t n, int n_out,
                    int relu, T* out, T* stored, uint32_t* mbits,
                    cudaStream_t stream) {
  if (a1 == nullptr) k1 = 0;
  if (k0 < 1 || k1 < 0 || n_out < 1 || n < 0 || !tile_widths_ok<T>({n_out}))
    return (int)cudaErrorInvalidValue;
  const size_t at = (size_t)TM * (k0 + k1 + n_out) * sizeof(T)
      + (size_t)TM * mask_words(n_out) * sizeof(uint32_t);
  const size_t smem = at + dense_stage_bytes<T>(at);
  const bool store = stored != nullptr, mask = mbits != nullptr;
  auto kernel = store ? (mask ? dense_layer_kernel<true, true, T>
                              : dense_layer_kernel<true, false, T>)
                      : (mask ? dense_layer_kernel<false, true, T>
                              : dense_layer_kernel<false, false, T>);
  TileMaps maps;
  int err = tile_maps<T>(&maps, {{w0, k0, n_out},
                                 {a1 != nullptr ? w1 : nullptr, k1, n_out}});
  if (err == 0) err = set_smem(kernel, smem);
  if (err != 0 || n == 0) return err;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  kernel<<<grid, THREADS, smem, stream>>>(a0, k0, w0, a1, k1, w1, bias, n,
                                          n_out, relu != 0, out, stored,
                                          mbits, maps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define DENSE(SUFFIX, T)                                                       \
  int dense_layer_##SUFFIX(const void* a0, int k0, const void* w0,            \
                           const void* a1, int k1, const void* w1,            \
                           const void* bias, int64_t n, int n_out, int relu,  \
                           void* out, void* stored, void* mbits,              \
                           void* stream) {                                    \
    return run_dense_layer<T>((const T*)a0, k0, (const T*)w0, (const T*)a1,   \
                              k1, (const T*)w1, (const float*)bias, n, n_out, \
                              relu, (T*)out, (T*)stored, (uint32_t*)mbits,    \
                              (cudaStream_t)stream);                          \
  }

DENSE(f32, float)
DENSE(bf16, __nv_bfloat16)

// The host's microseconds for one encoding of the tensor map of a (k_dim,
// n_out) bf16 weight at ``w`` (the mean of ``reps``), as each bf16 launch of
// every tile kernel encodes one for each weight its tiles read; negative if
// an encoding fails.
double dense_map_encode_us(const void* w, int k_dim, int n_out, int reps) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (weight_map(&map, w, k_dim, n_out) != 0) return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (reps > 0 ? reps : 1);
}

const char* dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
