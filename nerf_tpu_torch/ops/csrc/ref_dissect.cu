// The directional kernels of Ref-NeRF taken apart, stage by stage, for
// Hopper (sm_90a).
//
// Replace the Pallas TPU microbenchmarks of tools/bench_ref_kernels.py (the
// JAX package's): kernels that run only a slice of the directional kernels'
// work with the same staging, so that the difference of two slices is the
// time of the part between them.
//   ref_dir_fwd_dissect <- _dissect_dir_fwd (:145, pallas_call :258): the
//                          directional forward (ref_dir_fwd) in five
//                          cumulative stages, DIR_TRUNK .. DIR_FULL
//                          (ref_common.cuh); the stage is an argument that
//                          picks one compiled instantiation
//   ref_dir_bwd_dissect <- _dissect_dir_bwd (:45, pallas_call :115): the
//                          recompute-form directional backward
//                          (ref_dir_bwd_recompute) in four modes,
//                          BWD_RECOMPUTE .. BWD_FULL (ref_dir_recompute.cuh)
// Both are the shipped kernels' own code (ref_dir_fwd.cuh,
// ref_dir_recompute.cuh) with a compile-time stage or mode, not copies:
// stage DIR_FULL is ref_dir_fwd and mode BWD_FULL ref_dir_bwd_recompute, bit
// for bit, and the other stages and modes differ from them only by what they
// switch off.  The first two forward stages read the trunk input's IDE and
// d.n columns from a (2C + 1, N) f32 input instead of computing them, as the
// TPU version does.  sRGB is off, as in the TPU version.
//
// Bound on an H100 SXM (700 W): every stage and mode is dominated by the
// trunk's products (545,024 MACs per point forward, twice that and a
// rebuild backward), bound by operations like the kernels it takes apart;
// this first version multiplies on the CUDA cores as they do.

#include "ref_dir_fwd.cuh"
#include "ref_dir_recompute.cuh"

// ops/build.py compiles this library in four parts at once, one object each,
// and links them: CSRC_PART 0 and 1 hold the forward stages in f32 and bf16,
// 2 and 3 the backward modes.  Without CSRC_PART the file holds all four.
#ifndef CSRC_PART
#define CSRC_PART -1
#endif
#define IN_PART(i) (CSRC_PART < 0 || CSRC_PART == (i))

extern "C" {

#define REF_DISSECT_FWD(SUFFIX, T)                                             \
  int ref_dir_fwd_dissect_##SUFFIX(                                            \
      int stage, const void* heads, const void* noise, const void* dirs,      \
      int64_t per_ray, const void* rows, const void* mat, const void* sigma,  \
      const uint64_t* ptrs, int64_t n, const int* dims, void* rgb,            \
      void* normal, void* density, void* stream) {                            \
    auto run = [&](auto launch) {                                              \
      return launch(heads, noise, dirs, per_ray, rows, mat, sigma, ptrs, n,   \
                    dims, (float*)rgb, (float*)normal, (float*)density,       \
                    nullptr, (cudaStream_t)stream);                            \
    };                                                                         \
    switch (stage) {                                                           \
      case DIR_TRUNK: return run(launch_dir<false, DIR_TRUNK, T>);             \
      case DIR_REFLECT: return run(launch_dir<false, DIR_REFLECT, T>);         \
      case DIR_VANDER: return run(launch_dir<false, DIR_VANDER, T>);           \
      case DIR_POLAR: return run(launch_dir<false, DIR_POLAR, T>);             \
      case DIR_FULL: return run(launch_dir<false, DIR_FULL, T>);               \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define REF_DISSECT_BWD(SUFFIX, T)                                             \
  int ref_dir_bwd_dissect_##SUFFIX(                                            \
      int mode, const void* heads, const void* noise, const void* dirs,       \
      int64_t per_ray, const void* mat, const void* sigma, const void* grgb,  \
      const void* gnrm, const void* gden, const uint64_t* ptrs, int64_t n,    \
      const int* dims, void* xg, const uint64_t* acts,                        \
      const uint64_t* deltas, void* dlog, void* dheads, void* partial,        \
      int64_t rows_per_split, int64_t chunk_rows, const uint64_t* grads,      \
      void* stream) {                                                          \
    auto run = [&](auto launch) {                                              \
      return launch(heads, noise, dirs, per_ray, mat, sigma, grgb, gnrm,      \
                    gden, ptrs, n, dims, xg, acts, deltas, (float*)dlog,      \
                    (float*)dheads, (float*)partial, rows_per_split,          \
                    chunk_rows, grads, (cudaStream_t)stream);                  \
    };                                                                         \
    switch (mode) {                                                            \
      case BWD_RECOMPUTE:                                                      \
        return run(launch_dir_bwd_recompute<BWD_RECOMPUTE, T>);                \
      case BWD_DHEADS: return run(launch_dir_bwd_recompute<BWD_DHEADS, T>);    \
      case BWD_WGRADS: return run(launch_dir_bwd_recompute<BWD_WGRADS, T>);    \
      case BWD_FULL: return run(launch_dir_bwd_recompute<BWD_FULL, T>);        \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#if IN_PART(0)
REF_DISSECT_FWD(f32, float)

const char* ref_dissect_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
#if IN_PART(1)
REF_DISSECT_FWD(bf16, __nv_bfloat16)
#endif
#if IN_PART(2)
REF_DISSECT_BWD(f32, float)
#endif
#if IN_PART(3)
REF_DISSECT_BWD(bf16, __nv_bfloat16)
#endif

}  // extern "C"
