// The split-K weight-grad pass of the backward kernels on its own
// (wgrad.cuh), for holding it against its plain version and timing it at a
// backward's job lists.  No backward calls this entry: each launches the
// same launch_wgrad_reduce<T> after its delta pass.
//
//   wgrad_reduce <- the `grad_ref[...] += partial` accumulation of the Pallas
//                   backwards (nerf_tpu/ops/fused_mlp.py:228-237;
//                   nerf_tpu/ops/ref_fused.py:719, :794, :896)
//
// Bound by bytes on an H100 (wgrad.cuh says how the bf16 body meets it).

#include "wgrad.cuh"

namespace {

// a, delta: n_jobs device pointers; dims: (m, k, ld, delta_f32, bias) per
// job; the grads are each job's dW (m x k) and, with bias, db (k), in job
// order; partial: splits x their sizes floats, splits = ceil(n /
// rows_per_split).
template <typename T>
int run_wgrad_reduce(const uint64_t* a, const uint64_t* delta,
                     const int64_t* dims, int n_jobs, int64_t n,
                     int64_t rows_per_split, int round_partial,
                     int accumulate, float* partial, const uint64_t* grads,
                     cudaStream_t stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS || n < 0 || rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  int64_t sizes[MAX_GRADS];
  int wi[MAX_JOBS], bi[MAX_JOBS], n_grads = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int64_t* d = dims + 5 * j;
    if (n_grads + (d[4] ? 2 : 1) > MAX_GRADS) return (int)cudaErrorInvalidValue;
    wi[j] = n_grads;
    sizes[n_grads++] = d[0] * d[1];
    bi[j] = d[4] ? n_grads : -1;
    if (d[4]) sizes[n_grads++] = d[1];
  }
  int64_t splits = (n + rows_per_split - 1) / rows_per_split;
  if (splits < 1) splits = 1;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const GradPlan g = plan_grads(sizes, n_grads, (int)splits);
  WGradJobs jobs;
  jobs.n_jobs = 0;
  int tiles = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int64_t* d = dims + 5 * j;
    add_job(jobs, tiles, g, partial, (const void*)a[j], (int)d[0],
            (const void*)delta[j], (int)d[1], d[3] != 0, wi[j], bi[j], d[2]);
  }
  return launch_wgrad_reduce<T>(jobs, tiles, g, partial, grads, n,
                                (int)splits, rows_per_split,
                                round_partial != 0, stream, accumulate != 0);
}

}  // namespace

extern "C" {

#define WGRAD(SUFFIX, T)                                                       \
  int wgrad_reduce_##SUFFIX(const uint64_t* a, const uint64_t* delta,         \
                            const int64_t* dims, int n_jobs, int64_t n,        \
                            int64_t rows_per_split, int round_partial,         \
                            int accumulate, void* partial,                     \
                            const uint64_t* grads, void* stream) {             \
    return run_wgrad_reduce<T>(a, delta, dims, n_jobs, n, rows_per_split,      \
                               round_partial, accumulate, (float*)partial,     \
                               grads, (cudaStream_t)stream);                   \
  }

WGRAD(f32, float)
WGRAD(bf16, __nv_bfloat16)

const char* wgrad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

OCCUPANCY_ENTRY(wgrad)

}  // extern "C"
