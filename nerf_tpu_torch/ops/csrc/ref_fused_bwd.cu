// Fused Ref-NeRF backward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of nerf_tpu/ops/ref_fused.py in their
// residual-storing form (store_residuals=True, the shipped default):
//   ref_spa_bwd <- _make_spa_bwd_res_kernel (:729-796): the heads' cotangent
//                  g (N, 11 + NB) f32 and the 8 activations h1..h4 z5 z6 z7
//                  inter stored by ref_spa_fwd_res -> the 23 f32 grads of the
//                  spatial tuple.  d(inter) sums the three heads' pullbacks
//                  as T arrays (rt + nct, rounded, + bn, rounded), then the
//                  trunk's chain rule; w4a and w4b both take d(z5).
//   ref_dir_bwd <- _make_dir_bwd_res_kernel (:901-1009): the cotangents of
//                  rgb, normal (N, 3) and density (N,) f32 and the 8
//                  activations h1..h4 z5 z6 z7 z8 stored by ref_dir_fwd_res
//                  -> d(heads) (N, 11 + NB) f32 and the 19 f32 grads of the
//                  directional tuple.  The TPU kernel differentiates the rgb
//                  tail and the glue before the trunk with jax.vjp; here both
//                  are written out, one thread per point, in f32: the tail
//                  (sigmoid head through head3's rule, specular * sigmoid(tint)
//                  + sigmoid(diffuse), the sRGB curve's derivative on both
//                  branches of its where), then, from the pullback of the
//                  trunk input x = [bottleneck + noise | IDE | d.n], the IDE
//                  (re, im, the z-powers @ mat and the attenuation; the
//                  algebraic rules d z^i = i z^(i-1) and d (x + iy)^m =
//                  m (x + iy)^(m-1) of vander_bwd / powers_bwd), roughness
//                  (softplus' = exp(v - softplus(v)), logaddexp's rule), the
//                  reflection and d.n on the raw direction, the normal's
//                  normalization (which also takes g_normal), and the
//                  passthroughs: g_density into column 1, the bottleneck's
//                  pullback into columns 11 on.
//
// Numerics are _cd_matmul_rules' (ref_fused.py:87-163) with bwd_cd=True:
// every cotangent cast to T before its pullback product, f32 accumulation,
// the ReLU masks from the stored post-activations (act > 0), the split-input
// pullbacks summed as T arrays, bias grads f32 sums of the T deltas (dbh of
// the f32 logit cotangent), and each grid tile's weight grad rounded to T
// before the f32 sum over tiles: the K-splits of the weight-grad pass are the
// TPU's tiles (rows_per_split = its tile) and round their partials.
//
// Each backward is three launches, as in fused_mlp_bwd.cu: a per-tile delta
// pass that writes every layer's delta (and, for the directional net, the
// trunk input x and the f32 logit cotangent) to device memory, the split-K
// weight-grad pass and the ordered reduction (wgrad.cuh): deterministic, no
// atomics.
//
// Bound on an H100 SXM (700 W), bf16 tensor-core peak 989 TFLOP/s: at
// H = O = 256 the spatial backward costs 526,592 weight-grad MACs and about
// 494,000 delta MACs per point, the directional 545,024 and about 545,000;
// both are bound by operations (about 0.41 and 0.43 ms at N = 196,608).  This
// first version multiplies on the CUDA cores in f32 and pays the delta round
// trip through device memory.

#include "ref_common.cuh"
#include "wgrad.cuh"

namespace {

using namespace mlp;

// The deltas of a backward, (n, width) each in T.
template <typename T>
struct Deltas {
  T* d[11];
};

template <typename T>
Deltas<T> deltas_of(const uint64_t* ptrs, int count) {
  Deltas<T> o;
  for (int i = 0; i < count; ++i) o.d[i] = (T*)ptrs[i];
  return o;
}

// deltas: d1 .. d7 (H), d8 (O), then g_rt (2), g_nct (9), g_bn (NB) in T
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_spa_delta_kernel(RefSpaWeights<T> p, Acts<T> s,
                     const float* __restrict__ g, int64_t n, int h, int o,
                     int nb, int maxw, Deltas<T> dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* grt = reinterpret_cast<T*>(smem);   // (TM, 2)
  T* gnct = grt + TM * 2;                // (TM, 9)
  T* gbn = gnct + TM * 9;                // (TM, NB)
  T* buf_a = gbn + TM * nb;
  T* buf_b = buf_a + TM * maxw;
  T* st = buf_b + TM * maxw;             // the W^T stage
  const T* none = nullptr;
  T* drop = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int hw = HEAD_FIXED + nb;
  for (int idx = threadIdx.x; idx < TM * hw; idx += THREADS) {
    const int r = idx / hw;
    const int c = idx - r * hw;
    const int64_t row = row0 + r;
    const T v = from_f<T>(row < n ? g[row * hw + c] : 0.f);
    T *tile, *out;
    int col, width;
    if (c < 2) {
      tile = grt, out = dl.d[8], col = c, width = 2;
    } else if (c < HEAD_FIXED) {
      tile = gnct, out = dl.d[9], col = c - 2, width = 9;
    } else {
      tile = gbn, out = dl.d[10], col = c - HEAD_FIXED, width = nb;
    }
    tile[r * width + col] = v;
    if (row < n) out[row * width + col] = v;
  }
  __syncthreads();
  // d(inter) = cd(cd(g_rt wrt^T) + cd(g_nct wnct^T)) + cd(g_bn wbn^T), masked
  delta_tile(grt, 2, p.wrt, o, none, none, none, buf_a, drop, row0, n, st);
  __syncthreads();
  delta_tile<true>(gnct, 9, p.wnct, o, none, none, none, buf_a, drop, row0, n, st);
  __syncthreads();
  delta_tile<true>(gbn, nb, p.wbn, o, s.a[7], none, none, buf_a, dl.d[7], row0, n, st);
  __syncthreads();
  delta_tile(buf_a, o, p.w7, h, s.a[6], none, none, buf_b, dl.d[6], row0, n, st);    // z7
  __syncthreads();
  delta_tile(buf_b, h, p.w6, h, s.a[5], none, none, buf_a, dl.d[5], row0, n, st);    // z6
  __syncthreads();
  delta_tile(buf_a, h, p.w5, h, s.a[4], none, none, buf_b, dl.d[4], row0, n, st);    // z5
  __syncthreads();
  delta_tile(buf_b, h, p.w4b, h, s.a[3], none, none, buf_a, dl.d[3], row0, n, st);   // h4
  __syncthreads();
  delta_tile(buf_a, h, p.w3, h, s.a[2], none, none, buf_b, dl.d[2], row0, n, st);    // h3
  __syncthreads();
  delta_tile(buf_b, h, p.w2, h, s.a[1], none, none, buf_a, dl.d[1], row0, n, st);    // h2
  __syncthreads();
  delta_tile(buf_a, h, p.w1, h, s.a[0], none, none, buf_b, dl.d[0], row0, n, st);    // h1
}

// d/dv of linear_to_srgb (ref_fused.py:303-308) times g, as jax.vjp takes it
// through the where: 323/25 below the knee, else (g / 200) 211 (5/12)
// max(eps, v)^(5/12 - 1).
__device__ __forceinline__ float srgb_bwd(float v, float g) {
  return v <= 0.0031308f
      ? g * (323.f / 25.f)
      : g / 200.f * 211.f * (5.f / 12.f * powf(fmaxf(FLT_EPSILON, v),
                                                5.f / 12.f - 1.f));
}

// The pullback of one point's glue (_dir_glue_prelude_rowland, ref_fused.py
// :543-572, with the recurrence IDE's hand rules :410-414, :474-482) into
// its row dh of d(heads), columns 0..10: xr is the pullback of the trunk
// input row in T (IDE in columns [nb, nb + 2C), d.n in nb + 2C); gn the
// normal's cotangent; dtint3 and ddiff3 those of sigmoid(tint) and
// sigmoid(diffuse [- ln 3]).  The forward is recomputed as dir_glue does it.
template <typename T>
__device__ void dir_glue_bwd(const float* hr, const float* dv,
                             const float* mat, const float* sig,
                             const DirDims& d, const T* xr, const float* gn,
                             float gden, const float* tint3,
                             const float* diff3, const float* dtint3,
                             const float* ddiff3, float* dh) {
  const float n0 = hr[2], n1 = hr[3], n2 = hr[4];
  const float nrm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
  const float s = nrm + 1e-7f;
  const float m0 = -n0 / s, m1 = -n1 / s, m2 = -n2 / s;
  const float dn = dv[0] * m0 + dv[1] * m1 + dv[2] * m2;
  const float x = dv[0] - 2.f * dn * m0;
  const float y = dv[1] - 2.f * dn * m1;
  const float z = dv[2] - 2.f * dn * m2;
  const float rho = hr[0] - 1.f;
  const float rough = softplusf(rho);
  float gx = 0.f, gy = 0.f, gz = 0.f, grough = 0.f;
  int c = 0;
  for (int l = 1; l <= d.l_max; l *= 2) {
    float pr = 1.f, pi = 0.f;   // (x + iy)^m
    float qr = 0.f, qi = 0.f;   // (x + iy)^(m - 1), 0 at m = 0
    for (int m = 0; m <= l; ++m, ++c) {
      float vzm = 0.f, dvzm = 0.f, zp = 1.f, zq = 0.f;
      for (int i = 0; i <= d.l_max; ++i) {
        const float mc = mat[i * d.n_ch + c];
        vzm = fmaf(mc, zp, vzm);             // sum_i mat[i, c] z^i
        dvzm = fmaf(mc * (float)i, zq, dvzm);  // sum_i mat[i, c] i z^(i-1)
        zq = zp;
        zp *= z;
      }
      const float att = expf(-sig[c] * rough);
      const float gre = to_f(xr[d.nb + c]);
      const float gim = to_f(xr[d.nb + d.n_ch + c]);
      // out_re = (re vzm) att, out_im = (im vzm) att
      const float are = gre * att, aim = gim * att;
      const float dre = are * vzm, dim = aim * vzm;
      gz = fmaf(are * pr + aim * pi, dvzm, gz);
      gx += (float)m * (dre * qr + dim * qi);
      gy += (float)m * (dim * qr - dre * qi);
      grough += (gre * (pr * vzm) + gim * (pi * vzm)) * att * -sig[c];
      qr = pr;
      qi = pi;
      const float next = pr * x - pi * y;
      pi = pi * x + pr * y;
      pr = next;
    }
  }
  // reflect = d - (2 d.n) m; d.n = d . m, which also takes the trunk's row
  const float two_dn = 2.f * dn;
  const float gdn = to_f(xr[d.nb + 2 * d.n_ch])
      - 2.f * (gx * m0 + gy * m1 + gz * m2);
  const float gm0 = gn[0] - two_dn * gx + dv[0] * gdn;
  const float gm1 = gn[1] - two_dn * gy + dv[1] * gdn;
  const float gm2 = gn[2] - two_dn * gz + dv[2] * gdn;
  // m = -n / s, s = sqrt(|n|^2 + 1e-20) + 1e-7
  const float ds = (gm0 * n0 + gm1 * n1 + gm2 * n2) / (s * s);
  const float dq = ds * (0.5f / nrm);
  dh[0] = grough * expf(rho - rough);
  dh[1] = gden;
  dh[2] = -(gm0 / s) + 2.f * n0 * dq;
  dh[3] = -(gm1 / s) + 2.f * n1 * dq;
  dh[4] = -(gm2 / s) + 2.f * n2 * dq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dh[5 + k] = ddiff3[k] * (diff3[k] * (1.f - diff3[k]));
    dh[8 + k] = dtint3[k] * (tint3[k] * (1.f - tint3[k]));
  }
}

// deltas: d1 .. d6 (H), d7 d8 (O) in T; xg (n, dd) the trunk input in T;
// dlog (n, 3) the f32 cotangent of the specular logits
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
ref_dir_delta_kernel(const float* __restrict__ heads,
                     const T* __restrict__ noise,
                     const float* __restrict__ dirs, int64_t per_ray,
                     const float* __restrict__ mat,
                     const float* __restrict__ sigma,
                     const float* __restrict__ grgb,
                     const float* __restrict__ gnrm,
                     const float* __restrict__ gden, RefDirWeights<T> p,
                     Acts<T> s, int64_t n, DirDims d, T* __restrict__ xg,
                     Deltas<T> dl, float* __restrict__ dlog,
                     float* __restrict__ dheads) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* mat_s = reinterpret_cast<float*>(smem);
  float* sig_s = mat_s + (d.l_max + 1) * d.n_ch;
  float* tint_s = sig_s + d.n_ch;     // (TM, 3) sigmoid(tint)
  float* diff_s = tint_s + TM * 3;    // (TM, 3) sigmoid(diffuse [- ln 3])
  float* spec_s = diff_s + TM * 3;    // (TM, 3) sigmoid(logit)
  float* dtint_s = spec_s + TM * 3;   // (TM, 3) their cotangents
  float* ddiff_s = dtint_s + TM * 3;
  const int nf = ((d.l_max + 1) * d.n_ch + d.n_ch + 15 * TM + 3) & ~3;
  T* xs = reinterpret_cast<T*>(mat_s + nf);   // x, then its pullback
  T* buf_a = xs + TM * d.dd;
  T* buf_b = buf_a + TM * d.maxw;
  T* dlc = buf_b + TM * d.maxw;       // (TM, 3) logit cotangent in T
  T* st = dlc + TM * 4;               // the W^T stage
  const T* none = nullptr;
  T* drop = nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t valid = n - row0 < TM ? n - row0 : TM;
  const int64_t hw = HEAD_FIXED + d.nb;
  const int h = d.h, o = d.o, dd = d.dd;
  for (int i = threadIdx.x; i < (d.l_max + 1) * d.n_ch; i += THREADS)
    mat_s[i] = mat[i];
  for (int i = threadIdx.x; i < d.n_ch; i += THREADS) sig_s[i] = sigma[i];
  // the forward's trunk input, as ref_dir_fwd_kernel builds it
  for (int idx = threadIdx.x; idx < TM * d.nb; idx += THREADS) {
    const int r = idx / d.nb;
    const int c = idx - r * d.nb;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < n) {
      v = heads[row * hw + HEAD_FIXED + c];
      if (noise != nullptr) v += to_f(noise[row * d.nb + c]);
    }
    xs[r * dd + c] = from_f<T>(v);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    const int64_t row = row0 + r;
    T* xr = xs + r * dd;
    if (row < n) {
      dir_glue(heads + row * hw, dirs + (row / per_ray) * 3, mat_s, sig_s, d,
               xr, tint_s + r * 3, diff_s + r * 3, nullptr, nullptr);
    } else {
      for (int c = d.nb; c < dd; ++c) xr[c] = from_f<T>(0.f);
      for (int k = 0; k < 3; ++k) tint_s[r * 3 + k] = diff_s[r * 3 + k] = 0.f;
    }
  }
  load_rows(s.a[7], o, row0, n, buf_a);   // z8
  __syncthreads();
  for (int idx = threadIdx.x; idx < valid * dd; idx += THREADS)
    xg[row0 * dd + idx] = xs[idx];
  narrow_head(buf_a, o, p.wh, p.bh, 3, true, spec_s, 3, 0, 0, TM);
  __syncthreads();
  // the tail: rgb = [srgb](spec tint + diff), spec = sigmoid(logit)
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const int64_t row = row0 + idx / 3;
    float dlg = 0.f, dt = 0.f, df = 0.f;
    if (row < n) {
      const float sp = spec_s[idx], ti = tint_s[idx];
      float g = grgb[row0 * 3 + idx];
      if (d.srgb) g = srgb_bwd(sp * ti + diff_s[idx], g);
      dt = g * sp;
      df = g;
      dlg = (g * ti) * (sp * (1.f - sp));
      dlog[row0 * 3 + idx] = dlg;
    }
    dtint_s[idx] = dt;
    ddiff_s[idx] = df;
    dlc[idx] = from_f<T>(dlg);
  }
  __syncthreads();
  delta_tile(dlc, 3, p.wh, o, s.a[7], none, none, buf_b, dl.d[7], row0, n, st);   // z8
  __syncthreads();
  delta_tile(buf_b, o, p.w7, o, s.a[6], none, none, buf_a, dl.d[6], row0, n, st); // z7
  __syncthreads();
  delta_tile(buf_a, o, p.w6, h, s.a[5], none, none, buf_b, dl.d[5], row0, n, st); // z6
  __syncthreads();
  delta_tile(buf_b, h, p.w5, h, s.a[4], none, none, buf_a, dl.d[4], row0, n, st); // z5
  __syncthreads();
  // the pullback of x: cd(d5 w4a^T) + cd(d1 w0^T), rounded after the add
  delta_tile(buf_a, h, p.w4a, dd, none, none, none, xs, drop, row0, n, st);
  __syncthreads();
  delta_tile(buf_a, h, p.w4b, h, s.a[3], none, none, buf_b, dl.d[3], row0, n, st); // h4
  __syncthreads();
  delta_tile(buf_b, h, p.w3, h, s.a[2], none, none, buf_a, dl.d[2], row0, n, st);  // h3
  __syncthreads();
  delta_tile(buf_a, h, p.w2, h, s.a[1], none, none, buf_b, dl.d[1], row0, n, st);  // h2
  __syncthreads();
  delta_tile(buf_b, h, p.w1, h, s.a[0], none, none, buf_a, dl.d[0], row0, n, st);  // h1
  __syncthreads();
  delta_tile<true>(buf_a, h, p.w0, dd, none, none, none, xs, drop, row0, n, st);
  __syncthreads();
  // d(heads): the bottleneck's pullback passes through, the glue per point
  for (int idx = threadIdx.x; idx < valid * d.nb; idx += THREADS) {
    const int r = idx / d.nb;
    const int c = idx - r * d.nb;
    dheads[(row0 + r) * hw + HEAD_FIXED + c] = to_f(xs[r * dd + c]);
  }
  for (int r = threadIdx.x; r < valid; r += THREADS) {
    const int64_t row = row0 + r;
    dir_glue_bwd(heads + row * hw, dirs + (row / per_ray) * 3, mat_s, sig_s,
                 d, xs + r * dd, gnrm + row * 3, gden[row], tint_s + r * 3,
                 diff_s + r * 3, dtint_s + r * 3, ddiff_s + r * 3,
                 dheads + row * hw);
  }
}

// dims: dx h o nb; acts: h1..h4 z5 z6 z7 inter; deltas: d1..d7 d8 g_rt g_nct
// g_bn; grads: the 23 f32 outputs in the order of the weight tuple
template <typename T>
int launch_spa_bwd(const void* x, const float* g, const uint64_t* acts,
                   const uint64_t* ptrs, int64_t n, const int* dims,
                   const uint64_t* deltas, float* partial, int splits,
                   int64_t rows_per_split, const uint64_t* grads,
                   cudaStream_t stream) {
  const RefSpaWeights<T> p = spa_weights<T>(ptrs);
  const Acts<T> s = acts_of<T>(acts);
  const Deltas<T> dl = deltas_of<T>(deltas, 11);
  const int dx = dims[0], h = dims[1], o = dims[2], nb = dims[3];
  const int maxw = h > o ? h : o;
  const size_t smem =
      ((size_t)TM * (11 + nb + 2 * maxw) + KC * stage_ld<T>()) * sizeof(T);
  int err = set_smem(ref_spa_delta_kernel<T>, smem);
  if (err != 0) return err;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + TM - 1) / TM);
    ref_spa_delta_kernel<T><<<grid, THREADS, smem, stream>>>(
        p, s, g, n, h, o, nb, maxw, dl);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int64_t sizes[23] = {
      (int64_t)dx * h, h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * h, h, (int64_t)dx * h, (int64_t)h * h, h, (int64_t)h * h,
      h, (int64_t)h * h, h, (int64_t)h * o, o, (int64_t)o * 2, 2,
      (int64_t)o * 9, 9, (int64_t)o * nb, nb};
  const GradPlan gp = plan_grads(sizes, 23, splits);
  WGradJobs jobs;
  jobs.n_jobs = 0;
  int tiles = 0;
  T* const* a = s.a;
  T* const* d = dl.d;
  add_job(jobs, tiles, gp, partial, x, dx, d[0], h, false, 0, 1);
  add_job(jobs, tiles, gp, partial, a[0], h, d[1], h, false, 2, 3);
  add_job(jobs, tiles, gp, partial, a[1], h, d[2], h, false, 4, 5);
  add_job(jobs, tiles, gp, partial, a[2], h, d[3], h, false, 6, 7);
  add_job(jobs, tiles, gp, partial, x, dx, d[4], h, false, 8, -1);
  add_job(jobs, tiles, gp, partial, a[3], h, d[4], h, false, 9, 10);
  add_job(jobs, tiles, gp, partial, a[4], h, d[5], h, false, 11, 12);
  add_job(jobs, tiles, gp, partial, a[5], h, d[6], h, false, 13, 14);
  add_job(jobs, tiles, gp, partial, a[6], h, d[7], o, false, 15, 16);
  add_job(jobs, tiles, gp, partial, a[7], o, d[8], 2, false, 17, 18);
  add_job(jobs, tiles, gp, partial, a[7], o, d[9], 9, false, 19, 20);
  add_job(jobs, tiles, gp, partial, a[7], o, d[10], nb, false, 21, 22);
  return launch_wgrad_reduce<T>(jobs, tiles, gp, partial, grads, n, splits,
                                rows_per_split, true, stream);
}

// dims: nb h o l_max n_ch use_srgb; acts: h1..h4 z5 z6 z7 z8; deltas:
// d1..d6 d7 d8; grads: the 19 f32 outputs in the order of the weight tuple
template <typename T>
int launch_dir_bwd(const void* heads, const void* noise, const void* dirs,
                   int64_t per_ray, const void* mat, const void* sigma,
                   const void* grgb, const void* gnrm, const void* gden,
                   const uint64_t* acts, const uint64_t* ptrs, int64_t n,
                   const int* dims, void* xg, const uint64_t* deltas,
                   float* dlog, float* dheads, float* partial, int splits,
                   int64_t rows_per_split, const uint64_t* grads,
                   cudaStream_t stream) {
  const RefDirWeights<T> p = dir_weights<T>(ptrs);
  const Acts<T> s = acts_of<T>(acts);
  const Deltas<T> dl = deltas_of<T>(deltas, 8);
  const DirDims d = dir_dims(dims);
  const int nf = ((d.l_max + 1) * d.n_ch + d.n_ch + 15 * TM + 3) & ~3;
  const size_t smem = (size_t)nf * sizeof(float)
      + ((size_t)TM * (d.dd + 2 * d.maxw + 4) + KC * stage_ld<T>())
      * sizeof(T);
  int err = set_smem(ref_dir_delta_kernel<T>, smem);
  if (err != 0) return err;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + TM - 1) / TM);
    ref_dir_delta_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const float*)heads, (const T*)noise, (const float*)dirs, per_ray,
        (const float*)mat, (const float*)sigma, (const float*)grgb,
        (const float*)gnrm, (const float*)gden, p, s, n, d, (T*)xg, dl, dlog,
        dheads);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int h = d.h, o = d.o, dd = d.dd;
  const int64_t sizes[19] = {
      (int64_t)dd * h, h, (int64_t)h * h, h, (int64_t)h * h, h,
      (int64_t)h * h, h, (int64_t)dd * h, (int64_t)h * h, h, (int64_t)h * h,
      h, (int64_t)h * o, o, (int64_t)o * o, o, (int64_t)o * 3, 3};
  const GradPlan gp = plan_grads(sizes, 19, splits);
  WGradJobs jobs;
  jobs.n_jobs = 0;
  int tiles = 0;
  T* const* a = s.a;
  T* const* t = dl.d;
  add_job(jobs, tiles, gp, partial, xg, dd, t[0], h, false, 0, 1);
  add_job(jobs, tiles, gp, partial, a[0], h, t[1], h, false, 2, 3);
  add_job(jobs, tiles, gp, partial, a[1], h, t[2], h, false, 4, 5);
  add_job(jobs, tiles, gp, partial, a[2], h, t[3], h, false, 6, 7);
  add_job(jobs, tiles, gp, partial, xg, dd, t[4], h, false, 8, -1);
  add_job(jobs, tiles, gp, partial, a[3], h, t[4], h, false, 9, 10);
  add_job(jobs, tiles, gp, partial, a[4], h, t[5], h, false, 11, 12);
  add_job(jobs, tiles, gp, partial, a[5], h, t[6], o, false, 13, 14);
  add_job(jobs, tiles, gp, partial, a[6], o, t[7], o, false, 15, 16);
  add_job(jobs, tiles, gp, partial, a[7], o, dlog, 3, true, 17, 18);
  return launch_wgrad_reduce<T>(jobs, tiles, gp, partial, grads, n, splits,
                                rows_per_split, true, stream);
}

}  // namespace

extern "C" {

#define REF_BWD(SUFFIX, T)                                                     \
  int ref_spa_bwd_##SUFFIX(const void* x, const void* g,                       \
                           const uint64_t* acts, const uint64_t* ptrs,         \
                           int64_t n, const int* dims,                         \
                           const uint64_t* deltas, void* partial, int splits,  \
                           int64_t rows_per_split, const uint64_t* grads,      \
                           void* stream) {                                     \
    return launch_spa_bwd<T>(x, (const float*)g, acts, ptrs, n, dims, deltas,  \
                             (float*)partial, splits, rows_per_split, grads,   \
                             (cudaStream_t)stream);                            \
  }                                                                            \
  int ref_dir_bwd_##SUFFIX(                                                    \
      const void* heads, const void* noise, const void* dirs, int64_t per_ray, \
      const void* mat, const void* sigma, const void* grgb, const void* gnrm,  \
      const void* gden, const uint64_t* acts, const uint64_t* ptrs, int64_t n, \
      const int* dims, void* xg, const uint64_t* deltas, void* dlog,           \
      void* dheads, void* partial, int splits, int64_t rows_per_split,         \
      const uint64_t* grads, void* stream) {                                   \
    return launch_dir_bwd<T>(heads, noise, dirs, per_ray, mat, sigma, grgb,    \
                             gnrm, gden, acts, ptrs, n, dims, xg, deltas,      \
                             (float*)dlog, (float*)dheads, (float*)partial,    \
                             splits, rows_per_split, grads,                    \
                             (cudaStream_t)stream);                            \
  }

REF_BWD(f32, float)
REF_BWD(bf16, __nv_bfloat16)

const char* ref_fused_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
