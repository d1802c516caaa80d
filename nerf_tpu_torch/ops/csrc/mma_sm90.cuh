// PTX primitives of the tensor-core bodies: 16-byte asynchronous copies into
// shared memory, ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulate)
// for the delta pass's narrow heads; and Hopper's warpgroup product
// wgmma.mma_async with its shared-memory matrix descriptors, the proxy
// fence, mbarriers and the TMA tensor copy, for the bf16 layer tile
// (mlp_tile.cuh's dense_tile), the delta pass's trunk layers (delta_tile)
// and the weight-grad pass (wgrad.cuh).  sm_90a only.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mlp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 blocks: thread t gets columns 2 (t % 4) and 2 (t % 4) + 1
// of row t / 4 of block i in r[i]; lanes 8 i .. 8 i + 7 give the row
// addresses of block i
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The shared-memory matrix descriptor of a K-major wgmma operand in the
// 32-byte swizzle (layout type 3): rows of one k-step (16 bf16 values, 32
// bytes), the 16-byte halves of rows 4-7 of every 8 swapped, each group of
// 8 rows ``sbo`` bytes after the last.  The k-step fills the swizzle's
// width, so the leading offset is not read (1, as CUTLASS sets it).  The
// start must lie on a 256-byte boundary (base offset 0).
__device__ __forceinline__ uint64_t wgmma_desc_sw32(uint32_t addr, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16)
      | ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}

// The shared-memory matrix descriptor of a wgmma operand in the 128-byte
// swizzle (layout type 1): start address, leading and stride byte offsets,
// each in 16-byte units.  For an MN-major (transposed) B operand the
// leading offset steps from one 64-column atom to the next and the stride
// offset from one group of 8 k rows to the next.  The start must lie in a
// 1024-byte-aligned pattern (base offset 0).  ``addr``: a shared-memory
// address (smem_addr).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, int lbo,
                                                     int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
      | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32)
      | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers of a wgmma's operands to this point of the program, so
// that the compiler moves no read of an accumulator above the wait that
// completes it (nor a write of an operand below the product that reads it).
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[t][e])::"memory");
}

__device__ __forceinline__ void wgmma_hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// d (the warpgroup's 64 x 32 f32 tile; this thread's 4 n-tiles of the
// mma.sync fragment layout: rows g and g + 8 of its warp's 16, columns
// 8 t + 2 q, + 1) = [d +] a @ b: a the warp's 16 x 16 bf16 rows in the
// registers (the mma.sync A fragment), b 16 x 32 bf16 in shared memory
// through ``desc``: MN-major with TRANS_B 1 (the transpose bit: the layer
// tile's W), K-major with 0 (the delta pass's W^T).  scale_d 0 starts from
// zero.  Asynchronous: complete it with wgmma_commit and wgmma_wait.
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(TRANS_B));
}

// d (the warpgroup's 64 x N f32 tile; this thread's N / 8 n-tiles of the
// mma.sync fragment layout, d[4 t + e] as wgmma_m64n32k16's d[t][e]) =
// [d +] a @ b with both operands in shared memory through descriptors
// (wgmma_desc_sw128): a 64 x 16 and b 16 x N bf16, N = 64 or 128, each
// MN-major with its transpose bit 1 (the weight-grad pass's chunks, points
// x columns, read as A^T and delta) or K-major with 0.  scale_d 0 starts
// from zero.  Asynchronous: complete it with wgmma_commit and wgmma_wait.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// Makes this thread's earlier writes to shared memory (st.shared, cp.async)
// visible to the async proxy that wgmma and TMA read and write through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory, each at shared-memory address ``bar``
// (smem_addr of a uint64_t): init (count arrivals a phase), invalidate
// (before the memory serves anything else), arrive, arrive while expecting
// ``bytes`` of asynchronous copies, and wait for the completion of the
// phase of parity ``parity`` (the n-th completion has parity n % 2).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at element coordinates (c, r) (column, row) of the 2-d
// tensor that the tensor map ``map`` describes (in kernel parameter,
// constant or global memory) into shared memory at address ``dst``,
// reported to the mbarrier at ``bar`` as complete transaction bytes.
// Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
        "r"(r) : "memory");
}

// TMA: the box at element coordinates (c, r, z) of the 3-d tensor that
// ``map`` describes into shared memory at ``dst``, as tma_load_2d.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c, int r,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
        "r"(r), "r"(z) : "memory");
}

// Fetches the TMA tensor map at generic address ``map`` (kernel parameter
// space) into the descriptor cache ahead of its first use.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// The bulk copy of ``bytes`` (a multiple of 16) from global ``src`` to
// shared memory at ``dst``, both 16-byte aligned, reported to the mbarrier
// at ``bar`` as complete transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Threads 0 .. count - 1 (whole warps) meet at named barrier ``id`` (1 to
// 15; __syncthreads is barrier 0).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace mlp
