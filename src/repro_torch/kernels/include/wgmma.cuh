// Hopper tensor-core helpers shared by the bf16 routes of the flash
// prefill kernel (flash_attention.cu) and the SSD scan (ssd_scan.cu):
// tiles in shared memory as 128-byte swizzled panels filled by cp.async,
// wgmma shared-memory descriptors, and wgmma.mma_async m64n64k16 (bf16 in,
// fp32 accumulate) with A from shared memory or from registers.
//
// Tile layout.  A tile of R rows and a multiple of 64 bf16 columns is
// stored as panels of 64 columns, each panel R rows of 128 bytes, the
// 16-byte chunk c of row r at chunk c ^ (r % 8) of its row: the layout
// wgmma's 128B-swizzle descriptors read without bank conflicts.  A
// panel's base must be 1024-byte aligned, and so must every offset of a
// descriptor into it (an 8-row group is 1024 bytes).
//
// Reading a tile as an operand.  K-major (the K index runs along the
// row): step kk of 16 columns starts at panel kk / 4, byte (kk % 4) * 32,
// desc(addr, 16, 1024).  MN-major (the K index runs down the rows, the
// transpose bit set): step kk of 16 rows starts at byte 16 * kk * 128 of
// the panel, desc(addr, 1024, 1024), and spans the panel's 64 columns.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of swizzled panels of
// kRows rows
template <int kRows>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * (kRows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// makes this thread's generic-proxy writes to shared memory (st.shared,
// and cp.async once waited for) visible to wgmma's async proxy; a barrier
// after it makes them visible to the whole block
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + kRows) of an [S, D] slice (row stride ld) into the
// swizzled panels at dst, by the block's kThreads threads; rows >= S and
// columns in [D, D16) are zero-filled.  D and D16 are multiples of 8,
// the rows 16-byte aligned.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int S, int D,
                                          int D16) {
  const int nc = D16 / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    const bool ok = r0 + r < S && c * 8 < D;
    cp_async16(dst + swizzled<kRows>(r, c),
               ok ? src + (long long)(r0 + r) * ld + c * 8 : src, ok);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of d across the async window
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B in shared memory: K-major, or MN-major
// where kTransA / kTransB is 1
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d += A B, m64n64k16, A in registers, B MN-major in shared memory
// (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The m64n64 fp32 accumulator fragment: thread (warp w of its
// warpgroup, lane) holds rows frag_row(i) = 16 w + lane / 4 (+ 8 for the
// odd pairs) at columns frag_col(i) = 8 (i / 4) + 2 (lane % 4) + i % 2,
// i = 0 .. 31.  The fragment of columns 16 kk .. 16 kk + 15, packed by
// pairs to bf16, is the register A fragment of step kk of a product
// whose K runs along those columns.
__device__ __forceinline__ int frag_row(int i, int warp, int lane) {
  return warp * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

}  // namespace wg
