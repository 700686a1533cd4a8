// Device helpers shared by the bf16 tensor-core flash-attention kernels
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu), CUDA C++ for
// sm_90a: 128-byte swizzled shared-memory rows filled by cp.async,
// wgmma shared-memory descriptors, and warpgroup wgmma.mma_async
// m64n64k16 products with bf16 inputs and float32 accumulators.
//
// Layouts.  Every shared-memory tile is a stack of 128-byte rows (64 bf16,
// zero past the head dim) in the 128-byte swizzle: chunk c of row r sits at
// chunk c ^ (r % 8), and tiles start on 1024 bytes.  A 64 x 64 float32
// accumulator holds 32 values a thread: d[4 b + e] is row
// 16 warp + lane / 4 + 8 (e / 2), column 8 b + 2 (lane % 4) + e % 2.  The
// bf16 A fragment of a 16-deep register step is the same layout over two
// 8-column blocks, so an accumulator rounded to bf16, two columns a
// register (to_split_frags, sm90_bf16x3.cuh), is the A operand of the next
// product without a shuffle.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRowBytes = 128;  // one swizzled shared-memory row: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in 128-byte-swizzled rows.
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// 16 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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

// keep the compiler from moving accumulator registers across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define WGMMA_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (64x64, f32) (+)= A (64x16, smem, K-major) * B (16x64, smem, K-major);
// d is overwritten when accumulate == 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64x64, f32) += A (64x16, registers) * B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace sm90
