// Float32 products on Hopper's bf16 tensor cores, shared by the
// flash-attention forward (flash_attention_sm90.cu) and backward
// (flash_attention_bwd_sm90.cu), CUDA C++ for sm_90a.
//
// A float32 operand x is split as x = hi + mid + lo, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid), exact for normal float32
// (8 + 8 + 8 significant bits; the subtractions are exact), and a product
// A B becomes the six bf16 products A_i B_j with i + j <= 2, smallest terms
// first.  The three terms left out are about 2^-24 of A B, float32's own
// rounding level: XLA's six-pass bf16 scheme for float32 dots at
// precision=HIGHEST.  bf16 and not TF32: wgmma reads TF32 operands K-major
// only, and the products whose B is MN-major (P V, dS K, P^T dO, dS^T Q)
// need a type the instruction transposes.  The helpers take the number of
// parts as a template argument; with one part they are the plain bf16
// products (an operand as it is, an accumulator rounded to bf16 once).
//
// split_bf16x3_kernel writes float32 operands, read through their strides,
// as three contiguous bf16 planes each, in one launch for up to four
// operands (the forward's q, k, v; the backward's q, k, v, dO).  Operands
// computed in registers (P, dS) are split by to_split_frags.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace sm90 {

constexpr int kSplitParts = 3;  // bf16 parts of a float32 operand
// a streamed tile: 64 swizzled rows of 128 bytes; the leading byte offset
// of an MN-major B operand
constexpr int kTileBytes = 64 * kRowBytes;

struct Strides {
  int64_t n, l, h;  // element strides of batch, position and head
  int64_t part;     // elements from one bf16 part to the next (split only)
};

// d = sum of A_i B_j^T over D for the parts i + j < kParts, smallest terms
// (largest i + j) first: A_i is 64 K-major rows at a + i a_part, B_j 64
// K-major rows at b + j b_part; D / 16 steps of 16 along the head dim,
// each 32 bytes on in the swizzled rows; 8-row groups 1024 bytes apart
template <int D, int kParts>
__device__ __forceinline__ void product_over_d(float (&d)[32], uint32_t a,
                                               uint32_t a_part, uint32_t b,
                                               uint32_t b_part) {
#pragma unroll
  for (int s = kParts - 1; s >= 0; --s)
#pragma unroll
    for (int i = s; i >= 0; --i)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(d, smem_desc(a + i * a_part + kk * 32, 0, 1024),
                 smem_desc(b + (s - i) * b_part + kk * 32, 0, 1024),
                 s != kParts - 1 || i != s || kk);
}

// d += sum of A_i B_j over 64 rows for the parts i + j < kParts, smallest
// terms first: A_i as four 16-deep register fragments, B_j 64 MN-major rows
// at b + j b_part (16 rows, 2048 bytes, a step), transposed by the
// instruction
template <int kParts>
__device__ __forceinline__ void product_over_rows(
    float (&d)[32], const uint32_t (&a)[kParts][4][4], uint32_t b,
    uint32_t b_part) {
#pragma unroll
  for (int s = kParts - 1; s >= 0; --s)
#pragma unroll
    for (int i = s; i >= 0; --i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(d, a[i][kk],
                 smem_desc(b + (s - i) * b_part + kk * 16 * kRowBytes,
                           kTileBytes, 1024));
}

// a 64 x 64 accumulator as the A fragments of four 16-deep register steps
// in kParts bf16 parts: part p is the bf16 rounding of what the parts
// before it leave of each value (with one part, the value rounded to bf16)
template <int kParts>
__device__ __forceinline__ void to_split_frags(
    const float (&d)[32], uint32_t (&frag)[kParts][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x = d[8 * kk + 2 * r], y = d[8 * kk + 2 * r + 1];
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const __nv_bfloat162 part = __floats2bfloat162_rn(x, y);
        frag[p][kk][r] = *reinterpret_cast<const uint32_t*>(&part);
        if (p + 1 < kParts) {
          x = __fsub_rn(x, __low2float(part));
          y = __fsub_rn(y, __high2float(part));
        }
      }
    }
}

// acc += sum of A_i B_j (product_over_rows).  With one part straight into
// acc; with split operands the tile's terms are summed from zero in `tile`
// and then added to acc in float32: the tensor cores' accumulation
// truncates, and an accumulator that takes thousands of terms over a long
// side (25600 queries: 400 tiles of 24 steps) drifts past float32's
// tolerance
template <int kParts>
__device__ __forceinline__ void add_product_over_rows(
    float (&acc)[32], float (&tile)[32], const uint32_t (&a)[kParts][4][4],
    uint32_t b, uint32_t b_part) {
  float(&d)[32] = kParts == 1 ? acc : tile;
  if constexpr (kParts > 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) tile[i] = 0.f;
  }
  fence_regs(d);
  wgmma_fence();
  product_over_rows<kParts>(d, a, b, b_part);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  if constexpr (kParts > 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += tile[i];
  }
}

// a shared-memory address the compiler cannot see through, with split
// operands: it would otherwise keep the loop-invariant descriptors of the
// owned tiles (all parts, every step) in registers across the tile loop,
// and spill; they cost a few integer operations a tile to rebuild
template <int kParts>
__device__ __forceinline__ uint32_t per_tile(uint32_t addr) {
  if constexpr (kParts > 1) asm volatile("" : "+r"(addr));
  return addr;
}

// The split: blockIdx.y picks an operand; a thread splits 4 neighbouring
// values of one (batch, position, head) row, read through the operand's
// strides, into its three contiguous bf16 planes.  Elementwise, bound by
// bytes: 4 bytes read and 6 written a value.
constexpr int kSplitThreads = 256;
constexpr int kSplitMaxOperands = 4;

struct SplitArgs {
  const float* src[kSplitMaxOperands];
  Strides s[kSplitMaxOperands];
  __nv_bfloat16* dst[kSplitMaxOperands];  // (3, N, len, H, D) contiguous
  int len[kSplitMaxOperands];
};

__global__ void __launch_bounds__(kSplitThreads)
split_bf16x3_kernel(SplitArgs a, int n, int heads, int d) {
  const int t = blockIdx.y;
  const int quads = d / 4;  // threads a row
  const int per_block = kSplitThreads / quads;
  const int len = a.len[t];
  const int rows = n * len * heads;
  const int row = blockIdx.x * per_block + threadIdx.x / quads;
  if (threadIdx.x >= per_block * quads || row >= rows) return;
  const int c = threadIdx.x % quads * 4;
  const int h = row % heads, l = row / heads % len, b = row / heads / len;
  const float* src = a.src[t] + b * a.s[t].n + l * a.s[t].l + h * a.s[t].h + c;
  __nv_bfloat16* dst = a.dst[t] + (int64_t)row * d + c;
  const int64_t plane = (int64_t)rows * d;
  float x[4] = {src[0], src[1], src[2], src[3]};
#pragma unroll
  for (int p = 0; p < kSplitParts; ++p) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(dst + p * plane) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
    x[0] = __fsub_rn(x[0], __low2float(lo));
    x[1] = __fsub_rn(x[1], __high2float(lo));
    x[2] = __fsub_rn(x[2], __low2float(hi));
    x[3] = __fsub_rn(x[3], __high2float(hi));
  }
}

// Launch the split of `count` float32 (N, len, H, D) operands src[t] (the
// head dim contiguous; `strides` holds three int64 element strides, batch,
// position and head, per operand) into dst[t], three contiguous bf16
// planes (3, N, len, H, D) each.  Returns the launch's cudaError_t.
inline int split_bf16x3(int count, const void* const* src, void* const* dst,
                        const int* lens, int n, int heads, int d,
                        const int64_t* strides, cudaStream_t stream) {
  if (count < 1 || count > kSplitMaxOperands || d % 4 ||
      d > 4 * kSplitThreads)
    return (int)cudaErrorInvalidValue;
  SplitArgs a{};
  int longest = 0;
  for (int t = 0; t < count; ++t) {
    a.src[t] = static_cast<const float*>(src[t]);
    a.s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2],
                     0};
    a.dst[t] = static_cast<__nv_bfloat16*>(dst[t]);
    a.len[t] = lens[t];
    longest = lens[t] > longest ? lens[t] : longest;
  }
  const int per_block = kSplitThreads / (d / 4);
  const dim3 grid((n * longest * heads + per_block - 1) / per_block, count);
  split_bf16x3_kernel<<<grid, kSplitThreads, 0, stream>>>(a, n, heads, d);
  return (int)cudaGetLastError();
}

// the strides of an operand's split planes: (3, N, len, H, D) contiguous
inline Strides plane_strides(int n, int len, int heads, int d) {
  const int64_t row = (int64_t)heads * d;
  return Strides{len * row, row, d, (int64_t)n * len * row};
}

}  // namespace sm90
