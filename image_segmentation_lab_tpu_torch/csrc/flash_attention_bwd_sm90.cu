// Flash-attention backward in bfloat16 on Hopper's tensor cores, CUDA C++
// for sm_90a: dQ and dK/dV.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernels
// image_segmentation_lab_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (called through _flash_backward).  Given q, k, v,
// the output gradient dO, the forward's row logsumexp lse and
// delta = rowsum(dO * O) (float32, computed outside the kernels, as
// _flash_backward computes it), per batch n and head h:
//   P  = exp(q k^T * scale - lse)     float32, recomputed tile by tile
//   dP = dO v^T                        float32
//   dS = P * (dP - delta) * scale      float32
//   dQ = dS k      with dS rounded to bf16       (flash_bwd_dq_sm90_kernel)
//   dV = P^T dO    with P rounded to bf16        (flash_bwd_dkv_sm90_kernel)
//   dK = dS^T q    with dS rounded to bf16       (flash_bwd_dkv_sm90_kernel)
// The products accumulate in float32 and are written in bf16, as in the
// TPU kernels; the roundings to bf16 are the conversions of P and dS into
// the register A operands of the wgmma products.  P and dS take the plain
// version's float32 steps (s * scale, - lse, expf; no fused multiply-add):
// a bf16 rounding of dS turns a last-bit difference in P into a whole bf16
// step of dS, so the kernels keep to the reference's roundings where they
// can and differ from it only in the products' order of summation.  Keys
// past Lk get P = 0; query rows past Lq contribute nothing (cp.async
// zero-fills their q and dO rows and P is forced to 0 there, so no 0 * NaN
// arises).  Lq != Lk is allowed.  float32 inputs go to the CUDA-core kernels of
// flash_attention_bwd.cu.  Two kernels, not one with atomics: each output
// tile has one owner, so the gradients are the same bits from run to run,
// for 7 products per score tile where a fused kernel with atomic dQ does 5.
//
// Layout: q, dO (N, Lq, H, D) and k, v (N, Lk, H, D) bf16, read through
// their (batch, position, head) strides with the head dim contiguous; every
// row starts on 16 bytes (the wrapper checks).  lse and delta are
// (N, H, Lq) float32; dQ, dK and dV are written as contiguous (N, L, H, D)
// bf16.  D is 32, 48 or 64.
//
// What bounds it on the card.  At SETR ViT-S/16's training shape (N=8,
// H=6, L=1601, D=64) each product over the score tiles is
// 2 N H L^2 D = 15.7 GFLOP: dQ does three (S, dP, dS K), 0.048 ms at the
// tensor cores' 989 TFLOP/s, dK/dV four (S^T, dP^T, P^T dO, dS^T Q),
// 0.064 ms, against about 10 MB of inputs and outputs (0.003 ms at
// 3.35 TB/s): both are bound by operations.  Each also takes N H L^2 =
// 1.23e8 exponentials (about 0.03 ms on the SFUs).  The design is the bf16
// forward's (flash_attention_sm90.cu), from sm90_wgmma.cuh:
//   * every product is a warpgroup wgmma.mma_async m64n64k16, bf16 in and
//     float32 out.  A CTA has two warpgroups of 128 threads, each owning 64
//     rows (128 per CTA) of the side it writes;
//   * dQ (flash_bwd_dq_sm90_kernel): Q and dO stay in shared memory; K and
//     V tiles of 64 keys come through a 2-stage cp.async ring.  Per tile:
//     S = Q K^T and dP = dO V^T (both operands from shared memory, K and V
//     read K-major), P and dS in registers, dS packed into bf16 A
//     fragments, dQ += dS K (K read MN-major, transposed by the
//     instruction).  Each thread keeps lse and delta of its two rows in
//     registers.  Three 64 x 64 float32 accumulators a thread: one CTA per
//     SM (at the 128 registers of two CTAs per SM the compiler spills);
//   * dK/dV (flash_bwd_dkv_sm90_kernel) works in the transposed
//     orientation, so that P^T and dS^T come out of the accumulators as
//     the A operands of the next products: K and V stay in shared memory;
//     Q and dO tiles of 64 queries, with the tile's lse and delta, come
//     through the ring.  Per tile: S^T = K Q^T and dP^T = V dO^T, P^T and
//     dS^T with lse and delta indexed by the accumulator's column (read
//     from shared memory), dV += P^T dO and dK += dS^T Q (dO and Q read
//     MN-major).  Four 64 x 64 float32 accumulators a thread, so one CTA
//     per SM;
//   * every shared-memory row is 128 bytes in the 128-byte swizzle, zero
//     past D: the products over D read D / 16 steps, the products whose N
//     is D read all 64 columns, and the columns past D are never written.
// No score, probability or dS tile reaches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // rows a CTA owns, 64 per warpgroup
constexpr int kBlockN = 64;   // rows of a streamed tile
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kOwnBytes = kBlockM * kRowBytes;   // 16 KB, each of two
constexpr int kTileBytes = kBlockN * kRowBytes;  // 8 KB, each of two
constexpr int kRowsBytes = 2 * kBlockN * 4;      // a tile's lse and delta
// +1024: the swizzle needs 1024-byte aligned tiles
constexpr int kDqSmemBytes = 1024 + 2 * kOwnBytes + kStages * 2 * kTileBytes;
constexpr int kDkvSmemBytes = kDqSmemBytes + kStages * kRowsBytes;

struct Strides {
  int64_t n, l, h;  // element strides of batch, position and head
};

// 4 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// P = exp(s * scale - lse) and dS = P (dP - delta) scale, each step
// rounded as the plain version rounds it (no contraction into an fma)
__device__ __forceinline__ float p_of(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

__device__ __forceinline__ float ds_of(float p, float dp, float delta,
                                       float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// the dynamic shared memory, rounded up to 1024 bytes
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// zero the 16-byte chunks past D of `rows` shared rows once: no copy ever
// writes them, and the products whose N is D read all 64 columns
template <int D>
__device__ __forceinline__ void zero_row_tails(uint8_t* smem, int rows) {
  constexpr int kChunks = D / 8;
  if constexpr (kChunks < 8) {
    constexpr int kPad = 8 - kChunks;
    for (int i = threadIdx.x; i < rows * kPad; i += kThreads) {
      const int r = i / kPad, c = kChunks + i % kPad;
      *reinterpret_cast<uint4*>(smem + swizzle(r, c)) = make_uint4(0, 0, 0, 0);
    }
  }
}

// `rows` rows from row0 of one (batch, head) slice into swizzled shared
// rows at dst; rows past len are zero
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t ld, int row0, int rows,
                                          int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool in = row < len;
    cp_async16(dst + swizzle(r, c), src + (in ? row : 0) * ld + c * 8, in);
  }
}

// this thread's rows (16 warp + lane / 4 and 8 below) of a warpgroup's
// 64 x 64 accumulator into a contiguous (N, L, H, D) bf16 output
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[32], int n,
                                           int head, int heads, int r0,
                                           int len) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= len) continue;
    __nv_bfloat16* o_row = out + (((int64_t)n * len + row) * heads + head) * D;
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * b + 2 * quad) =
          __floats2bfloat162_rn(acc[4 * b + 2 * i], acc[4 * b + 2 * i + 1]);
  }
}

// d = A B^T over D: A is 64 K-major rows at a, B 64 K-major rows at b;
// D / 16 steps of 16 along the head dim, each 32 bytes on in the swizzled
// rows; 8-row groups 1024 bytes apart
template <int D>
__device__ __forceinline__ void product_over_d(float (&d)[32], uint32_t a,
                                               uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(d, smem_desc(a + kk * 32, 0, 1024),
             smem_desc(b + kk * 32, 0, 1024), kk);
}

// d += A B over 64 rows: A as four 16-deep register fragments, B 64
// MN-major rows at b (16 rows, 2048 bytes, a step), transposed by the
// instruction
__device__ __forceinline__ void product_over_rows(float (&d)[32],
                                                  const uint32_t (&a)[4][4],
                                                  uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[kk], smem_desc(b + kk * 16 * kRowBytes, kTileBytes, 1024));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int heads, int lq,
                         int lk, Strides qs, Strides ks, Strides vs,
                         Strides dos, float scale) {
  static_assert(D % 16 == 0 && D <= 64, "D is 32, 48 or 64");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // rows of 128 bytes: Q (128), dO (128), then per stage K (64), V (64)
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + kOwnBytes;
  const uint32_t kv_s = do_s + kOwnBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: query rows 64 wg .. 64 wg + 63
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const __nv_bfloat16* kb = k + n * ks.n + head * ks.h;
  const __nv_bfloat16* vb = v + n * vs.n + head * vs.h;

  zero_row_tails<D>(smem, 2 * kBlockM + kStages * 2 * kBlockN);
  // Q and dO once; rows past lq are zero and never written back
  load_rows<D>(q_s, q + n * qs.n + head * qs.h, qs.l, q0, kBlockM, lq);
  load_rows<D>(do_s, dout + n * dos.n + head * dos.h, dos.l, q0, kBlockM,
               lq);
  auto load_kv = [&](int tile, int stage) {
    const uint32_t k_dst = kv_s + stage * 2 * kTileBytes;
    load_rows<D>(k_dst, kb, ks.l, tile * kBlockN, kBlockN, lk);
    load_rows<D>(k_dst + kTileBytes, vb, vs.l, tile * kBlockN, kBlockN, lk);
  };
  load_kv(0, 0);
  cp_async_commit();

  // lse and delta of rows r0 and r0 + 8 of this thread
  const int r0 = q0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int64_t rows = ((int64_t)n * heads + head) * lq;
  float row_lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = r0 + 8 * i < lq;
    row_lse[i] = in ? lse[rows + r0 + 8 * i] : 0.f;
    dlt[i] = in ? delta[rows + r0 + 8 * i] : 0.f;
  }

  float s_acc[32], dp_acc[32], dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
  const uint32_t do_wg = do_s + wg * 64 * kRowBytes;
  const int tiles = (lk + kBlockN - 1) / kBlockN;

  for (int j = 0; j < tiles; ++j) {
    const int stage = j % kStages;
    // tile j + 1 into the other stage, freed at the end of iteration j - 1
    if (j + 1 < tiles) load_kv(j + 1, (j + 1) % kStages);
    cp_async_commit();    // (an empty group on the last tile)
    cp_async_wait_one();  // everything but tile j + 1 has landed
    fence_async_shared();
    __syncthreads();

    const uint32_t k_tile = kv_s + stage * 2 * kTileBytes;
    const uint32_t v_tile = k_tile + kTileBytes;

    // S = Q K^T and dP = dO V^T
    fence_regs(s_acc);
    fence_regs(dp_acc);
    wgmma_fence();
    product_over_d<D>(s_acc, q_wg, k_tile);
    product_over_d<D>(dp_acc, do_wg, v_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);
    fence_regs(dp_acc);

    // P and dS; s_acc[4 b + e] is row r0 + 8 (e / 2), key column
    // 8 b + 2 quad + e % 2 of the tile
    const int k0 = j * kBlockN;
    const bool ragged = k0 + kBlockN > lk;
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * b + e;
        float p = p_of(s_acc[i], scale, row_lse[e >> 1]);
        if (ragged && k0 + 8 * b + 2 * quad + (e & 1) >= lk) p = 0.f;
        s_acc[i] = ds_of(p, dp_acc[i], dlt[e >> 1], scale);
      }
    uint32_t ds_frag[4][4];
    to_a_frags(s_acc, ds_frag);  // dS in bf16

    // dQ += dS K
    fence_regs(dq_acc);
    wgmma_fence();
    product_over_rows(dq_acc, ds_frag, k_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    __syncthreads();  // both warpgroups are done with this stage
  }
  store_rows<D>(dq, dq_acc, n, head, heads, r0, lq);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int heads, int lq,
                          int lk, Strides qs, Strides ks, Strides vs,
                          Strides dos, float scale) {
  static_assert(D % 16 == 0 && D <= 64, "D is 32, 48 or 64");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // rows of 128 bytes: K (128), V (128), then per stage Q (64), dO (64);
  // then per stage the tile's lse (64 floats) and delta (64 floats)
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + kOwnBytes;
  const uint32_t qdo_s = v_s + kOwnBytes;
  const float* rows_s =
      reinterpret_cast<const float*>(smem + 2 * kOwnBytes +
                                     kStages * 2 * kTileBytes);

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: key rows 64 wg .. 64 wg + 63
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int k0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const __nv_bfloat16* qb = q + n * qs.n + head * qs.h;
  const __nv_bfloat16* dob = dout + n * dos.n + head * dos.h;
  const int64_t rows = ((int64_t)n * heads + head) * lq;

  zero_row_tails<D>(smem, 2 * kBlockM + kStages * 2 * kBlockN);
  // K and V once; key rows past lk are zero and never written back
  load_rows<D>(k_s, k + n * ks.n + head * ks.h, ks.l, k0, kBlockM, lk);
  load_rows<D>(v_s, v + n * vs.n + head * vs.h, vs.l, k0, kBlockM, lk);
  auto load_qdo = [&](int tile, int stage) {
    const uint32_t q_dst = qdo_s + stage * 2 * kTileBytes;
    const int t0 = tile * kBlockN;
    load_rows<D>(q_dst, qb, qs.l, t0, kBlockN, lq);
    load_rows<D>(q_dst + kTileBytes, dob, dos.l, t0, kBlockN, lq);
    if (tid < 2 * kBlockN) {  // lse (threads 0-63), delta (64-127)
      const int c = tid % kBlockN;
      const bool in = t0 + c < lq;
      const float* src =
          (tid < kBlockN ? lse : delta) + rows + (in ? t0 + c : 0);
      cp_async4(smem_u32(rows_s + stage * 2 * kBlockN + tid), src, in);
    }
  };
  load_qdo(0, 0);
  cp_async_commit();

  float st_acc[32], dpt_acc[32], dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_wg = k_s + wg * 64 * kRowBytes;
  const uint32_t v_wg = v_s + wg * 64 * kRowBytes;
  const int tiles = (lq + kBlockN - 1) / kBlockN;

  for (int j = 0; j < tiles; ++j) {
    const int stage = j % kStages;
    // tile j + 1 into the other stage, freed at the end of iteration j - 1
    if (j + 1 < tiles) load_qdo(j + 1, (j + 1) % kStages);
    cp_async_commit();    // (an empty group on the last tile)
    cp_async_wait_one();  // everything but tile j + 1 has landed
    fence_async_shared();
    __syncthreads();

    const uint32_t q_tile = qdo_s + stage * 2 * kTileBytes;
    const uint32_t do_tile = q_tile + kTileBytes;
    const float* lse_t = rows_s + stage * 2 * kBlockN;
    const float* dlt_t = lse_t + kBlockN;

    // S^T = K Q^T and dP^T = V dO^T
    fence_regs(st_acc);
    fence_regs(dpt_acc);
    wgmma_fence();
    product_over_d<D>(st_acc, k_wg, q_tile);
    product_over_d<D>(dpt_acc, v_wg, do_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st_acc);
    fence_regs(dpt_acc);

    // P^T and dS^T; st_acc[4 b + e] is key row 16 warp + lane / 4 +
    // 8 (e / 2), query column 8 b + 2 quad + e % 2 of the tile
    const int t0 = j * kBlockN;
    const bool ragged = t0 + kBlockN > lq;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = 8 * b + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * b + e;
        const float lse_c = (e & 1) ? l2.y : l2.x;
        const float dlt_c = (e & 1) ? d2.y : d2.x;
        float p = p_of(st_acc[i], scale, lse_c);
        if (ragged && t0 + col + (e & 1) >= lq) p = 0.f;
        st_acc[i] = p;
        dpt_acc[i] = ds_of(p, dpt_acc[i], dlt_c, scale);
      }
    }
    uint32_t p_frag[4][4], ds_frag[4][4];
    to_a_frags(st_acc, p_frag);    // P^T in bf16
    to_a_frags(dpt_acc, ds_frag);  // dS^T in bf16

    // dV += P^T dO and dK += dS^T Q
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    product_over_rows(dv_acc, p_frag, do_tile);
    product_over_rows(dk_acc, ds_frag, q_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // both warpgroups are done with this stage
  }
  const int r0 = k0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  store_rows<D>(dk, dk_acc, n, head, heads, r0, lk);
  store_rows<D>(dv, dv_acc, n, head, heads, r0, lk);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int n,
              int heads, int lq, int lk, const Strides* s, float scale,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBlockM - 1) / kBlockM, heads, n);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), heads, lq, lk, s[0], s[1], s[2], s[3],
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int n, int heads, int lq, int lk, const Strides* s,
               float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lk + kBlockM - 1) / kBlockM, heads, n);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      heads, lq, lk, s[0], s[1], s[2], s[3], scale);
  return (int)cudaGetLastError();
}

void read_strides(const int64_t* strides, Strides* s) {
  for (int t = 0; t < 4; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `strides` is a host array of twelve int64 element strides (batch,
// position, head) of q, k, v and dO, each a multiple of 8, and the four
// start on 16 bytes.  Every entry returns the cudaError_t of the launch
// (0 on success).  Head dims 32, 48, 64.
extern "C" {

int flash_attention_backward_dq_sm90_bf16(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse,
                                          const float* delta, void* dq, int n,
                                          int heads, int lq, int lk, int d,
                                          const int64_t* strides, float scale,
                                          void* stream) {
  Strides s[4];
  read_strides(strides, s);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, dq, n, heads, lq, lk,
                           s, scale, st);
    case 48:
      return launch_dq<48>(q, k, v, dout, lse, delta, dq, n, heads, lq, lk,
                           s, scale, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, n, heads, lq, lk,
                           s, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int flash_attention_backward_dkv_sm90_bf16(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* delta, void* dk,
                                           void* dv, int n, int heads, int lq,
                                           int lk, int d,
                                           const int64_t* strides,
                                           float scale, void* stream) {
  Strides s[4];
  read_strides(strides, s);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, n, heads, lq,
                            lk, s, scale, st);
    case 48:
      return launch_dkv<48>(q, k, v, dout, lse, delta, dk, dv, n, heads, lq,
                            lk, s, scale, st);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, n, heads, lq,
                            lk, s, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_backward_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
