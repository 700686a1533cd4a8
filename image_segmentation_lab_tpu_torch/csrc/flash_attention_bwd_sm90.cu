// Flash-attention backward on Hopper's tensor cores, CUDA C++ for sm_90a:
// dQ and dK/dV, in bfloat16 and in float32.
//
// Replaces the Pallas TPU kernels
// image_segmentation_lab_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (called through _flash_backward).  Given q, k, v,
// the output gradient dO, the forward's row logsumexp lse and
// delta = rowsum(dO * O) (float32, computed outside the kernels, as
// _flash_backward computes it), per batch n and head h:
//   P  = exp(q k^T * scale - lse)     float32, recomputed tile by tile
//   dP = dO v^T                        float32
//   dS = P * (dP - delta) * scale      float32
//   dQ = dS k                          (the dQ kernel)
//   dV = P^T dO,  dK = dS^T q          (the dK/dV kernel)
// Every product is a warpgroup wgmma.mma_async m64n64k16 with bf16
// operands and float32 accumulators.  The two types differ only in the
// number of bf16 parts (kParts) an operand is made of:
//   * bfloat16 (flash_bwd_dq_sm90_kernel, flash_bwd_dkv_sm90_kernel), one
//     part: q, k, v and dO as they are; P and dS are rounded to bf16 where
//     they become the A operand of the next product, and the outputs are
//     written in bf16, as in the TPU kernels;
//   * float32 (flash_bwd_dq_bf16x3_kernel, flash_bwd_dkv_bf16x3_kernel),
//     three parts: each float32 operand is split into three bf16 parts and
//     each product taken as six bf16 products (sm90_bf16x3.cuh, shared with
//     the float32 forward).  split_bf16x3_kernel (launched through the
//     forward's library) writes q, k, v and dO as three contiguous bf16
//     planes each, once per backward call for both kernels; P and dS are
//     split in registers, and the outputs are written in float32.
// P and dS take the plain version's float32 steps (s * scale, - lse, expf;
// no fused multiply-add): a bf16 rounding of dS turns a last-bit
// difference in P into a whole bf16 step of dS, so the kernels keep to the
// reference's roundings where they can and differ from it only in the
// products' order of summation.  Keys past Lk get P = 0; query rows past
// Lq contribute nothing (cp.async zero-fills their q and dO rows and P is
// forced to 0 there, so no 0 * NaN arises).  Lq != Lk is allowed.  Two
// kernels, not one with atomics: each output tile has one owner, so the
// gradients are the same bits from run to run, for 7 products per score
// tile where a fused kernel with atomic dQ does 5.
//
// Layout: bf16 q, dO (N, Lq, H, D) and k, v (N, Lk, H, D) are read through
// their (batch, position, head) strides with the head dim contiguous; every
// row starts on 16 bytes (the wrapper checks).  float32 q, k, v and dO are
// read the same way by the split, whose planes (3, N, L, H, D) are
// contiguous.  lse and delta are (N, H, Lq) float32; dQ, dK and dV are
// written as contiguous (N, L, H, D) tensors of the inputs' type.  D is 32,
// 48 or 64.
//
// What bounds it on the card.  At SETR ViT-S/16's training shape (N=8,
// H=6, L=1601, D=64) each product over the score tiles is
// 2 N H L^2 D = 15.7 GFLOP: dQ does three (S, dP, dS K), dK/dV four (S^T,
// dP^T, P^T dO, dS^T Q).  In bf16 that is 0.048 and 0.064 ms at the tensor
// cores' 989 TFLOP/s against about 10 MB of inputs and outputs (0.003 ms
// at 3.35 TB/s); in float32 six times the bf16 work, 0.29 and 0.38 ms,
// where the CUDA cores' 67 TFLOP/s would take 0.70 and 0.94 ms.  All are
// bound by operations.  Each kernel also takes N H L^2 = 1.23e8
// exponentials (about 0.03 ms on the SFUs).  The design is the bf16
// forward's (flash_attention_sm90.cu), from sm90_wgmma.cuh and
// sm90_bf16x3.cuh:
//   * a CTA has two warpgroups of 128 threads, each owning 64 rows (128 per
//     CTA) of the side it writes;
//   * dQ (flash_bwd_dq_*): Q and dO stay in shared memory; K and V tiles
//     of 64 keys come through a 2-stage cp.async ring.  Per tile: S = Q K^T
//     and dP = dO V^T (both operands from shared memory, K and V read
//     K-major), P and dS in registers, dS packed into bf16 A fragments,
//     dQ += dS K (K read MN-major, transposed by the instruction).  Each
//     thread keeps lse and delta of its two rows in registers.  Three
//     64 x 64 float32 accumulators a thread: one CTA per SM (at the 128
//     registers of two CTAs per SM the compiler spills);
//   * dK/dV (flash_bwd_dkv_*) works in the transposed orientation, so that
//     P^T and dS^T come out of the accumulators as the A operands of the
//     next products: K and V stay in shared memory; Q and dO tiles of 64
//     queries, with the tile's lse and delta, come through the ring.  Per
//     tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T with lse and delta
//     indexed by the accumulator's column (read from shared memory),
//     dV += P^T dO and dK += dS^T Q (dO and Q read MN-major).  Four 64 x 64
//     float32 accumulators a thread, so one CTA per SM;
//   * each part of an operand is a tile of its own in shared memory: with
//     three parts the owned operands take 2 x 3 x 16 KB and the ring
//     2 stages x 2 operands x 3 x 8 KB, 193 KB of the 227 (65 KB in bf16).
//     With split operands a tile's products into dQ, dK or dV are summed
//     from zero in the score accumulator the tile has freed and then added
//     in float32 (add_product_over_rows), and the dK/dV kernel takes dV's
//     products, then dK's, through one set of three-part fragments;
//   * every shared-memory row is 128 bytes in the 128-byte swizzle, zero
//     past D: the products over D read D / 16 steps, the products whose N
//     is D read all 64 columns, and the columns past D are never written.
// No score, probability or dS tile reaches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_bf16x3.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // rows a CTA owns, 64 per warpgroup
constexpr int kBlockN = 64;   // rows of a streamed tile
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kOwnBytes = kBlockM * kRowBytes;  // 16 KB, each of two
constexpr int kRowsBytes = 2 * kBlockN * 4;     // a tile's lse and delta
static_assert(kBlockN * kRowBytes == kTileBytes, "8 KB tiles, each of two");

// +1024: the swizzle needs 1024-byte aligned tiles
template <int kParts>
constexpr int dq_smem_bytes() {
  return 1024 + kParts * (2 * kOwnBytes + kStages * 2 * kTileBytes);
}

template <int kParts>
constexpr int dkv_smem_bytes() {
  return dq_smem_bytes<kParts>() + kStages * kRowsBytes;
}

// the output type: bf16 for bf16 inputs, float32 for split float32 ones
template <int kParts>
using Out = std::conditional_t<kParts == 1, __nv_bfloat16, float>;

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

// `rows` rows from row0 of one (batch, head) slice, each of its kParts
// parts, into swizzled shared rows: part p at dst + p * part_bytes; rows
// past len are zero
template <int D, int kParts>
__device__ __forceinline__ void load_rows(uint32_t dst, int part_bytes,
                                          const __nv_bfloat16* src,
                                          const Strides& s, int row0,
                                          int rows, int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int row = row0 + r;
      const bool in = row < len;
      cp_async16(dst + p * part_bytes + swizzle(r, c),
                 src + p * s.part + (in ? row : 0) * s.l + c * 8, in);
    }
}

// this thread's rows (16 warp + lane / 4 and 8 below) of a warpgroup's
// 64 x 64 accumulator into a contiguous (N, L, H, D) output
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[32],
                                           int n, int head, int heads,
                                           int r0, int len) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= len) continue;
    T* o_row = out + (((int64_t)n * len + row) * heads + head) * D;
#pragma unroll
    for (int b = 0; b < D / 8; ++b) {
      const float x = acc[4 * b + 2 * i], y = acc[4 * b + 2 * i + 1];
      if constexpr (std::is_same_v<T, float>)
        *reinterpret_cast<float2*>(o_row + 8 * b + 2 * quad) =
            make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * b + 2 * quad) =
            __floats2bfloat162_rn(x, y);
    }
  }
}

// the dQ kernel's body, for operands of kParts bf16 parts
template <int D, int kParts>
__device__ __forceinline__ void dq_body(
    uint8_t* smem_raw, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Out<kParts>* __restrict__ dq, int heads,
    int lq, int lk, const Strides& qs, const Strides& ks, const Strides& vs,
    const Strides& dos, float scale) {
  static_assert(D % 16 == 0 && D <= 64, "D is 32, 48 or 64");
  constexpr int kStageBytes = 2 * kParts * kTileBytes;
  uint8_t* smem = aligned_smem(smem_raw);
  // rows of 128 bytes, kParts tiles of each: Q (128 rows), dO (128), then
  // per stage K (64), V (64)
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + kParts * kOwnBytes;
  const uint32_t kv_s = do_s + kParts * kOwnBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: query rows 64 wg .. 64 wg + 63
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const __nv_bfloat16* kb = k + n * ks.n + head * ks.h;
  const __nv_bfloat16* vb = v + n * vs.n + head * vs.h;

  zero_row_tails<D>(smem, kParts * (2 * kBlockM + kStages * 2 * kBlockN));
  // Q and dO once; rows past lq are zero and never written back
  load_rows<D, kParts>(q_s, kOwnBytes, q + n * qs.n + head * qs.h, qs, q0,
                       kBlockM, lq);
  load_rows<D, kParts>(do_s, kOwnBytes, dout + n * dos.n + head * dos.h,
                       dos, q0, kBlockM, lq);
  auto load_kv = [&](int tile, int stage) {
    const uint32_t k_dst = kv_s + stage * kStageBytes;
    load_rows<D, kParts>(k_dst, kTileBytes, kb, ks, tile * kBlockN, kBlockN,
                         lk);
    load_rows<D, kParts>(k_dst + kParts * kTileBytes, kTileBytes, vb, vs,
                         tile * kBlockN, kBlockN, lk);
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

    const uint32_t k_tile = kv_s + stage * kStageBytes;
    const uint32_t v_tile = k_tile + kParts * kTileBytes;

    // S = Q K^T and dP = dO V^T
    fence_regs(s_acc);
    fence_regs(dp_acc);
    wgmma_fence();
    product_over_d<D, kParts>(s_acc, per_tile<kParts>(q_wg), kOwnBytes,
                              k_tile, kTileBytes);
    product_over_d<D, kParts>(dp_acc, per_tile<kParts>(do_wg), kOwnBytes,
                              v_tile, kTileBytes);
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
    uint32_t ds_frag[kParts][4][4];
    to_split_frags(s_acc, ds_frag);  // dS in bf16 parts

    // dQ += dS K (split: the tile's sum in s_acc, free now)
    add_product_over_rows(dq_acc, s_acc, ds_frag, k_tile, kTileBytes);
    __syncthreads();  // both warpgroups are done with this stage
  }
  store_rows<D>(dq, dq_acc, n, head, heads, r0, lq);
}

// the dK/dV kernel's body, for operands of kParts bf16 parts
template <int D, int kParts>
__device__ __forceinline__ void dkv_body(
    uint8_t* smem_raw, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Out<kParts>* __restrict__ dk,
    Out<kParts>* __restrict__ dv, int heads, int lq, int lk,
    const Strides& qs, const Strides& ks, const Strides& vs,
    const Strides& dos, float scale) {
  static_assert(D % 16 == 0 && D <= 64, "D is 32, 48 or 64");
  constexpr int kStageBytes = 2 * kParts * kTileBytes;
  uint8_t* smem = aligned_smem(smem_raw);
  // rows of 128 bytes, kParts tiles of each: K (128 rows), V (128), then per
  // stage Q (64), dO (64); then per stage the tile's lse (64 floats) and
  // delta (64 floats)
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + kParts * kOwnBytes;
  const uint32_t qdo_s = v_s + kParts * kOwnBytes;
  const float* rows_s = reinterpret_cast<const float*>(
      smem + kParts * (2 * kOwnBytes + kStages * 2 * kTileBytes));

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

  zero_row_tails<D>(smem, kParts * (2 * kBlockM + kStages * 2 * kBlockN));
  // K and V once; key rows past lk are zero and never written back
  load_rows<D, kParts>(k_s, kOwnBytes, k + n * ks.n + head * ks.h, ks, k0,
                       kBlockM, lk);
  load_rows<D, kParts>(v_s, kOwnBytes, v + n * vs.n + head * vs.h, vs, k0,
                       kBlockM, lk);
  auto load_qdo = [&](int tile, int stage) {
    const uint32_t q_dst = qdo_s + stage * kStageBytes;
    const int t0 = tile * kBlockN;
    load_rows<D, kParts>(q_dst, kTileBytes, qb, qs, t0, kBlockN, lq);
    load_rows<D, kParts>(q_dst + kParts * kTileBytes, kTileBytes, dob, dos,
                         t0, kBlockN, lq);
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

    const uint32_t q_tile = qdo_s + stage * kStageBytes;
    const uint32_t do_tile = q_tile + kParts * kTileBytes;
    const float* lse_t = rows_s + stage * 2 * kBlockN;
    const float* dlt_t = lse_t + kBlockN;

    // S^T = K Q^T and dP^T = V dO^T
    fence_regs(st_acc);
    fence_regs(dpt_acc);
    wgmma_fence();
    product_over_d<D, kParts>(st_acc, per_tile<kParts>(k_wg), kOwnBytes,
                              q_tile, kTileBytes);
    product_over_d<D, kParts>(dpt_acc, per_tile<kParts>(v_wg), kOwnBytes,
                              do_tile, kTileBytes);
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
    if constexpr (kParts == 1) {
      uint32_t p_frag[1][4][4], ds_frag[1][4][4];
      to_split_frags(st_acc, p_frag);    // P^T in bf16
      to_split_frags(dpt_acc, ds_frag);  // dS^T in bf16

      // dV += P^T dO and dK += dS^T Q, in one group
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      product_over_rows<1>(dv_acc, p_frag, do_tile, kTileBytes);
      product_over_rows<1>(dk_acc, ds_frag, q_tile, kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    } else {
      // one after the other through one set of three-part fragments, each
      // tile's sum in the score accumulator it came from: the registers of
      // both products at once would spill
      uint32_t frag[kParts][4][4];
      to_split_frags(st_acc, frag);  // P^T in bf16 parts
      add_product_over_rows(dv_acc, st_acc, frag, do_tile, kTileBytes);
      to_split_frags(dpt_acc, frag);  // dS^T in bf16 parts
      add_product_over_rows(dk_acc, dpt_acc, frag, q_tile, kTileBytes);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }
  const int r0 = k0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  store_rows<D>(dk, dk_acc, n, head, heads, r0, lk);
  store_rows<D>(dv, dv_acc, n, head, heads, r0, lk);
}

// bf16 inputs and outputs
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
  extern __shared__ uint8_t smem_raw[];
  dq_body<D, 1>(smem_raw, q, k, v, dout, lse, delta, dq, heads, lq, lk, qs,
                ks, vs, dos, scale);
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
  extern __shared__ uint8_t smem_raw[];
  dkv_body<D, 1>(smem_raw, q, k, v, dout, lse, delta, dk, dv, heads, lq, lk,
                 qs, ks, vs, dos, scale);
}

// float32 inputs as three bf16 planes each, float32 outputs
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16x3_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int heads, int lq, int lk,
                           Strides qs, Strides ks, Strides vs, Strides dos,
                           float scale) {
  extern __shared__ uint8_t smem_raw[];
  dq_body<D, kSplitParts>(smem_raw, q, k, v, dout, lse, delta, dq, heads, lq,
                          lk, qs, ks, vs, dos, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16x3_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int heads, int lq, int lk, Strides qs,
                            Strides ks, Strides vs, Strides dos,
                            float scale) {
  extern __shared__ uint8_t smem_raw[];
  dkv_body<D, kSplitParts>(smem_raw, q, k, v, dout, lse, delta, dk, dv,
                           heads, lq, lk, qs, ks, vs, dos, scale);
}

// set the kernel's dynamic shared-memory limit, launch, and return the
// launch's cudaError_t
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(int parts, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, int n, int heads, int lq, int lk, const Strides* s,
              float scale, cudaStream_t stream) {
  const dim3 grid((lq + kBlockM - 1) / kBlockM, heads, n);
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  const auto* bdo = static_cast<const __nv_bfloat16*>(dout);
  if (parts == 1)
    return launch(flash_bwd_dq_sm90_kernel<D>, dq_smem_bytes<1>(), grid,
                  stream, bq, bk, bv, bdo, lse, delta,
                  static_cast<__nv_bfloat16*>(dq), heads, lq, lk, s[0], s[1],
                  s[2], s[3], scale);
  return launch(flash_bwd_dq_bf16x3_kernel<D>, dq_smem_bytes<kSplitParts>(),
                grid, stream, bq, bk, bv, bdo, lse, delta,
                static_cast<float*>(dq), heads, lq, lk, s[0], s[1], s[2],
                s[3], scale);
}

template <int D>
int launch_dkv(int parts, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int n, int heads, int lq, int lk,
               const Strides* s, float scale, cudaStream_t stream) {
  const dim3 grid((lk + kBlockM - 1) / kBlockM, heads, n);
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  const auto* bdo = static_cast<const __nv_bfloat16*>(dout);
  if (parts == 1)
    return launch(flash_bwd_dkv_sm90_kernel<D>, dkv_smem_bytes<1>(), grid,
                  stream, bq, bk, bv, bdo, lse, delta,
                  static_cast<__nv_bfloat16*>(dk),
                  static_cast<__nv_bfloat16*>(dv), heads, lq, lk, s[0], s[1],
                  s[2], s[3], scale);
  return launch(flash_bwd_dkv_bf16x3_kernel<D>,
                dkv_smem_bytes<kSplitParts>(), grid, stream, bq, bk, bv, bdo,
                lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
                heads, lq, lk, s[0], s[1], s[2], s[3], scale);
}

int dq_by_head_dim(int parts, int d, const void* q, const void* k,
                   const void* v, const void* dout, const float* lse,
                   const float* delta, void* dq, int n, int heads, int lq,
                   int lk, const Strides* s, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_dq<32>(parts, q, k, v, dout, lse, delta, dq, n, heads,
                           lq, lk, s, scale, st);
    case 48:
      return launch_dq<48>(parts, q, k, v, dout, lse, delta, dq, n, heads,
                           lq, lk, s, scale, st);
    case 64:
      return launch_dq<64>(parts, q, k, v, dout, lse, delta, dq, n, heads,
                           lq, lk, s, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dkv_by_head_dim(int parts, int d, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, int n, int heads,
                    int lq, int lk, const Strides* s, float scale,
                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_dkv<32>(parts, q, k, v, dout, lse, delta, dk, dv, n,
                            heads, lq, lk, s, scale, st);
    case 48:
      return launch_dkv<48>(parts, q, k, v, dout, lse, delta, dk, dv, n,
                            heads, lq, lk, s, scale, st);
    case 64:
      return launch_dkv<64>(parts, q, k, v, dout, lse, delta, dk, dv, n,
                            heads, lq, lk, s, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

void read_strides(const int64_t* strides, Strides* s) {
  for (int t = 0; t < 4; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2], 0};
}

// the strides of split q, k, v and dO
void plane_strides(int n, int heads, int lq, int lk, int d, Strides* s) {
  const int lens[4] = {lq, lk, lk, lq};
  for (int t = 0; t < 4; ++t)
    s[t] = sm90::plane_strides(n, lens[t], heads, d);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `strides` is a host array of twelve int64 element strides (batch,
// position, head) of q, k, v and dO.  Every entry returns the cudaError_t
// of the launch (0 on success).  Head dims 32, 48, 64.
extern "C" {

// bf16 q, k, v and dO, each stride a multiple of 8, the four starting on
// 16 bytes; bf16 outputs
int flash_attention_backward_dq_sm90_bf16(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse,
                                          const float* delta, void* dq, int n,
                                          int heads, int lq, int lk, int d,
                                          const int64_t* strides, float scale,
                                          void* stream) {
  Strides s[4];
  read_strides(strides, s);
  return dq_by_head_dim(1, d, q, k, v, dout, lse, delta, dq, n, heads, lq,
                        lk, s, scale, stream);
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
  return dkv_by_head_dim(1, d, q, k, v, dout, lse, delta, dk, dv, n, heads,
                         lq, lk, s, scale, stream);
}

// q, k, v and dO as split_bf16x3_f32 writes them; float32 outputs
int flash_attention_backward_dq_sm90_f32(const void* q_parts,
                                         const void* k_parts,
                                         const void* v_parts,
                                         const void* do_parts,
                                         const float* lse, const float* delta,
                                         void* dq, int n, int heads, int lq,
                                         int lk, int d, float scale,
                                         void* stream) {
  Strides s[4];
  plane_strides(n, heads, lq, lk, d, s);
  return dq_by_head_dim(kSplitParts, d, q_parts, k_parts, v_parts, do_parts,
                        lse, delta, dq, n, heads, lq, lk, s, scale, stream);
}

int flash_attention_backward_dkv_sm90_f32(const void* q_parts,
                                          const void* k_parts,
                                          const void* v_parts,
                                          const void* do_parts,
                                          const float* lse,
                                          const float* delta, void* dk,
                                          void* dv, int n, int heads, int lq,
                                          int lk, int d, float scale,
                                          void* stream) {
  Strides s[4];
  plane_strides(n, heads, lq, lk, d, s);
  return dkv_by_head_dim(kSplitParts, d, q_parts, k_parts, v_parts, do_parts,
                         lse, delta, dk, dv, n, heads, lq, lk, s, scale,
                         stream);
}

const char* flash_attention_backward_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
