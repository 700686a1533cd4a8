// Flash-attention forward on Hopper's tensor cores, CUDA C++ for sm_90a, in
// bfloat16 and in float32.
//
// Replaces the Pallas TPU kernel
// image_segmentation_lab_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (called through _flash_forward).  Per batch n and head h it computes
//   o   = softmax(q k^T * scale) v
//   lse = m + log(max(l, 1e-30))      (per query row, float32)
// with the TPU kernel's numerics: scores in float32, an online softmax with
// a running max m and sum l per row, P = exp(s - m) in v's dtype for the PV
// product, which accumulates in float32, o = acc / max(l, 1e-30).  Key
// columns past Lk never enter the max or the sum; query rows past Lq are
// never written.  Lq != Lk is allowed.  Both products are warpgroup
// wgmma.mma_async m64n64k16 products with bf16 operands and float32
// accumulators; the two types differ in the number of bf16 parts (kParts)
// an operand is made of:
//   * bfloat16 (flash_fwd_sm90_kernel), one part: q, k and v as they are,
//     P rounded to bf16, o written in bf16; the softmax in log2 units
//     (exp2f, log2(e) folded into the scale);
//   * float32 (flash_fwd_bf16x3_kernel), three parts (sm90_bf16x3.cuh): q,
//     k and v as the three contiguous bf16 planes that split_bf16x3_kernel
//     writes once per forward call, so S = Q K^T is six bf16 products; P is
//     split into three parts in registers and O += P V is six products,
//     summed from zero in the score accumulator the split has freed and
//     then added to O in float32 (the tensor cores' accumulation truncates,
//     and O takes every key tile); the softmax takes the plain version's
//     float32 steps (s * scale, expf); o is written in float32.
//
// Layout: bf16 q (N, Lq, H, D), k/v (N, Lk, H, D) are read through their
// (batch, position, head) strides with the head dim contiguous; every row
// must start on 16 bytes (the wrapper checks), which the strided q/k/v
// views of a fused qkv projection do.  The float32 planes (3, N, L, H, D)
// are contiguous.  o is written as a contiguous (N, Lq, H, D) tensor and
// lse as (N, H, Lq).  D is 32, 48 or 64.
//
// What bounds it on the card.  At SETR ViT-S/16's (N=8, H=6, L=1601, D=64)
// a call does 4 N H L^2 D = 31.5 GFLOP of products, 0.032 ms at the tensor
// cores' 989 TFLOP/s in bf16 and six times that, 0.191 ms, for float32's
// six bf16 products a product (float32 on the CUDA cores: 0.470 ms at 67
// TFLOP/s), against 9.8 MB (bf16) read and written (0.003 ms at 3.35
// TB/s): it is bound by operations.  It also takes N H L^2 = 1.23e8
// exponentials, and the SFU gives 16 a clock per SM: about 0.03 ms on 132
// SMs.  The design:
//   * a CTA has two warpgroups of 128 threads, each owning 64 query rows
//     (128 per CTA);
//   * Q stays in shared memory for the whole CTA; K and V tiles of 64 keys
//     come through a 2-stage ring filled by cp.async 16-byte copies, so
//     tile j+1 arrives while tile j is computed.  Every shared-memory row
//     is 128 bytes (64 bf16, zero past D) in the 128-byte swizzle that the
//     wgmma descriptors name: K is read K-major, V MN-major (transposed by
//     the instruction); each part of an operand is a tile of its own;
//   * P goes from the S accumulator registers, converted to bf16 (parts),
//     straight in as the register A operand of the PV wgmma: the
//     accumulator layout of two 8-key column blocks is the A fragment of
//     one 16-key step;
//   * the row max by two quad shuffles over the accumulator layout; the row
//     sum kept per thread and reduced once at the end;
//   * bf16: 2 CTAs per SM (50 KB of shared memory, at most 128 registers a
//     thread), so four warpgroups share an SM's tensor cores and SFUs and
//     the warp schedulers run one's softmax during another's wgmma.
//     float32: one CTA per SM (Q 3 x 16 KB, the ring 2 stages x (K, V) x
//     3 x 8 KB: 145 KB; the S and O accumulators and P's three fragment
//     sets take 112 registers a thread).  Explicit ping-pong on named
//     barriers and a TMA producer warp are later work.
// The score tile never reaches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_bf16x3.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // query rows per CTA, 64 per warpgroup
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kQBytes = kBlockM * kRowBytes;  // 16 KB, a part
static_assert(kBlockN * kRowBytes == kTileBytes, "8 KB tiles, each of two");
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// +1024: the swizzle needs 1024-byte aligned tiles
template <int kParts>
constexpr int smem_bytes() {
  return 1024 + kParts * (kQBytes + kStages * 2 * kTileBytes);
}

// the output type: bf16 for bf16 inputs, float32 for split float32 ones
template <int kParts>
using Out = std::conditional_t<kParts == 1, __nv_bfloat16, float>;

// exp of a softmax argument: in log2 units for bf16 (the scale carries
// log2(e)), in float32's natural-log steps, as the plain version takes
// them, for split float32
template <int kParts>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (kParts == 1)
    return exp2f(x);
  else
    return expf(x);
}

// the kernel's body, for operands of kParts bf16 parts; `scale` is in the
// units of softmax_exp
template <int D, int kParts>
__device__ __forceinline__ void fwd_body(
    uint8_t* smem_raw, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    Out<kParts>* __restrict__ o, float* __restrict__ lse, int heads, int lq,
    int lk, const Strides& qs, const Strides& ks, const Strides& vs,
    float scale) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a q/k/v row
  constexpr int kStageBytes = 2 * kParts * kTileBytes;
  static_assert(D % 16 == 0 && D <= 64, "D is 32, 48 or 64");

  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  // rows of 128 bytes, kParts tiles of each: Q (128 rows), then per stage
  // K (64 rows), V (64)
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + kParts * kQBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: query rows 64 wg .. 64 wg + 63
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const __nv_bfloat16* qb = q + n * qs.n + head * qs.h;
  const __nv_bfloat16* kb = k + n * ks.n + head * ks.h;
  const __nv_bfloat16* vb = v + n * vs.n + head * vs.h;

  if constexpr (kChunks < 8) {
    // the PV product reads all 64 columns of V: zero the chunks past D of
    // every row once (no copy ever writes them)
    constexpr int kPad = 8 - kChunks;
    constexpr int kRows = kParts * (kBlockM + kStages * 2 * kBlockN);
    for (int i = tid; i < kRows * kPad; i += kThreads) {
      const int r = i / kPad, c = kChunks + i % kPad;
      *reinterpret_cast<uint4*>(smem + swizzle(r, c)) = make_uint4(0, 0, 0, 0);
    }
  }

  // Q once; rows past lq are zero and never written back
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    for (int i = tid; i < kBlockM * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int row = q0 + r;
      const bool in = row < lq;
      cp_async16(q_s + p * kQBytes + swizzle(r, c),
                 qb + p * qs.part + (in ? row : 0) * qs.l + c * 8, in);
    }
  auto load_kv = [&](int tile, int stage) {
    const uint32_t k_dst = kv_s + stage * kStageBytes;
    const uint32_t v_dst = k_dst + kParts * kTileBytes;
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
        const int r = i / kChunks, c = i % kChunks;
        const int key = tile * kBlockN + r;
        const bool in = key < lk;  // zero keys and values past lk
        const int64_t row = in ? key : 0;
        cp_async16(k_dst + p * kTileBytes + swizzle(r, c),
                   kb + p * ks.part + row * ks.l + c * 8, in);
        cp_async16(v_dst + p * kTileBytes + swizzle(r, c),
                   vb + p * vs.part + row * vs.l + c * 8, in);
      }
  };
  load_kv(0, 0);
  cp_async_commit();

  float s_acc[32], o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  // per row r and r + 8 of this thread (r = 16 warp + lane / 4): the
  // running max (in the scale's units), and this thread's part of the
  // running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
  const int tiles = (lk + kBlockN - 1) / kBlockN;

  for (int j = 0; j < tiles; ++j) {
    const int stage = j % kStages;
    // tile j + 1 into the other stage, freed at the end of iteration j - 1
    if (j + 1 < tiles) load_kv(j + 1, (j + 1) % kStages);
    cp_async_commit();  // (an empty group on the last tile)
    cp_async_wait_one();  // everything but tile j + 1 has landed
    fence_async_shared();
    __syncthreads();

    const uint32_t k_tile = kv_s + stage * kStageBytes;
    const uint32_t v_tile = k_tile + kParts * kTileBytes;

    // S = Q K^T, from zero
    fence_regs(s_acc);
    wgmma_fence();
    product_over_d<D, kParts>(s_acc, per_tile<kParts>(q_wg), kQBytes, k_tile,
                              kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // online softmax.  s_acc[4 b + e] is row r + 8 (e / 2), key column
    // 8 b + 2 quad + e % 2 of the tile
    const int k0 = j * kBlockN;
    const bool ragged = k0 + kBlockN > lk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[4 * b + e] * scale;
        if (ragged && k0 + 8 * b + 2 * quad + (e & 1) >= lk) x = kNegInf;
        s_acc[4 * b + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = softmax_exp<kParts>(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // every tile holds a key below lk, so m is a real score's and the
    // masked columns' exp(-1e30 - m) is exactly 0
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = softmax_exp<kParts>(s_acc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;  // float32, before the cast to bf16
      s_acc[i] = p;
      o_acc[i] *= alpha[(i >> 1) & 1];
    }
    // P as the A fragments of four 16-key steps, in bf16 parts
    uint32_t p_frag[kParts][4][4];
    to_split_frags(s_acc, p_frag);

    // O += P V: four steps of 16 keys, 16 rows of 2048 bytes on; V is
    // MN-major (the head dim contiguous), transposed by the instruction
    // (split: the tile's sum in s_acc, free now)
    add_product_over_rows(o_acc, s_acc, p_frag, v_tile, kTileBytes);
    __syncthreads();  // both warpgroups are done with this stage
  }

  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= lq) continue;
    const float l_fin = fmaxf(l[i], 1e-30f);
    Out<kParts>* o_row = o + (((int64_t)n * lq + row) * heads + head) * D;
#pragma unroll
    for (int b = 0; b < D / 8; ++b) {
      const float x = o_acc[4 * b + 2 * i] / l_fin;
      const float y = o_acc[4 * b + 2 * i + 1] / l_fin;
      if constexpr (kParts == 1)
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * b + 2 * quad) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(o_row + 8 * b + 2 * quad) =
            make_float2(x, y);
    }
    if (quad == 0)
      lse[((int64_t)n * heads + head) * lq + row] =
          (kParts == 1 ? m[i] * kLn2 : m[i]) + logf(l_fin);
  }
}

// bf16 inputs and output
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int heads, int lq, int lk, Strides qs, Strides ks,
                      Strides vs, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  fwd_body<D, 1>(smem_raw, q, k, v, o, lse, heads, lq, lk, qs, ks, vs,
                 scale_log2);
}

// float32 inputs as three bf16 planes each, float32 output
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16x3_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        float* __restrict__ o, float* __restrict__ lse,
                        int heads, int lq, int lk, Strides qs, Strides ks,
                        Strides vs, float scale) {
  extern __shared__ uint8_t smem_raw[];
  fwd_body<D, kSplitParts>(smem_raw, q, k, v, o, lse, heads, lq, lk, qs, ks,
                           vs, scale);
}

template <int D>
int launch(int parts, const void* q, const void* k, const void* v, void* o,
           float* lse, int n, int heads, int lq, int lk, const Strides* s,
           float scale, cudaStream_t stream) {
  const dim3 grid((lq + kBlockM - 1) / kBlockM, heads, n);
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  cudaError_t err;
  if (parts == 1) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<1>());
    if (err != cudaSuccess) return (int)err;
    flash_fwd_sm90_kernel<D><<<grid, kThreads, smem_bytes<1>(), stream>>>(
        bq, bk, bv, static_cast<__nv_bfloat16*>(o), lse, heads, lq, lk, s[0],
        s[1], s[2], scale * kLog2e);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16x3_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<kSplitParts>());
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16x3_kernel<D>
        <<<grid, kThreads, smem_bytes<kSplitParts>(), stream>>>(
            bq, bk, bv, static_cast<float*>(o), lse, heads, lq, lk, s[0],
            s[1], s[2], scale);
  }
  return (int)cudaGetLastError();
}

int by_head_dim(int parts, int d, const void* q, const void* k,
                const void* v, void* o, float* lse, int n, int heads, int lq,
                int lk, const Strides* s, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch<32>(parts, q, k, v, o, lse, n, heads, lq, lk, s, scale,
                        st);
    case 48:
      return launch<48>(parts, q, k, v, o, lse, n, heads, lq, lk, s, scale,
                        st);
    case 64:
      return launch<64>(parts, q, k, v, o, lse, n, heads, lq, lk, s, scale,
                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `strides` is a host array of nine int64 element strides (batch, position,
// head) of q, k and v.  Every entry returns the cudaError_t of the launch
// (0 on success).  Head dims 32, 48, 64.
extern "C" {

// bf16 q, k, v, each stride a multiple of 8, the three starting on 16
// bytes; bf16 o
int flash_attention_forward_sm90_bf16(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int n, int heads, int lq, int lk, int d,
                                      const int64_t* strides, float scale,
                                      void* stream) {
  Strides s[3];
  for (int t = 0; t < 3; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2], 0};
  return by_head_dim(1, d, q, k, v, o, lse, n, heads, lq, lk, s, scale,
                     stream);
}

// `count` float32 (N, lens[t], H, D) operands src[t], the head dim
// contiguous and three int64 element strides each (batch, position, head)
// in `strides`, into three contiguous bf16 planes dst[t], (3, N, lens[t],
// H, D): hi + mid + lo is the value.  The forward splits q, k and v
// (count 3), the backward q, k, v and dO (count 4), one launch each.
int split_bf16x3_f32(int count, const void* const* src, void* const* dst,
                     const int* lens, int n, int heads, int d,
                     const int64_t* strides, void* stream) {
  return sm90::split_bf16x3(count, src, dst, lens, n, heads, d, strides,
                            (cudaStream_t)stream);
}

// q, k and v as split_bf16x3_f32 writes them; float32 o
int flash_attention_forward_sm90_f32(const void* q_parts, const void* k_parts,
                                     const void* v_parts, void* o, float* lse,
                                     int n, int heads, int lq, int lk, int d,
                                     float scale, void* stream) {
  const Strides s[3] = {plane_strides(n, lq, heads, d),
                        plane_strides(n, lk, heads, d),
                        plane_strides(n, lk, heads, d)};
  return by_head_dim(kSplitParts, d, q_parts, k_parts, v_parts, o, lse, n,
                     heads, lq, lk, s, scale, stream);
}

const char* flash_attention_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
