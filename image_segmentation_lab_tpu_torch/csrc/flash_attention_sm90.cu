// Flash-attention forward in bfloat16 on Hopper's tensor cores, CUDA C++
// for sm_90a.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernel
// image_segmentation_lab_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (called through _flash_forward).  Per batch n and head h it computes
//   o   = softmax(q k^T * scale) v
//   lse = m + log(max(l, 1e-30))      (per query row, float32)
// with the TPU kernel's numerics: scores in float32, an online softmax with
// a running max m and sum l per row, P = exp(s - m) cast to bf16 for the PV
// product, which accumulates in float32, o = acc / max(l, 1e-30).  Key
// columns past Lk never enter the max or the sum; query rows past Lq are
// never written.  Lq != Lk is allowed.  float32 inputs go to the CUDA-core
// kernel of flash_attention.cu.
//
// Layout: q (N, Lq, H, D), k/v (N, Lk, H, D) bf16, read through their
// (batch, position, head) strides with the head dim contiguous; every row
// must start on 16 bytes (the wrapper checks), which the strided q/k/v
// views of a fused qkv projection do.  o is written as a contiguous
// (N, Lq, H, D) tensor and lse as (N, H, Lq).  D is 32, 48 or 64.
//
// What bounds it on the card.  At SETR ViT-S/16's (N=8, H=6, L=1601, D=64)
// a call does 4 N H L^2 D = 31.5 GFLOP of bf16 products, 0.032 ms at the
// tensor cores' 989 TFLOP/s, against 9.8 MB read and written (0.003 ms at
// 3.35 TB/s): it is bound by operations.  It also takes N H L^2 = 1.23e8
// exponentials, and the SFU gives 16 a clock per SM: about 0.03 ms on 132
// SMs, as long as the tensor-core bound.  The design:
//   * tensor cores: S = Q K^T and O += P V are warpgroup wgmma.mma_async
//     products, m64n64k16, bf16 in and float32 out.  A CTA has two
//     warpgroups of 128 threads, each owning 64 query rows (128 per CTA);
//   * Q stays in shared memory for the whole CTA; K and V tiles of 64 keys
//     come through a 2-stage ring filled by cp.async 16-byte copies, so
//     tile j+1 arrives while tile j is computed.  Every shared-memory row
//     is 128 bytes (64 bf16, zero past D) in the 128-byte swizzle that the
//     wgmma descriptors name: K is read K-major, V MN-major (transposed by
//     the instruction);
//   * P goes from the S accumulator registers, converted to bf16, straight
//     in as the register A operand of the PV wgmma: the accumulator layout
//     of two 8-key column blocks is the A fragment of one 16-key step;
//   * softmax: exp2f with log2(e) folded into the scale; the row max by
//     two quad shuffles over the accumulator layout; the row sum kept per
//     thread and reduced once at the end;
//   * overlap of exponentials and products: 2 CTAs per SM (50 KB of shared
//     memory, at most 128 registers a thread), so four warpgroups share an
//     SM's tensor cores and SFUs and the warp schedulers run one's softmax
//     during another's wgmma.  Explicit ping-pong on named barriers and a
//     TMA producer warp are later work.
// The score tile never reaches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;  // query rows per CTA, 64 per warpgroup
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kRowBytes = 128;  // one swizzled shared-memory row: 64 bf16
constexpr int kStages = 2;
constexpr int kQBytes = kBlockM * kRowBytes;    // 16 KB
constexpr int kTileBytes = kBlockN * kRowBytes;  // 8 KB, each of K and V
// +1024: the swizzle needs 1024-byte aligned tiles
constexpr int kSmemBytes = 1024 + kQBytes + kStages * 2 * kTileBytes;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  int64_t n, l, h;  // element strides of batch, position and head
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int heads, int lq, int lk, Strides qs, Strides ks,
                      Strides vs, float scale_log2) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a q/k/v row
  static_assert(D % 16 == 0 && D <= 64, "D is 32, 48 or 64");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  // rows of 128 bytes: Q (128 rows), then per stage K (64 rows), V (64)
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + kQBytes;

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
    constexpr int kRows = kBlockM + kStages * 2 * kBlockN;
    for (int i = tid; i < kRows * kPad; i += kThreads) {
      const int r = i / kPad, c = kChunks + i % kPad;
      *reinterpret_cast<uint4*>(smem + swizzle(r, c)) = make_uint4(0, 0, 0, 0);
    }
  }

  // Q once; rows past lq are zero and never written back
  for (int i = tid; i < kBlockM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = q0 + r;
    const bool in = row < lq;
    cp_async16(q_s + swizzle(r, c), qb + (in ? row : 0) * qs.l + c * 8, in);
  }
  auto load_kv = [&](int tile, int stage) {
    const uint32_t k_dst = kv_s + stage * 2 * kTileBytes;
    const uint32_t v_dst = k_dst + kTileBytes;
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int key = tile * kBlockN + r;
      const bool in = key < lk;  // zero keys and values past lk
      const int64_t row = in ? key : 0;
      cp_async16(k_dst + swizzle(r, c), kb + row * ks.l + c * 8, in);
      cp_async16(v_dst + swizzle(r, c), vb + row * vs.l + c * 8, in);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  float s_acc[32], o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  // per row r and r + 8 of this thread (r = 16 warp + lane / 4): the
  // running max (log2 units), and this thread's part of the running sum
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

    const uint32_t k_tile = kv_s + stage * 2 * kTileBytes;
    const uint32_t v_tile = k_tile + kTileBytes;

    // S = Q K^T: D / 16 steps of 16 along the head dim, each 32 bytes on
    // in the swizzled rows; 8-row groups 1024 bytes apart
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s_acc, smem_desc(q_wg + kk * 32, 0, 1024),
               smem_desc(k_tile + kk * 32, 0, 1024), kk);
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
        float x = s_acc[4 * b + e] * scale_log2;
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
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // every tile holds a key below lk, so m is a real score's and the
    // masked columns' exp2f(-1e30 - m) is exactly 0
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s_acc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;  // float32, before the cast to bf16
      s_acc[i] = p;
      o_acc[i] *= alpha[(i >> 1) & 1];
    }
    // P as the A fragments of four 16-key steps
    uint32_t p_frag[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p_frag[kk][r] = pack_bf16(s_acc[8 * kk + 2 * r],
                                  s_acc[8 * kk + 2 * r + 1]);

    // O += P V: four steps of 16 keys, 16 rows of 2048 bytes on; V is
    // MN-major (the head dim contiguous), transposed by the instruction
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o_acc, p_frag[kk],
               smem_desc(v_tile + kk * 16 * kRowBytes, kTileBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
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
    __nv_bfloat16* o_row = o + (((int64_t)n * lq + row) * heads + head) * D;
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * b + 2 * quad) =
          __floats2bfloat162_rn(o_acc[4 * b + 2 * i] / l_fin,
                                o_acc[4 * b + 2 * i + 1] / l_fin);
    if (quad == 0)
      lse[((int64_t)n * heads + head) * lq + row] = m[i] * kLn2 + logf(l_fin);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int n, int heads, int lq, int lk, Strides qs, Strides ks,
           Strides vs, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBlockM - 1) / kBlockM, heads, n);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, heads, lq, lk, qs, ks, vs, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `strides` is a host array of nine int64 element strides (batch, position,
// head) of q, k and v, each a multiple of 8, and q, k, v start on 16 bytes.
// Returns the cudaError_t of the launch (0 on success).  Head dims 32, 48,
// 64.
extern "C" {

int flash_attention_forward_sm90_bf16(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int n, int heads, int lq, int lk, int d,
                                      const int64_t* strides, float scale,
                                      void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, n, heads, lq, lk, qs, ks, vs, scale,
                        s);
    case 48:
      return launch<48>(q, k, v, o, lse, n, heads, lq, lk, qs, ks, vs, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, o, lse, n, heads, lq, lk, qs, ks, vs, scale,
                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
