// Flash-attention forward in float32, CUDA C++ for sm_90a.
//
// Replaces, for float32 inputs, the Pallas TPU kernel
// image_segmentation_lab_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (called through _flash_forward).  It computes, per batch n and head h,
//   o   = softmax(q k^T * scale) v
//   lse = log(sum(exp(q k^T * scale)))          (per query row, float32)
// with the same numerics as the TPU kernel: scores in float32 times scale,
// an online softmax with a running max m and sum l per row, P = exp(s - m)
// cast to v's dtype before the PV product, which accumulates in float32,
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).  Key columns
// past Lk never enter the max or the sum; query rows past Lq are never
// written.  Lq != Lk is allowed.
//
// Layout: q (N, Lq, H, D), k/v (N, Lk, H, D) read through their strides
// (the head dim contiguous), so the q/k/v slices of a fused qkv projection
// are read in place with no heads-major transpose; o is written as a
// contiguous (N, Lq, H, D) tensor and lse as (N, H, Lq).
//
// What bounds it on the card: per (Lq x Lk) score tile it does 4*D flops
// per score against (Lq + 2 Lk + Lq) * D values moved, so at segmentation
// lengths (L ~ 1600) it is bound by arithmetic, not bytes.  float32 runs
// without TF32, so the work stays on the CUDA cores (67 TFLOP/s peak).  Its
// design, simple first:
//   * one CTA of 128 threads per (64 query rows, head, batch); K/V tiles of
//     64 keys staged through shared memory as float32, Q staged once;
//   * each thread owns 4 query rows (ty + 16 i) and, in the score tile, 8
//     key columns (tx + 8 j), read as float4 from padded shared-memory rows
//     (conflict-free); the 8 threads of a row reduce its max and sum with
//     warp shuffles;
//   * P goes through shared memory for the PV product, where each thread
//     owns its 4 rows and D/8 contiguous value columns;
//   * bf16 inputs go to the tensor-core kernel of flash_attention_sm90.cu;
//     with TF32 off, float32 has no exact tensor-core route.
// The score tile never reaches device memory: the einsum path writes and
// reads N*H*Lq*Lk float32 scores per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per CTA
constexpr int kBlockN = 64;   // keys per tile
constexpr int kColGroups = 8;
constexpr int kRowGroups = 16;
constexpr int kThreads = kColGroups * kRowGroups;  // 128
constexpr int kRows = kBlockM / kRowGroups;        // 4 rows per thread
constexpr int kCols = kBlockN / kColGroups;        // 8 score columns per thread
constexpr int kPStride = kBlockN + 8;  // P row stride: conflict-free stores
constexpr float kNegInf = -1e30f;      // finite, as in the TPU kernel

__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

struct Strides {
  int64_t n, l, h;  // element strides of batch, position and head
};

// padded Q/K/V row in floats, 16-byte aligned
template <int D>
__host__ __device__ constexpr int smem_row() { return D + 4; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBlockM + 2 * kBlockN) * smem_row<D>() +
                          (size_t)kBlockM * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int lq, int lk,
                 Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int kStride = smem_row<D>();
  constexpr int kDCols = D / kColGroups;  // value columns per thread
  static_assert(D % 16 == 0, "q/k rows are read as float4, v as float2");

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBlockM][kStride]
  float* k_s = q_s + kBlockM * kStride;          // [kBlockN][kStride]
  float* v_s = k_s + kBlockN * kStride;          // [kBlockN][kStride]
  float* p_s = v_s + kBlockN * kStride;          // [kBlockM][kPStride]

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;
  const int tx = tid % kColGroups;
  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const T* qb = q + n * qs.n + head * qs.h;
  const T* kb = k + n * ks.n + head * ks.h;
  const T* vb = v + n * vs.n + head * vs.h;

  // stage the Q tile once; rows past lq are zero and never written back
  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, e = i % D;
    const int row = q0 + r;
    q_s[r * kStride + e] = row < lq ? to_float(qb[row * qs.l + e]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDCols; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += kBlockN) {
    __syncthreads();  // the last tile's readers are done (and Q is staged)
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int c = i / D, e = i % D;
      const int col = k0 + c;
      const bool in = col < lk;
      k_s[c * kStride + e] = in ? to_float(kb[col * ks.l + e]) : 0.f;
      v_s[c * kStride + e] = in ? to_float(vb[col * vs.l + e]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 8 j, float32
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &q_s[(ty + kRowGroups * i) * kStride + e]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &k_s[(tx + kColGroups * j) * kStride + e]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // online softmax: the 8 threads of a row (lanes differing in bits 0-2)
    // reduce its max and sum with shuffles
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool in = k0 + tx + kColGroups * j < lk;
        s[i][j] = in ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
      float* p_row = &p_s[(ty + kRowGroups * i) * kPStride + tx];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool in = k0 + tx + kColGroups * j < lk;
        const float p = in ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        // P in v's dtype for the PV product (the sum above stays float32)
        p_row[kColGroups * j] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kDCols; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, value columns tx * kDCols + d
#pragma unroll 2
    for (int c = 0; c < kBlockN; c += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &p_s[(ty + kRowGroups * i) * kPStride + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[kDCols];
        const float* v_row = &v_s[(c + cc) * kStride + tx * kDCols];
#pragma unroll
        for (int d = 0; d < kDCols; d += 2) {
          const float2 two = *reinterpret_cast<const float2*>(&v_row[d]);
          vv[d] = two.x;
          vv[d + 1] = two.y;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = cc == 0 ? pv[i].x
                          : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
          for (int d = 0; d < kDCols; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kRowGroups * i;
    if (row >= lq) continue;
    const float l_fin = fmaxf(l[i], 1e-30f);
    T* o_row = o + (((int64_t)n * lq + row) * heads + head) * D + tx * kDCols;
#pragma unroll
    for (int d = 0; d < kDCols; ++d) o_row[d] = from_float<T>(acc[i][d] / l_fin);
    if (tx == 0)
      lse[((int64_t)n * heads + head) * lq + row] = m[i] + logf(l_fin);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int n, int heads, int lq, int lk, Strides qs, Strides ks,
           Strides vs, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBlockM - 1) / kBlockM, heads, n);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, heads, lq, lk, qs,
      ks, vs, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int n, int heads, int lq, int lk, int d, const int64_t* strides,
             float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, n, heads, lq, lk, qs, ks, vs,
                           scale, s);
    case 48:
      return launch<T, 48>(q, k, v, o, lse, n, heads, lq, lk, qs, ks, vs,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, n, heads, lq, lk, qs, ks, vs,
                           scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `strides` is a host array of nine int64 element strides (batch, position,
// head) of q, k and v.  Every entry returns the cudaError_t of the launch
// (0 on success).  Supported head dims: 32, 48, 64.
extern "C" {

int flash_attention_forward_f32(const void* q, const void* k, const void* v,
                                void* o, float* lse, int n, int heads, int lq,
                                int lk, int d, const int64_t* strides,
                                float scale, void* stream) {
  return dispatch<float>(q, k, v, o, lse, n, heads, lq, lk, d, strides, scale,
                         stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
