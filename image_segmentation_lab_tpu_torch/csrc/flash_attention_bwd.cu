// Flash-attention backward, CUDA C++ for sm_90a: dQ and dK/dV.
//
// Replaces, for float32 inputs, the Pallas TPU kernels
// image_segmentation_lab_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (called through _flash_backward).  Given q, k, v,
// the output gradient dO, the forward's row logsumexp lse and
// delta = rowsum(dO * O) (float32, computed by the wrapper outside the
// kernels, as _flash_backward computes it), per batch n and head h:
//   P  = exp(q k^T * scale - lse)     float32, recomputed tile by tile
//   dP = dO v^T                        float32
//   dS = P * (dP - delta) * scale      float32
//   dQ = dS k                                      (flash_bwd_dq_kernel)
//   dV = P^T dO                                    (flash_bwd_dkv_kernel)
//   dK = dS^T q                                    (flash_bwd_dkv_kernel)
// all in float32, as in the TPU kernels at float32 inputs.  Keys past Lk
// get P = 0; query rows past Lq contribute nothing (the TPU version
// zero-pads dO).  Two kernels, not one with atomics: each output tile has
// one owner, so the gradients are the same from run to run.
//
// Layout: q, dO (N, Lq, H, D) and k, v (N, Lk, H, D) read through their
// strides (the head dim contiguous), so the slices of a fused qkv
// projection are read in place; lse and delta are (N, H, Lq) float32; dQ,
// dK and dV are written as contiguous (N, L, H, D) tensors.
//
// What bounds it on the card: each score tile costs 2*D flops per score and
// product, three products for dQ and four for dK/dV, against a few reads of
// each input, so at segmentation lengths (L ~ 1600) both kernels are bound
// by arithmetic.  float32 runs without TF32 on the CUDA cores (67 TFLOP/s
// peak).  The design is the forward kernel's (flash_attention.cu), simple
// first:
//   * dQ: one CTA of 128 threads per (64 query rows, head, batch); Q and dO
//     staged once, K/V tiles of 64 keys streamed through shared memory as
//     float32, dQ kept in registers and written once;
//   * dK/dV: one CTA per (64 key rows, head, batch); K and V staged once,
//     Q/dO tiles of 64 queries (with their lse and delta) streamed, dK and
//     dV kept in registers;
//   * each thread owns 4 rows (ty + 16 i) of the 64 x 64 score tile and 8
//     columns (tx + 8 j), read as float4 from padded, conflict-free shared
//     rows; P and dS go through shared memory to the threads that own the
//     output columns (4 rows x D/8 contiguous columns each);
//   * bfloat16 inputs go to the tensor-core kernels of
//     flash_attention_bwd_sm90.cu.
// No score or probability tensor reaches device memory.  Shared memory is
// above 48 KB at D = 64 (88 KB for dQ, 107 KB for dK/dV), so each launch
// first raises the kernel's dynamic shared-memory limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // rows per CTA, and rows per streamed tile
constexpr int kColGroups = 8;
constexpr int kRowGroups = 16;
constexpr int kThreads = kColGroups * kRowGroups;  // 128
constexpr int kRows = kBlock / kRowGroups;         // 4 rows per thread
constexpr int kCols = kBlock / kColGroups;         // 8 score columns per thread
constexpr int kPStride = kBlock + 8;  // P/dS row stride: conflict-free stores


struct Strides {
  int64_t n, l, h;  // element strides of batch, position and head
};

// padded Q/K/V/dO row in floats, 16-byte aligned
template <int D>
__host__ __device__ constexpr int smem_row() { return D + 4; }

// kBlock rows from row0 of one (batch, head) slice into shared memory as
// float32; rows past len are zero
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t ld, int row0, int len) {
  constexpr int kStride = smem_row<D>();
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, e = i % D;
    const int row = row0 + r;
    dst[r * kStride + e] = row < len ? src[row * ld + e] : 0.f;
  }
}

// s1[i][j] = a1[ty + 16 i] . b1[tx + 8 j] and s2 likewise from a2, b2, over
// the D columns of four padded shared-memory tiles
template <int D>
__device__ __forceinline__ void score_tiles(const float* a1, const float* b1,
                                            const float* a2, const float* b2,
                                            float (&s1)[kRows][kCols],
                                            float (&s2)[kRows][kCols],
                                            int ty, int tx) {
  constexpr int kStride = smem_row<D>();
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s1[i][j] = s2[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < D; e += 4) {
    float4 x1[kRows], x2[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (ty + kRowGroups * i) * kStride + e;
      x1[i] = *reinterpret_cast<const float4*>(&a1[r]);
      x2[i] = *reinterpret_cast<const float4*>(&a2[r]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = (tx + kColGroups * j) * kStride + e;
      const float4 y1 = *reinterpret_cast<const float4*>(&b1[c]);
      const float4 y2 = *reinterpret_cast<const float4*>(&b2[c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s1[i][j] = fmaf(x1[i].x, y1.x, s1[i][j]);
        s1[i][j] = fmaf(x1[i].y, y1.y, s1[i][j]);
        s1[i][j] = fmaf(x1[i].z, y1.z, s1[i][j]);
        s1[i][j] = fmaf(x1[i].w, y1.w, s1[i][j]);
        s2[i][j] = fmaf(x2[i].x, y2.x, s2[i][j]);
        s2[i][j] = fmaf(x2[i].y, y2.y, s2[i][j]);
        s2[i][j] = fmaf(x2[i].z, y2.z, s2[i][j]);
        s2[i][j] = fmaf(x2[i].w, y2.w, s2[i][j]);
      }
    }
  }
}

// acc[i][d] += sum_c p[ty + 16 i][c] * x[c][tx * D/8 + d]: a (64 x 64)
// shared tile times a (64 x D) shared tile, into this thread's 4 rows and
// D/8 contiguous columns
template <int D>
__device__ __forceinline__ void accumulate(const float* p_s, const float* x_s,
                                           float (&acc)[kRows][D / kColGroups],
                                           int ty, int tx) {
  constexpr int kStride = smem_row<D>();
  constexpr int kDCols = D / kColGroups;
#pragma unroll 2
  for (int c = 0; c < kBlock; c += 4) {
    float4 pv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      pv[i] = *reinterpret_cast<const float4*>(
          &p_s[(ty + kRowGroups * i) * kPStride + c]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float xv[kDCols];
      const float* x_row = &x_s[(c + cc) * kStride + tx * kDCols];
#pragma unroll
      for (int d = 0; d < kDCols; d += 2) {
        const float2 two = *reinterpret_cast<const float2*>(&x_row[d]);
        xv[d] = two.x;
        xv[d + 1] = two.y;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = cc == 0 ? pv[i].x
                        : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z
                                  : pv[i].w;
#pragma unroll
        for (int d = 0; d < kDCols; ++d) acc[i][d] = fmaf(p, xv[d], acc[i][d]);
      }
    }
  }
}

// this thread's rows of a contiguous (N, L, H, D) output
template <int D>
__device__ __forceinline__ void store_rows(
    float* out, float (&acc)[kRows][D / kColGroups], int n, int head,
    int heads, int row0, int len, int ty, int tx) {
  constexpr int kDCols = D / kColGroups;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty + kRowGroups * i;
    if (row >= len) continue;
    float* o_row =
        out + (((int64_t)n * len + row) * heads + head) * D + tx * kDCols;
#pragma unroll
    for (int d = 0; d < kDCols; ++d) o_row[d] = acc[i][d];
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kBlock * smem_row<D>() +
                          (size_t)kBlock * kPStride);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kBlock * smem_row<D>() +
                          2 * (size_t)kBlock * kPStride + 2 * kBlock);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int lq, int lk, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale) {
  constexpr int kStride = smem_row<D>();
  constexpr int kDCols = D / kColGroups;
  static_assert(D % 16 == 0, "rows are read as float4, columns as float2");

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBlock][kStride]
  float* do_s = q_s + kBlock * kStride;          // [kBlock][kStride]
  float* k_s = do_s + kBlock * kStride;          // [kBlock][kStride]
  float* v_s = k_s + kBlock * kStride;           // [kBlock][kStride]
  float* ds_s = v_s + kBlock * kStride;          // [kBlock][kPStride]

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;
  const int tx = tid % kColGroups;
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const float* kb = k + n * ks.n + head * ks.h;
  const float* vb = v + n * vs.n + head * vs.h;

  // Q and dO once; rows past lq are zero and never written back
  stage<D>(q_s, q + n * qs.n + head * qs.h, qs.l, q0, lq);
  stage<D>(do_s, dout + n * dos.n + head * dos.h, dos.l, q0, lq);

  const int64_t rows = ((int64_t)n * heads + head) * lq;
  float row_lse[kRows], row_delta[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kRowGroups * i;
    row_lse[i] = row < lq ? lse[rows + row] : 0.f;
    row_delta[i] = row < lq ? delta[rows + row] : 0.f;
#pragma unroll
    for (int d = 0; d < kDCols; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += kBlock) {
    __syncthreads();  // the last tile's readers are done (and Q/dO staged)
    stage<D>(k_s, kb, ks.l, k0, lk);
    stage<D>(v_s, vb, vs.l, k0, lk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows ty + 16 i, keys tx + 8 j
    float s[kRows][kCols], dp[kRows][kCols];
    score_tiles<D>(q_s, k_s, do_s, v_s, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* ds_row = &ds_s[(ty + kRowGroups * i) * kPStride + tx];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool in = k0 + tx + kColGroups * j < lk;
        const float p = in ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        // dS in k's dtype for the dS K product
        ds_row[kColGroups * j] =
            p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();
    accumulate<D>(ds_s, k_s, acc, ty, tx);  // dQ += dS K
  }
  store_rows<D>(dq, acc, n, head, heads, q0, lq, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int lq, int lk,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     float scale) {
  constexpr int kStride = smem_row<D>();
  constexpr int kDCols = D / kColGroups;
  static_assert(D % 16 == 0, "rows are read as float4, columns as float2");

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBlock][kStride]
  float* v_s = k_s + kBlock * kStride;           // [kBlock][kStride]
  float* q_s = v_s + kBlock * kStride;           // [kBlock][kStride]
  float* do_s = q_s + kBlock * kStride;          // [kBlock][kStride]
  float* p_s = do_s + kBlock * kStride;          // [kBlock][kPStride]
  float* ds_s = p_s + kBlock * kPStride;         // [kBlock][kPStride]
  float* lse_s = ds_s + kBlock * kPStride;       // [kBlock]
  float* delta_s = lse_s + kBlock;               // [kBlock]

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups;
  const int tx = tid % kColGroups;
  const int k0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const float* qb = q + n * qs.n + head * qs.h;
  const float* dob = dout + n * dos.n + head * dos.h;
  const int64_t rows = ((int64_t)n * heads + head) * lq;

  // K and V once; key rows past lk are zero and never written back
  stage<D>(k_s, k + n * ks.n + head * ks.h, ks.l, k0, lk);
  stage<D>(v_s, v + n * vs.n + head * vs.h, vs.l, k0, lk);

  float dk_acc[kRows][kDCols], dv_acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int d = 0; d < kDCols; ++d) dk_acc[i][d] = dv_acc[i][d] = 0.f;

  for (int q0 = 0; q0 < lq; q0 += kBlock) {
    __syncthreads();  // the last tile's readers are done (and K/V staged)
    stage<D>(q_s, qb, qs.l, q0, lq);
    stage<D>(do_s, dob, dos.l, q0, lq);
    for (int i = tid; i < kBlock; i += kThreads) {
      const bool in = q0 + i < lq;
      lse_s[i] = in ? lse[rows + q0 + i] : 0.f;
      delta_s[i] = in ? delta[rows + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for keys ty + 16 i, queries tx + 8 j
    float st[kRows][kCols], dpt[kRows][kCols];
    score_tiles<D>(k_s, q_s, v_s, do_s, st, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (ty + kRowGroups * i) * kPStride + tx;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kColGroups * j;
        const bool in = q0 + c < lq;
        const float p = in ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        p_s[r + kColGroups * j] = p;
        ds_s[r + kColGroups * j] = p * (dpt[i][j] - delta_s[c]) * scale;
      }
    }
    __syncthreads();
    accumulate<D>(p_s, do_s, dv_acc, ty, tx);   // dV += P^T dO
    accumulate<D>(ds_s, q_s, dk_acc, ty, tx);   // dK += dS^T Q
  }
  store_rows<D>(dk, dk_acc, n, head, heads, k0, lk, ty, tx);
  store_rows<D>(dv, dv_acc, n, head, heads, k0, lk, ty, tx);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int n,
              int heads, int lq, int lk, const Strides* s, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBlock - 1) / kBlock, heads, n);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), heads, lq, lk, s[0], s[1], s[2], s[3],
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int n, int heads, int lq, int lk, const Strides* s,
               float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lk + kBlock - 1) / kBlock, heads, n);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), heads, lq, lk,
      s[0], s[1], s[2], s[3], scale);
  return (int)cudaGetLastError();
}

void read_strides(const int64_t* strides, Strides* s) {
  for (int t = 0; t < 4; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int n,
                int heads, int lq, int lk, int d, const int64_t* strides,
                float scale, void* stream) {
  Strides s[4];
  read_strides(strides, s);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, dq, n, heads, lq,
                              lk, s, scale, st);
    case 48:
      return launch_dq<48>(q, k, v, dout, lse, delta, dq, n, heads, lq,
                              lk, s, scale, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, n, heads, lq,
                              lk, s, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int n, int heads, int lq, int lk, int d,
                 const int64_t* strides, float scale, void* stream) {
  Strides s[4];
  read_strides(strides, s);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, n, heads,
                               lq, lk, s, scale, st);
    case 48:
      return launch_dkv<48>(q, k, v, dout, lse, delta, dk, dv, n, heads,
                               lq, lk, s, scale, st);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, n, heads,
                               lq, lk, s, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `strides` is a host array of twelve int64 element strides (batch,
// position, head) of q, k, v and dO.  Every entry returns the cudaError_t
// of the launch (0 on success).  Supported head dims: 32, 48, 64.
extern "C" {

int flash_attention_backward_dq_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, int n, int heads, int lq,
                                    int lk, int d, const int64_t* strides,
                                    float scale, void* stream) {
  return dispatch_dq(q, k, v, dout, lse, delta, dq, n, heads, lq, lk,
                            d, strides, scale, stream);
}

int flash_attention_backward_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int n, int heads,
                                     int lq, int lk, int d,
                                     const int64_t* strides, float scale,
                                     void* stream) {
  return dispatch_dkv(q, k, v, dout, lse, delta, dk, dv, n, heads, lq,
                             lk, d, strides, scale, stream);
}

const char* flash_attention_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
