// Bilinear resize backward, CUDA C++ for sm_90a: the gradient of
// F.interpolate(x, size, mode="bilinear", align_corners) with respect to
// its NCHW input x, as a gather with no atomics.
//
// Replaces, on the port's path, PyTorch's own upsample_bilinear2d backward,
// which scatters with atomicAdd (rounding every add to bf16 for bf16
// tensors), so two calls give other bits.  The JAX package's resize
// (image_segmentation_lab_tpu/utils/ops.py::resize_bilinear; no Pallas
// kernel, XLA transposes its gathers) interpolates in float32 and casts
// once, so its gradient is the float32 gradient rounded once.
//
// The forward is separable: y[o, p] = sum_i sum_j A[o, i] B[p, j] x[i, j],
// where row o of A (and B) holds the two lerp weights of output o.  So
//   dx[i, j] = sum_o sum_p A[o, i] B[p, j] g[o, p],
// and per axis a small host-built table lists, for each input index i, the
// output indices o with A[o, i] != 0 (ascending) and their weights, padded
// to the most taps of any input index with index -1 and weight 0: an
// (in, taps) table of int32 indices and one of float32 weights, the weights
// computed as F.interpolate's forward computes them.  A 2x step gives 4 x 4
// taps per input element, a 4x step 8 x 8, a downsample 1-2 per axis, and
// an input side of 1 every output of that axis.
//
// Design: one thread per input element (n, c, i, j) sums
// (A[o, i] * B[p, j]) * g[o, p] over its row taps o (ascending) and, for
// each, its column taps p (ascending), in float32 with every step rounded
// (no fused multiply-add, so the plain version, which takes the same steps
// tap by tap, gives the same bits), and writes dx once in x's dtype: the
// same bits from call to call, and a bf16 dx is the float32 dx rounded once
// (g and dx share a dtype: float32 or bf16).  Where no input index has more
// than kTaps = 4 or 8 taps on either axis (every upsample up to 4x), a
// thread first holds its taps of both axes in registers and issues all its loads of g before the sums, so they are in
// flight together; other tables (an upsample above 4x, a large
// downsample, a 1-pixel input) take the taps one at a time.  Indices are
// 32-bit (the wrapper keeps the element counts below 2^31).
//
// One at a time is far from the byte bound on wide tables but far ahead of
// PyTorch's atomic backward.  At DeepLabV3's train-step shapes on an H100
// (16 x 512^2): its 8x logits (16 x 16 taps an element) 0.15-0.17 ms
// against a bound of 0.005-0.010 and PyTorch's 0.38-1.6; its ASPP image
// pool, a 1 x 1 input read by all 64 x 64 outputs, 0.68-0.72 ms against
// 0.020-0.040 and 61-141 ms, where each thread runs 4096 taps in series,
// 8192 threads on 32 SMs, each load of a warp in 32 planes.  A warp per
// input element (lanes over the tap pairs, then a shuffle tree; in the git
// history) took 0.086-0.089 ms at both.
//
// What bounds it on the card: bytes.  At SETR's largest upsample (8, 256,
// 160, 160) -> (320, 320) in bf16 it must read g (420 MB) and write dx
// (105 MB): 0.16 ms at 3.35 TB/s, against 16 multiply-adds per element of
// dx.  Neighbouring threads share most of their taps, so a warp's loads
// come from a few L1 lines and g is read from device memory about once.
// It takes about 6x that bound on an H100: by count each element costs
// about 300 instructions (16 taps, each an index, a weight and an element
// of g to load, two products and a sum).  The separable form takes 4 + 4
// taps: reducing along W into a float32 scratch in device memory moves
// 1.36 GB at that shape, 2.6x this design's 0.53 GB, and with the scratch
// in shared memory instead (a CTA of 8 x 32 input elements reducing the
// output rows it reads, then its row taps) it measured 1.5x slower than
// this design on the H100: each CTA waits on its loads between two
// barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// one axis's table: input index i reads output indices idx[i * taps + a]
// (ascending, then -1) with weights w[i * taps + a]
struct Axis {
  const int* idx;
  const float* w;
  int taps;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float tap(float acc, float wr, float wc,
                                     float g) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(wr, wc), g));
}

// kTaps: the most taps of an input index on either axis (4 or 8), or 0
// for any number, taken one at a time
template <typename T, int kTaps>
__global__ void __launch_bounds__(kThreads)
resize_backward_kernel(const T* __restrict__ g, T* __restrict__ dx,
                       int total, int in_h, int in_w, int out_h, int out_w,
                       Axis rows, Axis cols) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int j = t % in_w;
  const int i = t / in_w % in_h;
  const T* plane = g + (int64_t)(t / in_w / in_h) * out_h * out_w;
  const int* ri = rows.idx + i * rows.taps;
  const float* rw = rows.w + i * rows.taps;
  const int* ci = cols.idx + j * cols.taps;
  const float* cw = cols.w + j * cols.taps;
  float acc = 0.f;
  if constexpr (kTaps == 0) {
    for (int a = 0; a < rows.taps; ++a) {
      const int r = __ldg(ri + a);
      if (r < 0) break;
      const float wr = __ldg(rw + a);
      const T* row = plane + r * out_w;
      for (int b = 0; b < cols.taps; ++b) {
        const int c = __ldg(ci + b);
        if (c < 0) break;
        acc = tap(acc, wr, __ldg(cw + b), to_float(row[c]));
      }
    }
  } else {
    const T* row[kTaps];
    float wr[kTaps], wc[kTaps], v[kTaps][kTaps];
    int col[kTaps];
    bool row_in[kTaps], col_in[kTaps];
#pragma unroll
    for (int a = 0; a < kTaps; ++a) {
      const int r = a < rows.taps ? __ldg(ri + a) : -1;
      row_in[a] = r >= 0;
      row[a] = plane + (row_in[a] ? r : 0) * out_w;
      wr[a] = row_in[a] ? __ldg(rw + a) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      const int c = b < cols.taps ? __ldg(ci + b) : -1;
      col_in[b] = c >= 0;
      col[b] = col_in[b] ? c : 0;
      wc[b] = col_in[b] ? __ldg(cw + b) : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kTaps; ++a)
#pragma unroll
      for (int b = 0; b < kTaps; ++b)
        v[a][b] = row_in[a] && col_in[b] ? to_float(row[a][col[b]]) : 0.f;
#pragma unroll
    for (int a = 0; a < kTaps; ++a)
#pragma unroll
      for (int b = 0; b < kTaps; ++b)
        if (row_in[a] && col_in[b]) acc = tap(acc, wr[a], wc[b], v[a][b]);
  }
  dx[t] = from_float<T>(acc);
}

template <typename T>
int launch(const void* g, void* dx, int total, int in_h, int in_w,
           int out_h, int out_w, Axis rows, Axis cols, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const auto* gt = static_cast<const T*>(g);
  auto* dxt = static_cast<T*>(dx);
  const int taps = rows.taps > cols.taps ? rows.taps : cols.taps;
  if (taps <= 4)
    resize_backward_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(
        gt, dxt, total, in_h, in_w, out_h, out_w, rows, cols);
  else if (taps <= 8)
    resize_backward_kernel<T, 8><<<blocks, kThreads, 0, stream>>>(
        gt, dxt, total, in_h, in_w, out_h, out_w, rows, cols);
  else
    resize_backward_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(
        gt, dxt, total, in_h, in_w, out_h, out_w, rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers: g
// is a contiguous (planes, out_h, out_w) tensor, dx a contiguous
// (planes, in_h, in_w) one of the same dtype (0 float32, 1 bfloat16), each
// of fewer than 2^31 elements.  Each axis's table is an (in, taps) int32
// index table padded with -1 and its float32 weights.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" {

int resize_backward_bilinear(const void* g, void* dx, int dtype,
                             int64_t planes, int in_h, int in_w, int out_h,
                             int out_w, const int* row_idx, const float* row_w,
                             int row_taps, const int* col_idx,
                             const float* col_w, int col_taps, void* stream) {
  const int64_t total = planes * in_h * in_w;
  if (total == 0) return 0;
  if (total > 0x7fffffff || planes * out_h * out_w > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Axis rows{row_idx, row_w, row_taps}, cols{col_idx, col_w, col_taps};
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)total;
  switch (dtype) {
    case 0:
      return launch<float>(g, dx, n, in_h, in_w, out_h, out_w, rows, cols, s);
    case 1:
      return launch<__nv_bfloat16>(g, dx, n, in_h, in_w, out_h, out_w, rows,
                                   cols, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* resize_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
