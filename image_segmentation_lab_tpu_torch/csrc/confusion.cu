// Confusion histograms for segmentation metrics, CUDA C++ for sm_90a.
//
// Replaces the two Pallas TPU kernels of
// image_segmentation_lab_tpu/ops/pallas/confusion.py:
//   * _kernel (via _pallas_call): fused argmax over class logits, then the
//     three per-class counts -> the LOGITS entry below;
//   * _hist_kernel (via _hist_pallas): the same counts from argmax labels
//     computed outside the kernel -> the LABELS entry below.
// Both entries are one templated kernel.
//
// Counts, over valid pixels (gt != ignore_index and 0 <= gt < num_classes):
//   out[0][c] intersection  (pred == gt == c)
//   out[1][c] prediction    (pred == c; a pred outside [0, num_classes) is
//                            not counted, as in the jnp path)
//   out[2][c] label         (gt == c)
//
// What bounds it on the card: each pixel costs C*sizeof(T) bytes of logits
// plus 4 bytes of gt, and a handful of integer ops, so the kernel is
// bandwidth-bound (far below the ridge point).  Its design:
//   * one thread per pixel in a grid-stride loop over NCHW logits: threads
//     of a warp read neighbouring pixels of one channel plane, so each of
//     the C reads coalesces (the TPU needed a pixel-on-lanes layout for the
//     same reason);
//   * an ignored pixel reads no logits;
//   * per-block int32 bins [3][num_classes] in shared memory, filled with
//     shared atomics, then one global atomicAdd per non-zero bin per block.
//     At small C many threads hit the same few bins, so shared-atomic
//     contention, not bandwidth, may be the limit there.
// Counts are int32: the wrapper refuses N*H*W >= 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kFromLogits: src is (N, C, HW) logits of type T; else (N*HW) int32 labels.
template <typename T, bool kFromLogits>
__global__ void __launch_bounds__(kThreads)
confusion_kernel(const T* __restrict__ src, const int32_t* __restrict__ gt,
                 int64_t n_pixels, int64_t hw, int channels, int num_classes,
                 int ignore_index, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];  // [3][num_classes]
  for (int i = threadIdx.x; i < 3 * num_classes; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pixels; p += step) {
    const int g = gt[p];
    if (g == ignore_index || g < 0 || g >= num_classes) continue;
    int pred;
    if constexpr (kFromLogits) {
      const int64_t n = p / hw;
      const T* px = src + n * channels * hw + (p - n * hw);
      float best = to_float(px[0]);
      pred = 0;
      for (int c = 1; c < channels; ++c) {
        const float v = to_float(px[(int64_t)c * hw]);
        // strict '>' scanning upward keeps the first maximum, as
        // torch.argmax and jnp.argmax do; a NaN counts as the maximum and
        // the first NaN wins, as in torch.argmax
        if (best == best && !(v <= best)) {
          best = v;
          pred = c;
        }
      }
    } else {
      pred = src[p];
    }
    atomicAdd(&bins[2 * num_classes + g], 1);
    if (pred >= 0 && pred < num_classes) {
      atomicAdd(&bins[num_classes + pred], 1);
      if (pred == g) atomicAdd(&bins[g], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * num_classes; i += blockDim.x) {
    if (bins[i] != 0) atomicAdd(&out[i], bins[i]);
  }
}

template <typename T, bool kFromLogits>
int launch(const void* src, const int32_t* gt, int64_t n_pixels, int64_t hw,
           int channels, int num_classes, int ignore_index, int32_t* out,
           cudaStream_t stream) {
  if (n_pixels == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t needed = (n_pixels + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const int blocks = (int)(needed < cap ? needed : cap);
  const size_t smem = (size_t)3 * num_classes * sizeof(int32_t);
  confusion_kernel<T, kFromLogits><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(src), gt, n_pixels, hw, channels, num_classes,
      ignore_index, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every entry returns the
// cudaError_t of the launch (0 on success); pointers are device pointers and
// `out` is a zeroed (3, num_classes) int32 buffer.
extern "C" {

int confusion_from_logits_f32(const void* logits, const int32_t* gt,
                              int64_t n, int64_t hw, int channels,
                              int num_classes, int ignore_index, int32_t* out,
                              void* stream) {
  return launch<float, true>(logits, gt, n * hw, hw, channels, num_classes,
                             ignore_index, out, (cudaStream_t)stream);
}

int confusion_from_logits_bf16(const void* logits, const int32_t* gt,
                               int64_t n, int64_t hw, int channels,
                               int num_classes, int ignore_index,
                               int32_t* out, void* stream) {
  return launch<__nv_bfloat16, true>(logits, gt, n * hw, hw, channels,
                                     num_classes, ignore_index, out,
                                     (cudaStream_t)stream);
}

int confusion_from_labels(const void* pred, const int32_t* gt,
                          int64_t n_pixels, int num_classes, int ignore_index,
                          int32_t* out, void* stream) {
  return launch<int32_t, false>(pred, gt, n_pixels, n_pixels, 1, num_classes,
                                ignore_index, out, (cudaStream_t)stream);
}

const char* confusion_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
