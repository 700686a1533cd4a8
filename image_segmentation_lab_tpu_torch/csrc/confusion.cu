// Confusion histograms for segmentation metrics, CUDA C++ for sm_90a.
//
// Replaces the two Pallas TPU kernels of
// image_segmentation_lab_tpu/ops/pallas/confusion.py:
//   * _kernel (via _pallas_call): fused argmax over class logits, then the
//     three per-class counts -> the logits entries below (K1);
//   * _hist_kernel (via _hist_pallas): the same counts from argmax labels
//     computed outside the kernel -> the labels entry below (K2).
// Both entries are one templated kernel.
//
// Counts, over valid pixels (gt != ignore_index and 0 <= gt < num_classes):
//   out[0][c] intersection  (pred == gt == c)
//   out[1][c] prediction    (pred == c; a pred outside [0, num_classes) is
//                            not counted, as in the jnp path)
//   out[2][c] label         (gt == c)
// summed in int32 and rounded to float32 once, by the kernel itself.
//
// What bounds it on the card: each pixel costs C*sizeof(T) bytes of logits
// plus 4 bytes of gt and a few integer operations, far below the ridge
// point, so the bound is bytes.  At the flagship's C = 2 the whole input
// (8 x 512², 25 MB) takes 7.5 us at 3.35 TB/s, so what surrounds the
// stream counts as much as the stream: the launch's ramp, the tail, and
// what the cross-CTA sum adds to the tail.  A first design (one pixel a
// thread, scalar loads issued one after another, every count a shared
// atomic on six words, one global atomic per bin per CTA, a fill and a
// cast around it) took 14.2 us there on an H100 with the L2 clean.  This
// design:
//   * 16-byte loads: a thread owns 4 consecutive pixels (float32, int32)
//     or 8 (bf16) per chunk, and on the register path issues the loads of
//     up to 4 chunks (gt and every class plane; about 48 registers) before
//     it compares anything; on the shared path it reads 4 planes at a
//     time (8 with one pixel a chunk).  Logits are read whether or not
//     the pixel is valid (the bound counts those bytes anyway).  Where a
//     plane (H*W) or a base pointer breaks 16-byte alignment, the
//     launcher takes the same kernel's scalar instance (one pixel a
//     chunk), never a misread;
//   * private counts: up to kRegisterClasses channels (classes, for the
//     labels entry) the counts live in registers, kC slots unrolled with
//     predicated adds (no dynamic index into a register array, which would
//     go to local memory), and a warp sums them with __reduce_add_sync
//     before shared memory sees them: no shared atomic per pixel.  Above
//     that (CTAs of 512 threads), each warp counts into its own shared row
//     with shared atomics while 16 x 3C int32 fit (C <= 256), and past
//     that the CTA shares one set of bins (up to MAX_CLASSES = 4096);
//   * one launch, no serial flush: each CTA writes its (3, slots) partial
//     row (to a buffer the wrapper allocates per call, any contents) and
//     takes a ticket (an acq_rel atomicAdd); the CTA that draws the last
//     ticket sums every partial (register path: a few rows a thread,
//     loaded at once; shared path: the rows as one flat run of 16-byte
//     packets into shared column sums) and writes the float32 (3, C)
//     result, then resets the ticket, so the next call on the stream (or
//     a replay of a captured graph) starts from 0.  The ticket belongs to
//     one stream (the wrapper keeps one word per device and stream, zeroed
//     once), so calls on two streams never share it; a grid of one CTA
//     writes its counts directly and takes no ticket.  A ticket, not a
//     cluster's sum through distributed shared memory: the last CTA's sum
//     measured 0.4-1 us on the H100, all that a cluster could take off,
//     and a ticket needs no cluster launch.  There is no fill and no cast
//     around the kernel;
//   * a grid of at most 2 CTAs per SM (1 when a CTA's bins are one 3C row
//     above 256 classes), never more than the partials have rows, and
//     for a small input only as many CTAs as fill each thread's loads in
//     flight once: on the H100 more CTAs bought nothing at C = 2, and
//     each adds a row to the last CTA's sum (at 38k pixels, K2 took
//     4.3 us with 38 CTAs and 5.6 with 149).
// Measured on an H100 at (8, 2, 512, 512) float32: K1 15.0 us after a
// 96 MB write (50 % of its byte bound: the L2's dirty lines are written
// back as the kernel reads, about as many bytes again), 11.7 us with the
// L2 clean (64 %); K2 11.4 and 8.8 us (44 %, 57 %).  About 1 us of each
// is the ticket and the last CTA's sum.  The ticket's serial tail (fence,
// atomic, L2 read of the rows) costs a small input most: K1 at 38k
// pixels 6.5-6.6 us, where the first design took 3.0.
// The wrapper refuses N*H*W >= 2^31, so pixel indices fit in 32 bits and
// the int32 counts cannot overflow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/atomic>
#include <mutex>

namespace {

// threads a CTA: the register path runs CTAs of 256; the shared path runs
// CTAs of 512 (at C = 19 on the H100, 4-8 % faster: twice the warps an SM
// and twice the threads for the last CTA's sum of rows of 3C counts)
constexpr int kRegisterThreads = 256;
constexpr int kSharedThreads = 512;
constexpr int kSharedWarps = kSharedThreads / 32;
constexpr int kRegisterClasses = 8;  // counts in registers up to this width
constexpr int kWarpRowClasses = 256;  // 16 warps x 3 x 256 int32 = 48 KB
constexpr int kWaves = 2;  // CTAs per SM at most
// 32-bit loads a thread of the last CTA issues at once (register path:
// rows of 3 x kC; shared path: 16-byte packets)
constexpr int kFinalWords = 24;
constexpr int kMaxDynamicShared = 3 * 4096 * sizeof(int32_t);  // MAX_CLASSES

enum Entry { kLogitsF32 = 0, kLogitsBf16 = 1, kLabels = 2 };

struct Params {
  const void* src;  // (N, C, H*W) logits of T, or (N*H*W) int32 labels
  const int32_t* gt;
  int64_t n_pixels;
  int64_t hw;
  int channels;
  int num_classes;
  int ignore_index;
  int per_warp;  // shared path: one row of bins per warp, else per CTA
  int32_t* partials;  // one row of 3 x slots a CTA (more than one CTA)
  unsigned* ticket;
  float* out;
};

// 16 bytes of read-only input, through the non-coherent path
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// kV consecutive values of T: one 16-byte load (kV * sizeof(T) == 16) or
// one scalar load (kV == 1), kept as raw 32-bit words until compared.
template <typename T, int kV>
struct Packet {
  static constexpr int kWords = kV * (int)sizeof(T) >= 4
                                    ? kV * (int)sizeof(T) / 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0;
  }

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kV * sizeof(T) == 16) {
      const uint4 v = load16(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (sizeof(T) == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  // value j as float: exact for bf16 (its bits are a float's top half)
  __device__ __forceinline__ float value(int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else if constexpr (kV == 1) {
      return __uint_as_float(w[0] << 16);
    } else {  // little-endian: element 2i in the low half of word i
      return __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u
                                   : w[j / 2] << 16);
    }
  }
};

// kV int32 values: 16-byte loads, or one scalar load.
template <int kV>
__device__ __forceinline__ void load_ints(const int32_t* p, int (&x)[kV]) {
  if constexpr (kV == 1) {
    x[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < kV; i += 4) {
      const uint4 v = load16(p + i);
      x[i] = (int)v.x; x[i + 1] = (int)v.y; x[i + 2] = (int)v.z;
      x[i + 3] = (int)v.w;
    }
  }
}

// strict '>' scanning upward keeps the first maximum, as torch.argmax and
// jnp.argmax do; a NaN counts as the maximum and the first NaN wins, as in
// torch.argmax
__device__ __forceinline__ void argmax_step(float v, int c, float& best,
                                            int& pred) {
  if (best == best && !(v <= best)) {
    best = v;
    pred = c;
  }
}

// Loaded registers a thread may fill before it compares (about 48 of 32
// bits).
constexpr int kLoadWords = 48;

// Chunks of kv pixels a thread loads before it compares: as many as
// kLoadWords registers hold (at most 4), on the register path (slots > 0).
__host__ __device__ constexpr int chunks_in_flight(bool from_logits,
                                                   int slots, int kv) {
  const int words = (from_logits ? slots * (kv > 1 ? 4 : 1) : kv) + kv;
  return slots == 0 ? 1
         : kLoadWords / words > 4 ? 4
         : kLoadWords / words < 1 ? 1
         : kLoadWords / words;
}

// kC > 0: counts in kC register slots per kind (channels <= kC for logits,
// num_classes <= kC for labels); kC == 0: counts in shared memory.
// kVec: 16-byte packets of kV pixels, else one pixel at a time.
template <typename T, bool kFromLogits, int kC, bool kVec>
__global__ void __launch_bounds__(kC > 0 ? kRegisterThreads : kSharedThreads)
confusion_kernel(const Params p) {
  constexpr bool kRegisters = kC > 0;
  constexpr int kThreads = kRegisters ? kRegisterThreads : kSharedThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kV = !kVec ? 1 : 16 / (int)sizeof(T);
  // channel planes read at once on the shared path: 4 packets measured
  // faster than 8 at C = 19 on the H100; one pixel at a time takes 8
  // (with 4, ptxas gives the bf16 instance an 8-byte stack frame)
  constexpr int kGroup = kVec ? 4 : 8;
  constexpr int kSlots = kRegisters ? kC : 1;
  constexpr int kUnroll = chunks_in_flight(kFromLogits, kC, kV);
  extern __shared__ int32_t bins[];  // shared path: rows x [3][num_classes]
  __shared__ int32_t warp_sums[kWarps][3 * kSlots];
  __shared__ bool last;

  const int K = p.num_classes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // [kind][slot], kind 0 intersection, 1 prediction, 2 label
  int cnt[3 * kSlots];
#pragma unroll
  for (int j = 0; j < 3 * kSlots; ++j) cnt[j] = 0;
  int32_t* row = bins;
  if constexpr (!kRegisters) {
    const int rows = p.per_warp ? kWarps : 1;
    for (int i = threadIdx.x; i < rows * 3 * K; i += kThreads) bins[i] = 0;
    if (p.per_warp) row = bins + warp * 3 * K;
    __syncthreads();
  }

  const int64_t n_chunks = p.n_pixels / kV;  // kVec: H*W % kV == 0
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t v0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       v0 < n_chunks; v0 += kUnroll * stride) {
    int g[kUnroll][kV], pred[kUnroll][kV];
    if constexpr (kFromLogits && kRegisters) {
      // every load of the kUnroll chunks in flight before the first
      // comparison
      Packet<T, kV> x[kUnroll][kC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + u * stride;
        if (v < n_chunks) {
          const uint32_t p0 = (uint32_t)(v * kV);
          const uint32_t n = p0 / (uint32_t)p.hw;
          const T* base = static_cast<const T*>(p.src)
                          + (int64_t)n * p.channels * p.hw
                          + (p0 - n * (uint32_t)p.hw);
          load_ints<kV>(p.gt + p0, g[u]);
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (c < p.channels) x[u][c].load(base + c * p.hw);
        } else {  // past the end: ignored pixels
#pragma unroll
          for (int j = 0; j < kV; ++j) g[u][j] = p.ignore_index;
#pragma unroll
          for (int c = 0; c < kC; ++c) x[u][c].clear();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          float best = x[u][0].value(j);
          pred[u][j] = 0;
#pragma unroll
          for (int c = 1; c < kC; ++c)
            if (c < p.channels) argmax_step(x[u][c].value(j), c, best,
                                            pred[u][j]);
        }
    } else if constexpr (kFromLogits) {
      // kUnroll == 1: the planes kGroup at a time
      const uint32_t p0 = (uint32_t)(v0 * kV);
      const uint32_t n = p0 / (uint32_t)p.hw;
      const T* base = static_cast<const T*>(p.src)
                      + (int64_t)n * p.channels * p.hw
                      + (p0 - n * (uint32_t)p.hw);
      load_ints<kV>(p.gt + p0, g[0]);
      float best[kV];
      for (int c0 = 0; c0 < p.channels; c0 += kGroup) {
        Packet<T, kV> x[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (c0 + k < p.channels) x[k].load(base + (c0 + k) * p.hw);
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (c0 + k < p.channels)
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              if (c0 + k == 0) {
                best[j] = x[k].value(j);
                pred[0][j] = 0;
              } else {
                argmax_step(x[k].value(j), c0 + k, best[j], pred[0][j]);
              }
            }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + u * stride;
        if (v < n_chunks) {
          const uint32_t p0 = (uint32_t)(v * kV);
          load_ints<kV>(p.gt + p0, g[u]);
          load_ints<kV>(static_cast<const int32_t*>(p.src) + p0, pred[u]);
        } else {  // past the end: ignored pixels
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            g[u][j] = p.ignore_index;
            pred[u][j] = -1;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int gu = g[u][j], pu = pred[u][j];
        const bool valid = gu != p.ignore_index && (unsigned)gu < (unsigned)K;
        if constexpr (kRegisters) {
          // -1 matches no slot; a pred in [K, kC) lands in a slot that is
          // never written out
          const int gv = valid ? gu : -1;
          const int pv = valid ? pu : -1;
          const int iv = gv == pv ? gv : -1;
#pragma unroll
          for (int s = 0; s < kC; ++s) {
            cnt[s] += iv == s;
            cnt[kC + s] += pv == s;
            cnt[2 * kC + s] += gv == s;
          }
        } else if (valid) {
          atomicAdd(&row[2 * K + gu], 1);
          if ((unsigned)pu < (unsigned)K) {
            atomicAdd(&row[K + pu], 1);
            if (pu == gu) atomicAdd(&row[gu], 1);
          }
        }
      }
  }

  // this CTA's counts: 3 x slots int32 (slots = kC, or K on the shared
  // path), its partial row, or with a grid of one CTA the float32 result
  // (no ticket, no second pass)
  const int width = kRegisters ? 3 * kC : 3 * K;
  const bool alone = gridDim.x == 1;
  int32_t* const mine = p.partials + (int64_t)blockIdx.x * width;
  if constexpr (kRegisters) {
#pragma unroll
    for (int j = 0; j < 3 * kC; ++j) {
      const int t = __reduce_add_sync(0xffffffffu, cnt[j]);
      if (lane == 0) warp_sums[warp][j] = t;
    }
    __syncthreads();
    if (threadIdx.x < 3 * kC) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
      const int kind = threadIdx.x / kC, c = threadIdx.x % kC;
      if (!alone) mine[threadIdx.x] = s;
      else if (c < K) p.out[kind * K + c] = (float)s;
    }
  } else {
    __syncthreads();
    const int rows = p.per_warp ? kWarps : 1;
    for (int i = threadIdx.x; i < width; i += kThreads) {
      int s = 0;
      for (int r = 0; r < rows; ++r) s += bins[r * width + i];
      if (!alone) mine[i] = s;
      else p.out[i] = (float)s;
    }
  }
  if (alone) return;
  // the barrier orders every thread's partial before thread 0's ticket,
  // whose release (at device scope, cumulative) publishes them; the last
  // CTA's acquire, then its barrier, order its reads after all of them
  __syncthreads();
  if (threadIdx.x == 0)
    last = cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*p.ticket)
               .fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last CTA sums every CTA's partial, read from L2 (ld.global.cg),
  // and writes each count once as float32
  int32_t* const sums = kRegisters ? &warp_sums[0][0] : bins;
  if constexpr (kRegisters) {
    // rows of 3 x kC ints, kRows a thread loaded at once (one round trip
    // for up to kRows x 256 CTAs), into registers, then the warps' sums
    constexpr int kRows = kFinalWords / (3 * kC) > 1
                              ? kFinalWords / (3 * kC) : 1;
#pragma unroll
    for (int j = 0; j < 3 * kC; ++j) cnt[j] = 0;
    for (int b0 = threadIdx.x; b0 < (int)gridDim.x;
         b0 += kRows * kThreads) {
      int rows[kRows][3 * kC];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int b = b0 + k * kThreads;
#pragma unroll
        for (int j = 0; j < 3 * kC; ++j)
          rows[k][j] = b < (int)gridDim.x
                           ? __ldcg(p.partials + (int64_t)b * width + j) : 0;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int j = 0; j < 3 * kC; ++j) cnt[j] += rows[k][j];
    }
#pragma unroll
    for (int j = 0; j < 3 * kC; ++j) {
      const int t = __reduce_add_sync(0xffffffffu, cnt[j]);
      if (lane == 0) warp_sums[warp][j] = t;
    }
    __syncthreads();
    if (threadIdx.x < 3 * kC) {
      int t = 0;
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += warp_sums[w][threadIdx.x];
      sums[threadIdx.x] += t;  // row 0 is warp 0's sum
    }
  } else {
    // the partials as one flat array of 16-byte packets, kPackets in
    // flight a thread, each value added to its column's sum in shared
    // memory (3C columns: few conflicts)
    for (int i = threadIdx.x; i < width; i += kThreads) sums[i] = 0;
    __syncthreads();
    constexpr int kPackets = kFinalWords / 4;
    const int total = (int)gridDim.x * width;
    const int4* const packets = reinterpret_cast<const int4*>(p.partials);
    for (int e0 = threadIdx.x; e0 < total / 4;
         e0 += kPackets * kThreads) {
      int4 v[kPackets];
#pragma unroll
      for (int k = 0; k < kPackets; ++k)
        if (e0 + k * kThreads < total / 4)
          v[k] = __ldcg(packets + e0 + k * kThreads);
#pragma unroll
      for (int k = 0; k < kPackets; ++k) {
        if (e0 + k * kThreads >= total / 4) break;
        int col = 4 * (e0 + k * kThreads) % width;
        const int vals[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (vals[i]) atomicAdd(&sums[col], vals[i]);
          col = col + 1 == width ? 0 : col + 1;
        }
      }
    }
    for (int e = total / 4 * 4 + threadIdx.x; e < total; e += kThreads) {
      const int val = __ldcg(p.partials + e);
      if (val) atomicAdd(&sums[e % width], val);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * K; i += kThreads) {
    // register path: out[kind][c] is slot kind * kC + c
    const int slot = kRegisters ? i / K * kC + i % K : i;
    p.out[i] = (float)sums[slot];
  }
  if (threadIdx.x == 0) *p.ticket = 0;  // the next call starts from 0
}

using Kernel = void (*)(Params);

template <typename T, bool kFromLogits, bool kVec>
Kernel kernel_for(int width) {
  if (width <= 2) return confusion_kernel<T, kFromLogits, 2, kVec>;
  if (width <= 4) return confusion_kernel<T, kFromLogits, 4, kVec>;
  if (width <= kRegisterClasses)
    return confusion_kernel<T, kFromLogits, kRegisterClasses, kVec>;
  return confusion_kernel<T, kFromLogits, 0, kVec>;
}

template <typename T, bool kFromLogits>
Kernel kernel_for(bool vec, int width) {
  return vec ? kernel_for<T, kFromLogits, true>(width)
             : kernel_for<T, kFromLogits, false>(width);
}

// CTAs per SM of an instance at a dynamic shared-memory size, and SMs per
// device, asked of the runtime once each
int occupancy(Kernel kernel, int threads, int device, size_t smem,
              cudaError_t* err) {
  struct Seen {
    Kernel kernel;
    int device;
    size_t smem;
    int blocks;
  };
  static std::mutex mutex;
  static Seen seen[256];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].device == device &&
        seen[i].smem == smem)
      return seen[i].blocks;
  int blocks = 0;
  // the shared path's bins and its few static words pass 48 KB at 256 and
  // 4096 classes: opt in to the most any call asks for
  if (smem > 0)
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxDynamicShared);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         threads, smem);
  if (*err == cudaSuccess && n_seen < 256)
    seen[n_seen++] = {kernel, device, smem, blocks};
  return blocks;
}

int multiprocessors(int device, cudaError_t* err) {
  static std::mutex mutex;
  static int sms[64] = {0};
  std::lock_guard<std::mutex> lock(mutex);
  if (device < 0 || device >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (sms[device] == 0)
    *err = cudaDeviceGetAttribute(&sms[device],
                                  cudaDevAttrMultiProcessorCount, device);
  return sms[device];
}

cudaError_t launch(int entry, const Params& base, int64_t partial_ints,
                   int device, cudaStream_t stream, int* instance) {
  Params p = base;
  const bool logits = entry != kLabels;
  const int elem = entry == kLogitsBf16 ? 2 : 4;
  // 16-byte packets only where no packet straddles an image's plane and
  // every packet is 16-byte aligned
  const bool vec = p.hw % (16 / elem) == 0 &&
                   reinterpret_cast<uintptr_t>(p.src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.gt) % 16 == 0;
  const int kv = vec ? 16 / elem : 1;
  const int width = logits ? p.channels : p.num_classes;
  Kernel kernel;
  switch (entry) {
    case kLogitsF32: kernel = kernel_for<float, true>(vec, width); break;
    case kLogitsBf16:
      kernel = kernel_for<__nv_bfloat16, true>(vec, width);
      break;
    case kLabels: kernel = kernel_for<int32_t, false>(vec, width); break;
    default: return cudaErrorInvalidValue;
  }
  const bool registers = width <= kRegisterClasses;
  const int slots = !registers ? 0
                    : width <= 2 ? 2 : width <= 4 ? 4 : kRegisterClasses;
  *instance = entry * 100 + slots * 10 + vec;
  const int threads = registers ? kRegisterThreads : kSharedThreads;
  p.per_warp = p.num_classes <= kWarpRowClasses;
  const size_t smem = registers ? 0
                      : (size_t)(p.per_warp ? kSharedWarps : 1) * 3 *
                            p.num_classes * sizeof(int32_t);
  if (reinterpret_cast<uintptr_t>(p.partials) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int64_t rows =
      partial_ints / (3 * (registers ? slots : p.num_classes));
  if (rows < 1) return cudaErrorInvalidValue;

  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return err;
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const int sms = multiprocessors(device, &err);
  const int resident = err == cudaSuccess
                           ? occupancy(kernel, threads, device, smem, &err)
                           : 0;
  if (err == cudaSuccess && resident < 1)
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) {
    const int cap = registers || p.per_warp ? kWaves : 1;
    const int waves = resident < cap ? resident : cap;
    // as many CTAs as fill each thread's loads in flight once (a small
    // input gets fewer, so fewer rows to sum), at most `waves` an SM
    const int64_t per_cta =
        (int64_t)threads * chunks_in_flight(logits, slots, kv) * kv;
    int64_t blocks = (p.n_pixels + per_cta - 1) / per_cta;
    if (blocks > (int64_t)sms * waves) blocks = (int64_t)sms * waves;
    if (blocks > rows) blocks = rows;
    if (blocks < 1) blocks = 1;  // no pixels: one CTA writes the zeros
    kernel<<<(int)blocks, threads, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return err;
}

}  // namespace

// Plain C interface, loaded with ctypes.  `entry`: 0 float32 logits, 1
// bf16 logits (both (N, channels, H*W) with n_pixels = N*H*W), 2 int32
// labels (hw = n_pixels, channels unused).  `ticket`: one unsigned of
// device memory that is 0 (the kernel leaves it 0) and that no call on
// another stream uses at the same time.  `partials`: partial_ints int32 of
// device memory, 16-byte aligned, any contents (the CTAs' rows).  `out`:
// (3, num_classes) float32, written by the kernel.  `instance` receives
// the kernel instance launched: entry * 100 + register slots (0: shared
// bins) * 10 + 1 for 16-byte packets.  Returns the cudaError_t of the
// launch (0 on success); pointers are device pointers on `device`, and
// the kernel runs on `stream`.
extern "C" {

int confusion_histograms(int entry, const void* src, const int32_t* gt,
                         int64_t n_pixels, int64_t hw, int channels,
                         int num_classes, int ignore_index, unsigned* ticket,
                         int32_t* partials, int64_t partial_ints, float* out,
                         int device, void* stream, int* instance) {
  Params p{};
  p.src = src;
  p.gt = gt;
  p.n_pixels = n_pixels;
  p.hw = hw;
  p.channels = channels;
  p.num_classes = num_classes;
  p.ignore_index = ignore_index;
  p.ticket = ticket;
  p.partials = partials;
  p.out = out;
  return (int)launch(entry, p, partial_ints, device, (cudaStream_t)stream,
                     instance);
}

const char* confusion_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
