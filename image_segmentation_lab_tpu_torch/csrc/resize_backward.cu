// Bilinear resize backward, CUDA C++ for sm_90a: the gradient of
// F.interpolate(x, size, mode="bilinear", align_corners) with respect to
// its NCHW input x, in two separable passes through shared memory, with no
// atomics.
//
// Replaces, on the port's path, PyTorch's own upsample_bilinear2d backward,
// which scatters with atomicAdd (rounding every add to bf16 for bf16
// tensors), so two calls give other bits.  The JAX package's resize
// (image_segmentation_lab_tpu/utils/ops.py::resize_bilinear; no Pallas
// kernel, XLA transposes its gathers) interpolates in float32 and casts
// once, so its gradient is the float32 gradient rounded once.
//
// The forward is separable: y[o, p] = sum_i sum_j A[o, i] B[p, j] x[i, j],
// where row o of A (and p of B) holds the two lerp weights of output o.
// So, per plane,
//   h[o, j]  = sum_p B[p, j] g[o, p]     (the W pass, ascending p)
//   dx[i, j] = sum_o A[o, i] h[o, j]     (the H pass, ascending o),
// each partial h[o, j] computed once and read by every input row that taps
// output row o.  The weights are F.interpolate's forward's, in float32
// (ops/resize_backward.py::axis_table, from which the host builds this
// kernel's tables); the outputs that read one input index are consecutive.
// Every step is rounded (no fused multiply-add), the partials are float32
// and dx is written once in g's dtype, so the plain version, which takes
// the same steps in the same order, gives the same bits, a second call gives
// them again, and a bf16 dx is the float32 dx rounded once.
//
// Tiles.  A tile is a band of input rows of one plane, or several whole
// planes where planes are small, and the contiguous band of g rows that
// those input rows tap; the host plans them (ops/resize_backward.py::_plan)
// so that the tables, two stages of g, the partials and the dx tile fit in
// 72 KB (three CTAs an SM).  Where even one input row's g rows do not fit
// two stages (wide rows at a large upsample, or a 1-pixel input read by a
// large plane), the band is staged in parts of a few g rows, whose W passes
// fill the tile's partials one after another.  The CTAs are persistent and
// loop over the tiles.  Each stages its next part (most often the next
// tile's whole band) with cp.async (4-byte copies, one commit group a part)
// while it reduces the current one, and waits for it only at the next
// part.  A staged g row lies at an odd pitch in 4-byte words (a bf16 row
// shifted by the parity of its first element), so that lanes on
// consecutive rows read one column from 32 banks; TMA copies 16-byte
// aligned rows, whose pitch would put 4 of those lanes on one bank.  The
// dx tile is built in shared memory and copied out, contiguous, with
// 16-byte stores.
//
// Each pass sums an axis one of two ways (the host picks, per axis):
// - by input index (kSums), where inputs have more than two taps (an
//   upsample): a unit sums the taps of 4 input indices (4 columns of one
//   row in the W pass, the rows on consecutive lanes; 4 rows of one column
//   in the H pass, the columns on consecutive lanes), interleaved, with the
//   weights read from a table in shared memory 4 at a time;
// - by a scan over the outputs (kScan), where no input has more than two
//   taps (a downsample): a unit walks the outputs that read a chunk of
//   input indices, reads each once, and carries the running sums of two
//   inputs, storing each input's sum when the scan has passed its taps.
// A 1-pixel input read by a whole plane (DeepLabV3's image pool: 1 x 1 ->
// 80 x 80) is split the same way: each thread sums one output row's 80
// column taps, then one thread the 80 row partials; no thread runs more
// taps in series than one axis has.
//
// What bounds it on the card: bytes.  It reads g once (a band's edge rows
// twice, from the L2) and writes dx once; an upsample by s costs about
// 2 + 2/s multiply-adds an element of g, far under the card's operations a
// byte.  On an H100 the wide upsamples stay 2-8x over that bound
// (PERF.md): the staging alone runs at it, and the two passes, which each
// CTA runs after its staging, issue slowly.  Indices are 32-bit inside a
// tile and 64-bit across the tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
// the input columns of a W pass unit and the input rows of an H pass unit
// that sum their taps (kSums) together
constexpr int kCols = 4, kRows = 4;

// A thread's indices u, u + du, u + 2 du, ... (or steps of du + 1, where
// `next` is given a carry) as (q, r) = (u / n, u % n), stepped without a
// division a step
struct Steps {
  int n, q, r, dq, dr;
  __device__ __forceinline__ Steps(int n, int u, int du)
      : n(n), q(u / n), r(u % n), dq(du / n), dr(du % n) {}
  // the step; returns the carry into q (0 or 1) beyond dq
  __device__ __forceinline__ int next(int carry = 0) {
    q += dq;
    r += dr + carry;
    if (r < n) return 0;
    r -= n;
    ++q;
    return 1;
  }
};

// One axis's tables and how its pass sums: by input index (kSums) or by a
// scan over the output indices (kScan); ops/resize_backward.py::_axis.
// `table` is copied to shared memory at the start.
enum Method { kSums = 0, kScan = 1 };
struct Axis {
  int method;
  // kSums: a row of `stride` ints (a multiple of 4) for each input index:
  // its first output index, its number of taps, 2 ints of padding, then
  // the taps' float32 weights' bits.  kScan: 4 ints for each output
  // index: the lower input index it reads, that input's weight, the next
  // input's weight (0: none), 0; weights as float bits.
  const int* table;
  int table_words;
  int stride;
  // kScan: per chunk of `chunk` input indices, the first output index
  // that reads one of them and one past the last
  const int2* spans;
  int chunk;  // kScan: the input indices a unit takes
};

struct Params {
  int planes, in_h, in_w, out_h, out_w;
  Axis rows, cols;
  const int2* bands;  // per band: its first g row, its g rows
  int nbands, band_rows, tile_planes, ntiles;
  int rows_max;    // the most g rows of a band
  int stage_rows;  // the most g rows a stage holds
  int g_pitch;     // 4-byte words a staged g row, odd
  int h_pitch;     // floats a partial row, odd
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

// acc + w * x, each step rounded (no fused multiply-add)
__device__ __forceinline__ float tap(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

// kSums: kN input indices' sums at once, each over its taps in ascending
// order: sum[k] = sum over b < n[k] of w[k][b] * v[k][b * step].  w[k] is
// a 16-byte aligned row of weights in shared memory, read four at a time;
// the outputs that read one input index are consecutive.  The kN sums'
// loads and adds interleave, so a thread keeps kN chains in flight.
template <int kN, typename T>
__device__ __forceinline__ void sums(float (&sum)[kN],
                                     const float* const (&w)[kN],
                                     const T* const (&v)[kN],
                                     const int (&n)[kN], int step) {
  int most = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    sum[k] = 0.f;
    most = max(most, n[k]);
  }
  for (int b = 0; b < most; b += 4) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (b >= n[k]) continue;
      const float4 w4 = *reinterpret_cast<const float4*>(w[k] + b);
      const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (b + e < n[k])
          sum[k] = tap(sum[k], ws[e], to_float(v[k][(b + e) * step]));
    }
  }
}

// kScan: the sums of input indices [i0, i1), each over its taps in
// ascending order, store(i, sum) for each.  Output o is v[(o - base) *
// step]; it reads inputs taps[o].x (weight .y) and taps[o].x + 1 (weight
// .z, if not 0).  The scan walks o over span = the outputs that read an
// input of [i0, i1), reading each value once, with the running sums of the
// input it has reached and the next; an input's sum is stored once the
// scan has passed its last tap.  Where each input has one or two taps (a
// downsample) it reads and writes each value once, where the sums read
// each output once a tap and each input's table.
template <typename T, typename Store>
__device__ __forceinline__ void scan(const T* __restrict__ v, int base,
                                     int step,
                                     const int4* __restrict__ taps,
                                     int2 span, int i0, int i1,
                                     Store store) {
  float acc0 = 0.f, acc1 = 0.f;  // the sums of inputs ic and ic + 1
  int ic = i0;
  for (int o = span.x; o < span.y; ++o) {
    const int4 t = taps[o];
    const float x = to_float(v[(o - base) * step]);
    for (; ic < t.x; ++ic) {
      if (ic < i1) store(ic, acc0);
      acc0 = acc1;
      acc1 = 0.f;
    }
    if (t.x == ic) {
      acc0 = tap(acc0, __int_as_float(t.y), x);
      if (t.z != 0) acc1 = tap(acc1, __int_as_float(t.z), x);
    } else if (t.z != 0) {  // t.x == ic - 1: o's second input is ic
      acc0 = tap(acc0, __int_as_float(t.z), x);
    }
  }
  for (; ic < i1; ++ic) {
    store(ic, acc0);
    acc0 = acc1;
    acc1 = 0.f;
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// a tile's planes, input rows and g band
struct Tile {
  int plane0, planes, i_lo, in_rows, o_lo, o_rows;
  int64_t g_row0;  // its first g row, counted over all planes
  __device__ int rows() const { return planes * o_rows; }
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile tile;
  const int group = t / p.nbands, b = t - group * p.nbands;
  tile.plane0 = group * p.tile_planes;
  tile.planes = min(p.tile_planes, p.planes - tile.plane0);
  tile.i_lo = b * p.band_rows;
  tile.in_rows = min(p.band_rows, p.in_h - tile.i_lo);
  const int2 band = __ldg(p.bands + b);
  tile.o_lo = band.x;
  tile.o_rows = band.y;
  tile.g_row0 = (int64_t)tile.plane0 * p.out_h + band.x;
  return tile;
}

// A CTA's work, in order: each of its tiles t (blockIdx.x, then every
// gridDim.x-th), each staged in parts of at most stage_rows g rows
struct Part {
  int t, r0;  // the tile and the first of its g rows that the part holds
};

__device__ __forceinline__ Part next_part(const Params& p, const Tile& tile,
                                          Part c) {
  return c.r0 + p.stage_rows < tile.rows() ? Part{c.t, c.r0 + p.stage_rows}
                                           : Part{c.t + (int)gridDim.x, 0};
}

// the shift, in elements, of a staged g row: a bf16 row is copied from the
// 4-byte word that holds its first element
template <typename T>
__device__ __forceinline__ int row_shift(const Params& p, int64_t g_row) {
  return sizeof(T) == 4 ? 0 : (int)((g_row * p.out_w) & 1);
}

// Issue the cp.async copies of a part of a tile's g band into a stage:
// warps over rows, lanes over a row's 4-byte words.  More planes than one
// are whole planes, so the band is g rows g_row0 ... g_row0 + planes *
// o_rows - 1; the part is its rows r0 ... r0 + rows - 1.  A bf16 row's
// first and last word may hold an element of a neighbouring row or lie
// past the tensor's last element; such a word is 4-byte aligned and holds
// an element of g, so it lies in g's allocation.
template <typename T>
__device__ __forceinline__ void stage_band(const T* __restrict__ g, uint32_t stage,
                           const Params& p, const Tile& tile, int r0,
                           int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int64_t e0 = (tile.g_row0 + r0 + r) * p.out_w;
    const int shift = row_shift<T>(p, tile.g_row0 + r0 + r);
    const char* src = reinterpret_cast<const char*>(g + (e0 - shift));
    const int words = (int)(((p.out_w + shift) * sizeof(T) + 3) / 4);
    const uint32_t dst = stage + 4u * (uint32_t)(r * p.g_pitch);
    for (int k = lane; k < words; k += 32) cp_async4(dst + 4 * k, src + 4 * k);
  }
}

// The W pass of a part of a tile's g rows (r0 ... r0 + rows - 1, staged
// from row 0 of the stage): h[r, j] = sum over the column taps p of j
// (ascending) of w * g[r, p].  A unit is one staged row and kCols columns
// (a scan: cols.chunk), the rows on consecutive lanes; cols is the column
// table in shared memory.
template <typename T>
__device__ __forceinline__ void w_pass(const float* __restrict__ stage, float* __restrict__ h,
                       const int* __restrict__ cols, const Params& p,
                       const Tile& tile, int r0, int rows) {
  const int chunk = p.cols.method == kScan ? p.cols.chunk : kCols;
  const int units = rows * ((p.in_w + chunk - 1) / chunk);
  // a band that no output reads has no rows
  Steps step(max(rows, 1), threadIdx.x, kThreads);
  for (int u = threadIdx.x; u < units; u += kThreads, step.next()) {
    const int c = step.q, r = step.r;
    const T* row = reinterpret_cast<const T*>(stage + r * p.g_pitch) +
                   row_shift<T>(p, tile.g_row0 + r0 + r);
    float* out = h + (r0 + r) * p.h_pitch;
    const int j0 = c * chunk;
    if (p.cols.method == kScan) {
      scan(row, 0, 1, reinterpret_cast<const int4*>(cols),
           __ldg(p.cols.spans + c), j0, min(j0 + chunk, p.in_w),
           [out](int j, float sum) { out[j] = sum; });
      continue;
    }
    const float* w[kCols];
    const T* v[kCols];
    int n[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int* taps = cols + min(j0 + k, p.in_w - 1) * p.cols.stride;
      w[k] = reinterpret_cast<const float*>(taps + 4);
      v[k] = row + taps[0];
      n[k] = j0 + k < p.in_w ? taps[1] : 0;
    }
    float sum[kCols];
    sums<kCols>(sum, w, v, n, 1);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (j0 + k < p.in_w) out[j0 + k] = sum[k];
  }
}

// The H pass: dx[i, j] = sum over the row taps o of i (ascending) of
// w * h[o, j], in g's dtype into the tile's dx buffer at offset `shift`.
// A unit is one column and kRows input rows of the tile (a scan:
// rows.chunk), the columns on consecutive lanes; rows_table is the row
// table in shared memory.
template <typename T>
__device__ __forceinline__ void h_pass(const float* __restrict__ h, T* __restrict__ out,
                       int shift, const int* __restrict__ rows_table,
                       const Params& p, const Tile& tile) {
  const int chunk = p.rows.method == kScan ? p.rows.chunk : kRows;
  const int units = (tile.in_rows + chunk - 1) / chunk;
  const int n_units = tile.planes * units * p.in_w;
  // v as (t, j) = (v / in_w, v % in_w), and t as (q, kc) = (plane,
  // unit): t steps by step.dq and step's carry
  Steps step(p.in_w, threadIdx.x, kThreads);
  Steps plane(units, step.q, step.dq);
  for (int v = threadIdx.x; v < n_units;
       v += kThreads, plane.next(step.next())) {
    const int j = step.r, q = plane.q, kc = plane.r;
    // g row o of plane q is h row q * o_rows + o - o_lo; input row i is
    // row q * in_rows + i - i_lo of the dx tile
    const float* col = h + q * tile.o_rows * p.h_pitch + j;
    T* dst = out + shift + q * tile.in_rows * p.in_w + j;
    const int i0 = tile.i_lo + kc * chunk;
    const int i1 = min(i0 + chunk, tile.i_lo + tile.in_rows);
    if (p.rows.method == kScan) {
      const int i_lo = tile.i_lo, in_w = p.in_w;
      scan(col, tile.o_lo, p.h_pitch,
           reinterpret_cast<const int4*>(rows_table),
           __ldg(p.rows.spans + i0 / chunk), i0, i1,
           [dst, i_lo, in_w](int i, float sum) {
             dst[(i - i_lo) * in_w] = from_float<T>(sum);
           });
      continue;
    }
    const float* w[kRows];
    const float* x[kRows];
    int n[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int* taps = rows_table + min(i0 + k, i1 - 1) * p.rows.stride;
      w[k] = reinterpret_cast<const float*>(taps + 4);
      x[k] = col + max(taps[0] - tile.o_lo, 0) * p.h_pitch;
      n[k] = i0 + k < i1 ? taps[1] : 0;
    }
    float sum[kRows];
    sums<kRows>(sum, w, x, n, p.h_pitch);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (i0 + k < i1)
        dst[(i0 + k - tile.i_lo) * p.in_w] = from_float<T>(sum[k]);
  }
}

// copy the tile's dx (contiguous in dx from element e0) out of shared
// memory, 16 bytes a store where a whole aligned 16 bytes are the tile's
template <typename T>
__device__ __forceinline__ void copy_out(const T* tile_dx, int shift, T* __restrict__ dx,
                         int64_t e0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = (shift + n + kVec - 1) / kVec;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int lo = c * kVec - shift;
    if (lo >= 0 && lo + kVec <= n) {
      *reinterpret_cast<uint4*>(dx + e0 + lo) =
          *reinterpret_cast<const uint4*>(tile_dx + c * kVec);
    } else {
      for (int e = max(lo, 0); e < min(lo + kVec, n); ++e)
        dx[e0 + e] = tile_dx[shift + e];
    }
  }
}

// the shared memory's layout, in 4-byte words: the row and column tables,
// kStages stages of g, the partials, then the dx tile, 16-byte aligned
// (and 16 bytes for its shift); ops/resize_backward.py::_smem_bytes is the
// same
struct Layout {
  int tables, stage, h;
  __host__ __device__ explicit Layout(const Params& p)
      : tables(p.rows.table_words + p.cols.table_words),
        stage(p.stage_rows * p.g_pitch),
        h(p.tile_planes * p.rows_max * p.h_pitch) {}
  __host__ __device__ int dx_offset() const {
    return (tables + kStages * stage + h + 3) & ~3;
  }
};

// (kThreads, 1): ptxas otherwise held the float32 instance to 48 registers
// and spilled to the stack
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
resize_backward_kernel(const T* __restrict__ g, T* __restrict__ dx,
                       const Params p) {
  extern __shared__ uint4 smem[];
  const Layout layout(p);
  int* rows_table = reinterpret_cast<int*>(smem);
  int* cols_table = rows_table + p.rows.table_words;
  for (int k = threadIdx.x; k < layout.tables; k += kThreads)
    rows_table[k] = k < p.rows.table_words
                        ? __ldg(p.rows.table + k)
                        : __ldg(p.cols.table + (k - p.rows.table_words));
  float* stages = reinterpret_cast<float*>(smem) + layout.tables;
  float* h = stages + kStages * layout.stage;
  T* tile_dx =
      reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + layout.dx_offset());
  const uint32_t stage0 = (uint32_t)__cvta_generic_to_shared(stages);

  // two stages: the next part's copies are in flight while the current
  // one is reduced
  static_assert(kStages == 2, "one part ahead");
  Part cur{(int)blockIdx.x, 0};
  if (cur.t >= p.ntiles) return;
  Tile tile = tile_at(p, cur.t);
  stage_band(g, stage0, p, tile, 0, min(p.stage_rows, tile.rows()));
  cp_async_commit();
  for (int k = 0; cur.t < p.ntiles; ++k) {
    const Part ahead = next_part(p, tile, cur);
    const Tile ahead_tile =
        ahead.t == cur.t || ahead.t >= p.ntiles ? tile : tile_at(p, ahead.t);
    if (ahead.t < p.ntiles)
      stage_band(g, stage0 + 4u * (uint32_t)(((k + 1) % 2) * layout.stage),
                 p, ahead_tile, ahead.r0,
                 min(p.stage_rows, ahead_tile.rows() - ahead.r0));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the part is in; the last tile's dx is out
    const int rows = min(p.stage_rows, tile.rows() - cur.r0);
    w_pass<T>(stages + (k % 2) * layout.stage, h, cols_table, p, tile,
              cur.r0, rows);
    __syncthreads();  // the partials are in; the stage may be refilled
    if (cur.r0 + rows == tile.rows()) {  // the tile's last part
      const int64_t e0 =
          ((int64_t)tile.plane0 * p.in_h + tile.i_lo) * p.in_w;
      const int shift = (int)(e0 % (16 / (int)sizeof(T)));
      h_pass<T>(h, tile_dx, shift, rows_table, p, tile);
      __syncthreads();
      copy_out<T>(tile_dx, shift, dx, e0,
                  tile.planes * tile.in_rows * p.in_w);
    }
    cur = ahead;
    tile = ahead_tile;
  }
  cp_async_wait<0>();
}

// The launch's shared memory and grid: the CTAs that fit the card's SMs
// at that shared memory, queried once for each size and device, where
// the kernel's shared-memory limit is raised too
template <typename T>
int launch(const void* g, void* dx, const Params& p, cudaStream_t stream) {
  const auto kernel = resize_backward_kernel<T>;
  const int smem = 4 * Layout(p).dx_offset() +
                   p.tile_planes * p.band_rows * p.in_w * (int)sizeof(T) +
                   16;
  static std::mutex mutex;
  static int limit = 0, last_smem = -1, last_device = -1, ctas = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int blocks;
  {
    std::lock_guard<std::mutex> lock(mutex);
    if (smem > limit) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      limit = smem;
    }
    if (smem != last_smem || device != last_device) {
      int sms, per_sm;
      if ((err = cudaDeviceGetAttribute(
               &sms, cudaDevAttrMultiProcessorCount, device)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
      last_smem = smem;
      last_device = device;
      ctas = sms * max(per_sm, 1);
    }
    blocks = min(p.ntiles, ctas);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(g),
                                             static_cast<T*>(dx), p);
  return (int)cudaGetLastError();
}

Axis make_axis(int method, const void* table, int table_words, int stride,
               const void* spans, int chunk) {
  return Axis{method, static_cast<const int*>(table), table_words, stride,
              static_cast<const int2*>(spans), chunk};
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers: g
// is a contiguous (planes, out_h, out_w) tensor, 4-byte aligned, dx a
// contiguous (planes, in_h, in_w) one, 16-byte aligned, of the same dtype
// (0 float32, 1 bfloat16), each of fewer than 2^31 elements.  Per axis
// (rows, then columns; ops/resize_backward.py::_axis): the method
// (0 sums, 1 scan), its table and the table's ints, the sums table's
// stride, and the scan's spans and the input indices a unit takes (null
// and 0 for the sums); bands an (nbands, 2) int32 array: each band's first
// g row and g rows; the rest is the host's plan
// (ops/resize_backward.py::_plan).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" {

int resize_backward_bilinear(
    const void* g, void* dx, int dtype, int64_t planes, int in_h, int in_w,
    int out_h, int out_w, int row_method, const void* row_table,
    int row_words, int row_stride, const void* row_spans, int row_chunk,
    int col_method, const void* col_table, int col_words, int col_stride,
    const void* col_spans, int col_chunk, const void* bands, int nbands,
    int band_rows, int tile_planes, int rows_max, int stage_rows,
    int g_pitch, int h_pitch, void* stream) {
  if (planes * in_h * in_w == 0) return 0;
  if (planes * in_h * in_w > 0x7fffffff ||
      planes * out_h * out_w > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(g) & 3) ||
      (reinterpret_cast<uintptr_t>(dx) & 15) || tile_planes < 1 ||
      band_rows < 1 || stage_rows < 1 ||
      (row_method == kSums && row_stride % 4) ||
      (col_method == kSums && col_stride % 4) ||
      (row_method == kScan && row_chunk < 1) ||
      (col_method == kScan && col_chunk < 1) ||
      (tile_planes > 1 && band_rows != in_h) ||
      (row_method == kScan && band_rows < in_h && band_rows % row_chunk))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.planes = (int)planes;
  p.in_h = in_h;
  p.in_w = in_w;
  p.out_h = out_h;
  p.out_w = out_w;
  p.rows = make_axis(row_method, row_table, row_words, row_stride, row_spans,
                     row_chunk);
  p.cols = make_axis(col_method, col_table, col_words, col_stride, col_spans,
                     col_chunk);
  p.bands = static_cast<const int2*>(bands);
  p.nbands = nbands;
  p.band_rows = band_rows;
  p.tile_planes = tile_planes;
  p.ntiles = (int)((planes + tile_planes - 1) / tile_planes) * nbands;
  p.rows_max = rows_max;
  p.stage_rows = stage_rows;
  p.g_pitch = g_pitch;
  p.h_pitch = h_pitch;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(g, dx, p, s);
    case 1:
      return launch<__nv_bfloat16>(g, dx, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* resize_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
