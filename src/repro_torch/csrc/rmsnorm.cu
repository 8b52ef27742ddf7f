// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// `rmsnorm_fwd` (pallas_call at :35): y = x * rsqrt(mean(x^2) + eps) * w,
// or * (1 + w) under unit_offset, summed in fp32 and cast back to x's dtype.
//
// Bound on the H100: bytes.  A row does ~4 operations per element, far
// below the ~295 operations per byte where the card stops being
// memory-bound, so the least time is (rows*D reads + rows*D writes) over
// 3.35 TB/s.  Design, for any width of whole 16-byte vectors up to 2048 of
// them (16384 bf16, 8192 fp32 elements; `Shape` below):
//  * Each row is read from memory once and held in registers: by a part of
//    a warp (up to 32 vectors), a warp, or a few warps that add their partial
//    sums of squares in shared memory, so that no lane holds more than 4
//    vectors (and w's fp32 copy): few registers, so many warps keep loads in
//    flight.
//  * Every load and store is 16 bytes, a lane's vectors all issued before
//    the first is used.
//  * w (plus the unit offset) is loaded once per warp, as 16-byte vectors,
//    and kept in fp32 registers while the warp walks its rows in a
//    grid-stride loop; the grid holds as many blocks as fit on the card.
// A wider row, a width that is not whole vectors, or an unaligned pointer
// takes a generic kernel: one warp per row, two passes over the row (the
// second mostly from L1/L2), 16-byte loads where D and the pointers allow.
// Any row count runs, without padding (the TPU kernel pads rows to 8).
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

// ---- rows in registers -----------------------------------------------------
// How a row of n 16-byte vectors is spread, chosen on the host from D: each
// of `lanes` lanes (a power of two) of `warps` warps holds at most kVpl
// vectors, vector first + j * lanes * warps for j < kVpl where it is < n; a
// warp holds 32 / lanes rows; a block holds `groups` row groups of `warps`
// warps, about 256 threads.
constexpr int kMaxVpl = 4;
constexpr int kMaxWarps = 16;  // 512 threads: kMaxVpl * 32 * 16 = 2048 vectors

struct Shape {
  int lanes, warps, groups, vpl;
  __host__ __device__ int threads() const { return 32 * warps * groups; }
  __host__ __device__ int rows_per_block() const { return groups * (32 / lanes); }
};

// false when n vectors need more than kMaxWarps warps
bool shape_for(int n, Shape& s) {
  if (n <= 32) {
    s.lanes = 1;
    while (s.lanes < n) s.lanes *= 2;
    s.warps = 1;
  } else {
    s.lanes = 32;
    s.warps = (n + 32 * kMaxVpl - 1) / (32 * kMaxVpl);
  }
  if (s.warps > kMaxWarps) return false;
  s.vpl = (n + s.lanes * s.warps - 1) / (s.lanes * s.warps);
  s.groups = s.warps >= 8 ? 1 : 8 / s.warps;
  return true;
}

// One 16-byte vector of T as fp32, and back.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    f[j] = to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    e[j] = from_f32<T>(f[j]);
  return raw;
}

template <typename T, typename W, int kVpl>
__global__ void __launch_bounds__(32 * kMaxWarps)
    rmsnorm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        T* __restrict__ y, long long rows, int d, Shape sh,
                        float eps, float offset) {
  constexpr int V = 16 / sizeof(T);     // elements per vector
  const int n = d / V;                   // vectors per row
  const int step = sh.lanes * sh.warps;  // vectors between a lane's
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / sh.warps;
  const int wi = warp % sh.warps;        // warp within its row group
  const int sub = lane / sh.lanes;       // row within the warp
  const int first = wi * sh.lanes + lane % sh.lanes;  // first vector
  const int rows_per_block = sh.rows_per_block();

  // this lane's columns of w, once (0 past the row's end)
  float wf[kVpl][V];
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int e0 = (first + j * step) * V;
    if (first + j * step >= n) {
#pragma unroll
      for (int t = 0; t < V; ++t) wf[j][t] = 0.f;
    } else if constexpr (sizeof(W) == sizeof(T)) {
      unpack<W>(*reinterpret_cast<const uint4*>(w + e0), wf[j]);
    } else {  // fp32 w under bf16 x: V fp32 values are V / 4 vectors
#pragma unroll
      for (int u = 0; u < V / 4; ++u)
        unpack<float>(*reinterpret_cast<const uint4*>(w + e0 + 4 * u),
                      wf[j] + 4 * u);
    }
#pragma unroll
    for (int t = 0; t < V; ++t) wf[j][t] += offset;
  }

  __shared__ float part[2][kMaxWarps];
  int buf = 0;
  // the loop bound is the same for every thread of the block, so the
  // barrier below is reached by all
  for (long long base = static_cast<long long>(blockIdx.x) * rows_per_block;
       base < rows;
       base += static_cast<long long>(gridDim.x) * rows_per_block) {
    const long long row = base + group * (32 / sh.lanes) + sub;
    const bool valid = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 raw[kVpl];
#pragma unroll
    for (int j = 0; j < kVpl; ++j)
      raw[j] = valid && first + j * step < n ? xr[first + j * step]
                                             : make_uint4(0, 0, 0, 0);

    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kVpl; ++j) {
      float f[V];
      unpack<T>(raw[j], f);
#pragma unroll
      for (int t = 0; t < V; ++t) ss = fmaf(f[t], f[t], ss);
    }
    for (int off = sh.lanes / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (sh.warps > 1) {
      // two buffers: a warp that runs ahead to the next row writes the
      // other one, and cannot come back to this one before every warp has
      // passed the next barrier
      if (lane == 0) part[buf][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < sh.warps; ++i) ss += part[buf][group * sh.warps + i];
      buf ^= 1;
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

    if (valid) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
      for (int j = 0; j < kVpl; ++j) {
        if (first + j * step >= n) continue;
        float f[V];
        unpack<T>(raw[j], f);
#pragma unroll
        for (int t = 0; t < V; ++t) f[t] = f[t] * inv * wf[j][t];
        yr[first + j * step] = pack<T>(f);
      }
    }
  }
}

template <typename T, typename W, int kVpl>
cudaError_t launch_rows(const void* x, const void* w, void* y, long long rows,
                        int d, const Shape& sh, float eps, float offset,
                        cudaStream_t stream) {
  // as many blocks as fit on the card at once (the same on every card of
  // one process), each walking its rows with w in registers; one count per
  // block size
  static std::atomic<int> resident[kMaxWarps + 1];
  const int key = sh.threads() / 32;
  int fit = resident[key].load(std::memory_order_relaxed);
  if (fit == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_rows_kernel<T, W, kVpl>, sh.threads(), 0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
    resident[key].store(fit, std::memory_order_relaxed);
  }
  const long long need =
      (rows + sh.rows_per_block() - 1) / sh.rows_per_block();
  const unsigned grid = static_cast<unsigned>(need < fit ? need : fit);
  rmsnorm_rows_kernel<T, W, kVpl><<<grid, sh.threads(), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      rows, d, sh, eps, offset);
  return cudaGetLastError();
}

// ---- any width -------------------------------------------------------------
constexpr int kWarpsPerBlock = 8;

template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ y, long long rows, int d, float eps,
               float offset) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together: no barrier below
  const T* xr = x + row * d;
  T* yr = y + row * d;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector

  float ss = 0.f;
  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / V; i += 32) {
      float f[V];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / V; i += 32) {
      float f[V];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < V; ++j)
        f[j] = f[j] * inv * (to_f32(w[i * V + j]) + offset);
      yv[i] = pack<T>(f);
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * (to_f32(w[i]) + offset));
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, float offset, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  constexpr int V = 16 / sizeof(T);
  Shape sh;
  if (aligned && d % V == 0 && shape_for(d / V, sh)) {
#define ROWS(VPL) \
  launch_rows<T, W, VPL>(x, w, y, rows, d, sh, eps, offset, stream)
    switch (sh.vpl) {
      case 1: return ROWS(1);
      case 2: return ROWS(2);
      case 3: return ROWS(3);
      default: return ROWS(4);
    }
#undef ROWS
  }
  const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  if (d % V == 0 && (reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) % 16 == 0)
    rmsnorm_kernel<T, W, true><<<grid, block, 0, stream>>>(xp, wp, yp, rows, d,
                                                           eps, offset);
  else
    rmsnorm_kernel<T, W, false><<<grid, block, 0, stream>>>(xp, wp, yp, rows,
                                                            d, eps, offset);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous in x_dtype; w: (d,) in w_dtype, which is fp32
// or x_dtype.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported input).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y,
                           long long rows, int d, float eps, int unit_offset,
                           int x_dtype, int w_dtype, void* stream) {
  using repro::kBF16;
  using repro::kF32;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float off = unit_offset != 0 ? 1.f : 0.f;
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch<float, float>(x, w, y, rows, d, eps, off, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, off, s);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, off, s);
  return cudaErrorInvalidValue;
}
