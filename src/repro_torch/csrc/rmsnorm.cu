// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// `rmsnorm_fwd` (pallas_call at :35): y = x * rsqrt(mean(x^2) + eps) * w,
// or * (1 + w) under unit_offset, summed in fp32 and cast back to x's dtype.
//
// Bound on the H100: bytes.  A row does ~4 operations per element, far
// below the ~295 operations per byte where the card stops being
// memory-bound, so the least time is (rows*D reads + rows*D writes) over
// 3.35 TB/s.  Design: one warp per row and no shared memory or block-level
// barrier, so any row count runs without padding (the TPU kernel pads rows
// to 8).  Loads are 16 bytes per lane when D and the pointers allow it.
// The second pass re-reads the row, which at D <= 7168 (14 KB in bf16) is
// still in L1/L2, so device memory sees each byte about once.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kWarpsPerBlock = 8;

template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ y, long long rows, int d, float eps,
               bool unit_offset) {
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
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
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
  const float offset = unit_offset ? 1.f : 0.f;

  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / V; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j)
        r[j] = from_f32<T>(to_f32(e[j]) * inv * (to_f32(w[i * V + j]) + offset));
      yv[i] = res;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * (to_f32(w[i]) + offset));
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, bool unit_offset, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, W, true><<<grid, block, 0, stream>>>(xp, wp, yp, rows, d,
                                                           eps, unit_offset);
  else
    rmsnorm_kernel<T, W, false><<<grid, block, 0, stream>>>(xp, wp, yp, rows,
                                                            d, eps, unit_offset);
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
  const bool uo = unit_offset != 0;
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch<float, float>(x, w, y, rows, d, eps, uo, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, uo, s);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, uo, s);
  return cudaErrorInvalidValue;
}
