// Streaming cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/cross_entropy/kernel.py
// `xent_fwd` (pallas_call at :68) and `xent_bwd` (pallas_call at :98):
//   forward:  lse = log(sum_j exp(x_j)) with a running max, loss = lse - x_t,
//             both fp32, one pass over the row;
//   backward: dx_j = (exp(x_j - lse) - [j == t]) * g, in the logits' dtype.
// A target outside [0, V) contributes no target logit (loss = lse) and no
// one-hot term, as the TPU kernel's `col == t` test gives.
//
// Differences from the TPU kernel, on purpose:
//  * The TPU grid walks vocab blocks in order and carries (max, sum,
//    target logit) in scratch from one step to the next.  Blocks on the GPU
//    run in no order, so one block owns one row and loops over the whole
//    vocabulary itself; its threads keep private running (max, sum) pairs
//    that one warp-shuffle + shared-memory reduction merges at the end.
//  * Columns are masked on the true V: the loop simply stops there, so no
//    padded copy of the logits (5 GB at qwen3-1.7b's B 4 x T 2048 x 151936
//    fp32) is ever made.  The TPU wrapper pads rows to 8 and V to 2048.
//
// Bound on the H100: bytes.  The forward does ~4 operations per 4-byte
// element and the backward ~5, far under the card's ~20 fp32 operations per
// byte, so the least times are (R*V reads) and (R*V reads + R*V writes)
// over 3.35 TB/s.  Loads and stores are 16 bytes a thread when V and the
// pointers allow it.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr float kNegInf = -__builtin_huge_valf();

// Running (max, sum of exp(x - max)) of one thread.
struct MaxSum {
  float m = kNegInf;
  float s = 0.f;
  __device__ void add(float x) {
    if (x == kNegInf) return;  // exp(-inf) adds nothing
    if (x <= m) {
      s += expf(x - m);
    } else {
      s = s * expf(m - x) + 1.f;
      m = x;
    }
  }
  __device__ void merge(float om, float os) {
    if (om == kNegInf) return;
    if (m == kNegInf) {
      m = om;
      s = os;
      return;
    }
    const float nm = fmaxf(m, om);
    s = s * expf(m - nm) + os * expf(om - nm);
    m = nm;
  }
};

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements per 16-byte vector
};

template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const I* __restrict__ targets,
                float* __restrict__ loss, float* __restrict__ lse,
                long long V) {
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  MaxSum acc;
  if constexpr (kVec) {
    constexpr int N = Vec<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (long long i = threadIdx.x; i < V / N; i += kThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) acc.add(to_f32(e[j]));
    }
  } else {
    for (long long i = threadIdx.x; i < V; i += kThreads)
      acc.add(to_f32(xr[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, acc.m, off);
    const float os = __shfl_xor_sync(0xffffffffu, acc.s, off);
    acc.merge(om, os);
  }
  __shared__ float sm[kThreads / 32], ss[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = acc.m;
    ss[warp] = acc.s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    MaxSum tot;
    for (int w = 0; w < kThreads / 32; ++w) tot.merge(sm[w], ss[w]);
    const float l = logf(fmaxf(tot.s, 1e-30f)) + tot.m;
    const long long t = static_cast<long long>(targets[row]);
    const float tl = (t >= 0 && t < V) ? to_f32(xr[t]) : 0.f;
    lse[row] = l;
    loss[row] = l - tl;
  }
}

template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const I* __restrict__ targets,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dx, long long V) {
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const float l = lse[row], gr = g[row];
  const long long t = static_cast<long long>(targets[row]);
  if constexpr (kVec) {
    constexpr int N = Vec<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* dv = reinterpret_cast<uint4*>(dr);
    for (long long i = threadIdx.x; i < V / N; i += kThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float hot = (i * N + j == t) ? 1.f : 0.f;
        r[j] = from_f32<T>((expf(to_f32(e[j]) - l) - hot) * gr);
      }
      dv[i] = res;
    }
  } else {
    for (long long i = threadIdx.x; i < V; i += kThreads) {
      const float hot = (i == t) ? 1.f : 0.f;
      dr[i] = from_f32<T>((expf(to_f32(xr[i]) - l) - hot) * gr);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename I>
cudaError_t fwd(const void* x, const void* t, float* loss, float* lse,
                long long R, long long V, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const I* tp = static_cast<const I*>(t);
  if (V % Vec<T>::kN == 0 && aligned16(x))
    xent_fwd_kernel<T, I, true><<<R, kThreads, 0, s>>>(xp, tp, loss, lse, V);
  else
    xent_fwd_kernel<T, I, false><<<R, kThreads, 0, s>>>(xp, tp, loss, lse, V);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t bwd(const void* x, const void* t, const float* lse,
                const float* g, void* dx, long long R, long long V,
                cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const I* tp = static_cast<const I*>(t);
  T* dp = static_cast<T*>(dx);
  if (V % Vec<T>::kN == 0 && aligned16(x) && aligned16(dx))
    xent_bwd_kernel<T, I, true><<<R, kThreads, 0, s>>>(xp, tp, lse, g, dp, V);
  else
    xent_bwd_kernel<T, I, false><<<R, kThreads, 0, s>>>(xp, tp, lse, g, dp,
                                                         V);
  return cudaGetLastError();
}

}  // namespace

// logits: (R, V) contiguous in `dtype` (fp32 or bf16); targets: (R,) int32
// (t_is_i64 = 0) or int64 (1); loss, lse: (R,) fp32.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue for
// an unsupported input).
extern "C" int xent_fwd(const void* logits, const void* targets, float* loss,
                        float* lse, long long R, long long V, int dtype,
                        int t_is_i64, void* stream) {
  if (R <= 0 || R > 0x7fffffffLL || V <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return t_is_i64 ? fwd<float, long long>(logits, targets, loss, lse, R, V, s)
                    : fwd<float, int>(logits, targets, loss, lse, R, V, s);
  if (dtype == repro::kBF16)
    return t_is_i64
               ? fwd<__nv_bfloat16, long long>(logits, targets, loss, lse, R,
                                               V, s)
               : fwd<__nv_bfloat16, int>(logits, targets, loss, lse, R, V, s);
  return cudaErrorInvalidValue;
}

// dlogits: (R, V) contiguous in the logits' dtype; lse, g: (R,) fp32; the
// other arguments as for xent_fwd.
extern "C" int xent_bwd(const void* logits, const void* targets,
                        const float* lse, const float* g, void* dlogits,
                        long long R, long long V, int dtype, int t_is_i64,
                        void* stream) {
  if (R <= 0 || R > 0x7fffffffLL || V <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return t_is_i64 ? bwd<float, long long>(logits, targets, lse, g, dlogits,
                                            R, V, s)
                    : bwd<float, int>(logits, targets, lse, g, dlogits, R, V,
                                      s);
  if (dtype == repro::kBF16)
    return t_is_i64 ? bwd<__nv_bfloat16, long long>(logits, targets, lse, g,
                                                    dlogits, R, V, s)
                    : bwd<__nv_bfloat16, int>(logits, targets, lse, g,
                                              dlogits, R, V, s);
  return cudaErrorInvalidValue;
}
