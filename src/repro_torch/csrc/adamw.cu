// Fused AdamW update over one flat fp32 storage shard, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/adamw/kernel.py
// `adamw_flat` (pallas_call at :48):
//   g  = g * clip_scale
//   m  = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
//   p  = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
// with the bias correction for step t and decoupled weight decay.  The
// gradient clip scale, which the reference multiplies into g before the
// kernel, is fused in here.
//
// Differences from the TPU kernel, on purpose:
//  * lr, t and the clip scale are read from device memory (fp32, int32,
//    fp32 scalars), so a training step never waits for the host: the
//    schedule and the global norm stay on the card.  The TPU kernel takes
//    lr and t as (1,) operands of the call.
//  * p, m and v are updated in place (the JAX step donates its buffers to
//    the same effect), so the optimizer allocates nothing.
//  * No padding to the 1024-element block: a grid-stride loop takes any n.
//
// Bound on the H100: bytes.  Four fp32 reads and three fp32 writes per
// element against ~15 operations, far under the ~20 operations per byte
// where the card stops being memory-bound, so the least time is 28 n bytes
// over 3.35 TB/s.  Loads and stores are 16 bytes a thread when n and the
// pointers allow it.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded on the host
};

struct Step {
  float lr, scale, bc1, bc2;  // bc = 1 - b^t
};

__device__ __forceinline__ Step load_step(const float* lr, const int* t,
                                          const float* scale,
                                          const Hyper& h) {
  const float tf = static_cast<float>(*t);
  return Step{*lr, *scale, 1.f - powf(h.b1, tf), 1.f - powf(h.b2, tf)};
}

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Step& s, const Hyper& h) {
  g *= s.scale;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  const float mhat = m / s.bc1;
  const float vhat = v / s.bc2;
  p = p - s.lr * (mhat / (sqrtf(vhat) + h.eps) + h.wd * p);
}

__global__ void __launch_bounds__(kThreads)
adamw_vec_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                 float4* __restrict__ m, float4* __restrict__ v, long long n4,
                 const float* lr, const int* t, const float* scale, Hyper h) {
  const Step s = load_step(lr, t, scale, h);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    update(pp.x, gg.x, mm.x, vv.x, s, h);
    update(pp.y, gg.y, mm.y, vv.y, s, h);
    update(pp.z, gg.z, mm.z, vv.z, s, h);
    update(pp.w, gg.w, mm.w, vv.w, s, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v, long long n,
             const float* lr, const int* t, const float* scale, Hyper h) {
  const Step s = load_step(lr, t, scale, h);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    update(p[i], g[i], m[i], v[i], s, h);
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

// p, g, m, v: (n,) fp32, p/m/v updated in place; lr: fp32 scalar, t: int32
// scalar (the 1-based step), scale: fp32 scalar, all in device memory.
// omb1 = 1 - b1 and omb2 = 1 - b2 are rounded by the caller, as the
// reference's Python floats are.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (cudaErrorInvalidValue for n <= 0).
extern "C" int adamw_flat(float* p, const float* g, float* m, float* v,
                          long long n, const float* lr, const int* t,
                          const float* scale, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, int sms,
                          void* stream) {
  if (n <= 0 || sms <= 0) return cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(p) && aligned16(g) &&
                   aligned16(m) && aligned16(v);
  const long long items = vec ? n / 4 : n;
  // enough blocks to fill every SM several times; each loops over the rest
  const long long want = (items + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(want < 8LL * sms ? want : 8LL * sms);
  if (vec)
    adamw_vec_kernel<<<grid, kThreads, 0, s>>>(
        reinterpret_cast<float4*>(p), reinterpret_cast<const float4*>(g),
        reinterpret_cast<float4*>(m), reinterpret_cast<float4*>(v), items, lr,
        t, scale, h);
  else
    adamw_kernel<<<grid, kThreads, 0, s>>>(p, g, m, v, n, lr, t, scale, h);
  return cudaGetLastError();
}
