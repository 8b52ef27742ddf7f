// Per-128-chunk quantize / dequantize of a flat wire buffer, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quant/kernel.py:
//   `quant_fwd`   (pallas_call at :54): per chunk of QCHUNK = 128 elements
//       scale = absmax * f32(1/QMAX)  (1.0 for an all-zero chunk)
//       y     = clip(x / scale, -QMAX, QMAX)
//       q     = e4m3(y) or int8(round-half-even(y))             (RTN), or
//               the stochastic rounding of kernels/quant/ref.py (SR):
//               h = hash_u32(seed + flat index); fp8 adds h >> 12 to the
//               f32 magnitude bits and masks 0xFFF00000; int8 takes
//               floor(y + (h >> 8) * 2^-24)
//   `dequant_fwd` (pallas_call at :83): out = q * scale.
// The codec must equal the plain version bit for bit (the same wire bytes,
// scales and decoded values), so every rounding step is explicit: IEEE
// divide (__fdiv_rn), no FMA contraction (__fmul_rn / __fadd_rn), the
// round-to-nearest-even e4m3 conversion after the +-448 clip, rintf for
// int8, and the SR bit tricks on the f32 bit pattern.  The build has no
// --use_fast_math.
//
// Differences from the TPU kernels, on purpose:
//  * The input is the caller's flat f32 or bf16 buffer at its true length
//    n: loads past n read as zero, so no padded copy is made (the TPU
//    wrapper pads to (8k, 128) rows).  q and the scales cover the padded
//    (ceil(n / 128), 128) view, as the reference's.
//  * The SR seed (the wraparound u32 sum of the buffer's f32 bits) is made
//    on the card by `quant_seed` into a device scalar that `quant_fwd`
//    reads (| 1), so a quantized step never waits for the host.  The
//    reference computes it with jnp before its kernel.
//  * `dequant_fwd` writes the caller's dtype (f32 or bf16) straight from
//    the f32 product, which is the reference's f32 output cast afterwards.
//
// Bound on the H100: bytes.  quant reads 4n (f32) or 2n (bf16) and writes
// n + n/32; dequant reads n + n/32 and writes 4n or 2n; a few tens of
// integer and float operations an element are far under the card's
// operations-per-byte line.  Layout: one warp per chunk, each lane holding
// 4 contiguous elements (one 16-byte f32 or 8-byte bf16 load when the chunk
// is whole and aligned), absmax by warp shuffles, one 4-byte store of wire
// bytes per lane, lane 0 writes the scale.
#include <cuda_fp8.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 8;  // chunks per block
constexpr int kThreads = 32 * kWarps;
enum Codec : int { kFp8 = 0, kInt8 = 1 };

__device__ __forceinline__ uint32_t hash_u32(uint32_t idx, uint32_t seed) {
  uint32_t h = seed + idx * 2654435761u;  // wraps mod 2^32 by definition
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float clip(float y, float lim) {
  return fminf(fmaxf(y, -lim), lim);
}

__device__ __forceinline__ void load4(const float* x, long long base,
                                      long long n, bool vec, float v[4]) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(x + base);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = base + j < n ? x[base + j] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* x, long long base,
                                      long long n, bool vec, float v[4]) {
  if (vec) {  // 4 bf16 in 8 bytes, little-endian: element 0 in the low half
    const uint2 t = *reinterpret_cast<const uint2*>(x + base);
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xFFFF0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = base + j < n ? repro::to_f32(x[base + j]) : 0.f;
  }
}

__device__ __forceinline__ uint8_t encode(float x, float scale, float qmax,
                                          int codec, bool stochastic,
                                          uint32_t h) {
  float y = clip(__fdiv_rn(x, scale), qmax);
  if (codec == kFp8) {
    if (stochastic) {
      const uint32_t bits = __float_as_uint(y);
      const uint32_t mag = ((bits & 0x7FFFFFFFu) + (h >> 12)) & 0xFFF00000u;
      y = clip(__uint_as_float((bits & 0x80000000u) | mag), 448.f);
    }
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  }
  float r;
  if (stochastic) {
    const float u = __fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-08f);
    r = floorf(__fadd_rn(y, u));
  } else {
    r = rintf(y);  // round half to even, as jnp.round / torch.round
  }
  return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(
      clip(r, 127.f))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, long long n, long long m, int codec,
             int stochastic, const uint32_t* __restrict__ seed_ptr, float qmax,
             float inv_qmax, bool aligned, uint32_t* __restrict__ q,
             float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const uint32_t seed = stochastic ? (*seed_ptr | 1u) : 0u;
  for (long long c = blockIdx.x * static_cast<long long>(kWarps) +
                     (threadIdx.x >> 5);
       c < m; c += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = c * kChunk + lane * 4;
    float v[4];
    load4(x, base, n, aligned && (c + 1) * kChunk <= n, v);
    float a = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                    fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int o = 16; o; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    const float scale = a > 0.f ? __fmul_rn(a, inv_qmax) : 1.f;
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t h =
          stochastic ? hash_u32(static_cast<uint32_t>(base + j), seed) : 0u;
      packed |= static_cast<uint32_t>(
                    encode(v[j], scale, qmax, codec, stochastic != 0, h))
                << (8 * j);
    }
    q[c * 32 + lane] = packed;
    if (lane == 0) scales[c] = scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seed_kernel(const T* __restrict__ x, long long n, uint32_t* seed) {
  uint32_t s = 0;  // u32 sums wrap mod 2^32, in any order
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    s += __float_as_uint(repro::to_f32(x[i]));
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __shared__ uint32_t part[kWarps];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w];
    atomicAdd(seed, t);
  }
}

__device__ __forceinline__ float decode(uint32_t b, int codec) {
  if (codec == kFp8) {
    __nv_fp8_e4m3 t;
    t.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(t);  // exact
  }
  return static_cast<float>(static_cast<int8_t>(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint32_t* __restrict__ q,
               const float* __restrict__ scales, long long n, long long m,
               int codec, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (long long c = blockIdx.x * static_cast<long long>(kWarps) +
                     (threadIdx.x >> 5);
       c < m; c += static_cast<long long>(gridDim.x) * kWarps) {
    const float s = scales[c];
    const uint32_t packed = q[c * 32 + lane];
    const long long base = c * kChunk + lane * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < n)
        out[base + j] = repro::from_f32<T>(
            __fmul_rn(decode((packed >> (8 * j)) & 0xFFu, codec), s));
  }
}

unsigned grid_for(long long items, int per_block, int sms) {
  const long long want = (items + per_block - 1) / per_block;
  const long long cap = 32LL * sms;
  return static_cast<unsigned>(want < cap ? want : cap);
}

bool aligned_to(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// seed (a u32 in device memory) = wraparound sum of the f32 bits of x[0:n]
// (f32 or bf16).  Zeroes it first, then launches on `stream`.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for n <= 0 or a bad dtype).
extern "C" int quant_seed(const void* x, int dtype, long long n,
                          uint32_t* seed, int sms, void* stream) {
  if (n <= 0 || sms <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(seed, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  const unsigned grid = grid_for(n, kThreads, sms);
  if (dtype == repro::kF32)
    seed_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                          seed);
  else if (dtype == repro::kBF16)
    seed_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, seed);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// x: (n,) f32 or bf16 -> q: (ceil(n/128), 128) wire bytes (codec 0 = e4m3,
// 1 = int8), scales: (ceil(n/128),) f32.  stochastic != 0 reads the seed
// (| 1) from device memory.  qmax and inv_qmax = f32(1 / qmax) come from
// the caller, rounded as the reference's Python floats are.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int quant_fwd(const void* x, int dtype, long long n, int codec,
                         int stochastic, const uint32_t* seed, float qmax,
                         float inv_qmax, void* q, float* scales, int sms,
                         void* stream) {
  if (n <= 0 || sms <= 0 || (codec != kFp8 && codec != kInt8) ||
      (stochastic && seed == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long m = (n + kChunk - 1) / kChunk;
  const unsigned grid = grid_for(m, kWarps, sms);
  auto* qw = static_cast<uint32_t*>(q);
  if (dtype == repro::kF32)
    quant_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), n, m, codec, stochastic, seed, qmax,
        inv_qmax, aligned_to(x, 16), qw, scales);
  else if (dtype == repro::kBF16)
    quant_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, m, codec, stochastic, seed,
        qmax, inv_qmax, aligned_to(x, 8), qw, scales);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// q: (ceil(n/128), 128) wire bytes, scales: (ceil(n/128),) f32 ->
// out: (n,) f32 or bf16 (dtype code) = q * scale, rounded once to out's
// dtype.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int dequant_fwd(const void* q, const float* scales, int codec,
                           long long n, void* out, int dtype, int sms,
                           void* stream) {
  if (n <= 0 || sms <= 0 || (codec != kFp8 && codec != kInt8))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long m = (n + kChunk - 1) / kChunk;
  const unsigned grid = grid_for(m, kWarps, sms);
  const auto* qw = static_cast<const uint32_t*>(q);
  if (dtype == repro::kF32)
    dequant_kernel<<<grid, kThreads, 0, s>>>(qw, scales, n, m, codec,
                                             static_cast<float*>(out));
  else if (dtype == repro::kBF16)
    dequant_kernel<<<grid, kThreads, 0, s>>>(
        qw, scales, n, m, codec, static_cast<__nv_bfloat16*>(out));
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
