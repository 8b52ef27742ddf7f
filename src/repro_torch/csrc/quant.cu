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
// round-to-nearest-even e4m3 conversion after the +-448 clip (two values at
// a time, cvt.rn.satfinite.e4m3x2.f32, which rounds as the scalar
// conversion), rintf for int8, and the SR bit tricks on the f32 bit
// pattern.  The build has no --use_fast_math.
//
// Differences from the TPU kernels, on purpose:
//  * The input is the caller's flat f32 or bf16 buffer at its true length
//    n: loads past n read as zero, so no padded copy is made (the TPU
//    wrapper pads to (8k, 128) rows).  q and the scales cover the padded
//    (ceil(n / 128), 128) view, as the reference's.
//  * The SR seed (the wraparound u32 sum of the buffer's f32 bits, | 1) is
//    made on the card inside the SR launch itself, so a quantized step never
//    waits for the host.  The reference computes it with jnp before its
//    kernel.
//  * `dequant_fwd` writes the caller's dtype (f32 or bf16) straight from
//    the f32 product, which is the reference's f32 output cast afterwards.
//
// Bound on the H100: bytes.  quant reads 4n (f32) or 2n (bf16) and writes
// n + n/32; dequant reads n + n/32 and writes 4n or 2n; a few tens of
// integer and float operations an element are far under the card's
// operations-per-byte line.  quant's design follows from that:
//  * Loads.  Every lane loads 16 bytes a piece (4 f32 or 8 bf16; a chunk is
//    a warp in f32, half a warp in bf16, its absmax by shuffles within it)
//    and issues the loads of kUnroll pieces before it encodes the first, so
//    enough bytes are in flight to hold the HBM rate.
//  * SR needs the seed, a sum over all of x, before its first code, so x is
//    read twice.  It is two launches and no memset: a seed pass (one block
//    an SM, 32 warps, four 16-byte loads a lane in flight) writes one
//    partial sum a block, and every block of the quant kernel sums those
//    partials itself, in one order, before it encodes.  One cooperative
//    launch that keeps what fits of x in shared memory between the two
//    passes reads less from HBM but measured slower
//    (tools/quant_sr_one_launch.py): its encode pass starts only after the
//    last block's sum, and that pass is bound by its instructions (an IEEE
//    divide and a hash an element), not by bytes.
// dequant: one warp per chunk, each lane 4 contiguous elements.

#include <cuda_fp8.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 8;      // quant, dequant: warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;     // quant: 16-byte loads in flight a lane
constexpr int kSeedWarps = 32;    // the seed pass: warps a block,
constexpr int kSeedUnroll = 4;    // loads in flight a lane,
constexpr int kSeedBlocksPerSm = 1;  // blocks an SM
enum Codec : int { kFp8 = 0, kInt8 = 1 };

// A lane's piece of a warp step: 16 bytes of x, kV elements.  kLanes lanes
// make a chunk, so a warp step is kChunks whole chunks, kStep contiguous
// elements (f32: 4 a lane, a warp a chunk; bf16: 8 a lane, half a warp a
// chunk).
template <typename T>
struct Piece {
  static constexpr int kV = 16 / sizeof(T);
  static constexpr int kLanes = kChunk / kV;
  static constexpr int kChunks = 32 / kLanes;
  static constexpr int kStep = 32 * kV;
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t idx, uint32_t seed) {
  uint32_t h = seed + idx * 2654435761u;  // wraps mod 2^32 by definition
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float clip(float y, float lim) {
  return fminf(fmaxf(y, -lim), lim);
}

// A piece of x as its raw 16 bytes: one 16-byte load where x is 16-byte
// aligned and the piece lies below n, else element loads, zero past n.
__device__ __forceinline__ uint4 load_piece(const float* x, long long base,
                                            long long n, bool vec) {
  if (vec && base + 4 <= n)
    return __ldg(reinterpret_cast<const uint4*>(x + base));
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = base + j < n ? __float_as_uint(x[base + j]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load_piece(const __nv_bfloat16* x,
                                            long long base, long long n,
                                            bool vec) {
  if (vec && base + 8 <= n)
    return __ldg(reinterpret_cast<const uint4*>(x + base));
  const auto* e = reinterpret_cast<const uint16_t*>(x);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i in the low half
    const uint32_t lo = base + 2 * i < n ? e[base + 2 * i] : 0u;
    const uint32_t hi = base + 2 * i + 1 < n ? e[base + 2 * i + 1] : 0u;
    w[i] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the f32 bit patterns of a piece's values
__device__ __forceinline__ void unpack(uint4 r, uint32_t (&b)[4]) {
  b[0] = r.x;
  b[1] = r.y;
  b[2] = r.z;
  b[3] = r.w;
}
__device__ __forceinline__ void unpack(uint4 r, uint32_t (&b)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[2 * i] = w[i] << 16;
    b[2 * i + 1] = w[i] & 0xFFFF0000u;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t bits_sum(uint4 r) {
  uint32_t b[Piece<T>::kV];
  unpack(r, b);
  uint32_t s = 0;  // u32 sums wrap mod 2^32, in any order
#pragma unroll
  for (int j = 0; j < Piece<T>::kV; ++j) s += b[j];
  return s;
}

// four values at flat indices idx .. idx + 3 -> four wire bytes
template <int kCodec, bool kSR>
__device__ __forceinline__ uint32_t encode4(const float* v, uint32_t idx,
                                            float scale, float qmax,
                                            uint32_t seed) {
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = clip(__fdiv_rn(v[j], scale), qmax);
  if constexpr (kCodec == kFp8) {
    if constexpr (kSR) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t h = hash_u32(idx + j, seed);
        const uint32_t bits = __float_as_uint(y[j]);
        const uint32_t mag =
            ((bits & 0x7FFFFFFFu) + (h >> 12)) & 0xFFF00000u;
        y[j] = clip(__uint_as_float((bits & 0x80000000u) | mag), 448.f);
      }
    }
    // cvt.rn.satfinite.e4m3x2.f32: the first value in the low byte
    const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(y[0], y[1]),
                                                 __NV_SATFINITE, __NV_E4M3);
    const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(y[2], y[3]),
                                                 __NV_SATFINITE, __NV_E4M3);
    return lo | hi << 16;
  } else {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float r;
      if constexpr (kSR) {
        const uint32_t h = hash_u32(idx + j, seed);
        const float u =
            __fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-08f);
        r = floorf(__fadd_rn(y[j], u));
      } else {
        r = rintf(y[j]);  // round half to even, as jnp.round / torch.round
      }
      packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                    static_cast<int8_t>(static_cast<int>(clip(r, 127.f)))))
                << (8 * j);
    }
    return packed;
  }
}

// Encodes one lane's piece of warp step `step`: the chunk's absmax over its
// kLanes lanes, the scale, the wire bytes.  Every lane of the warp calls it
// (the shuffles); chunks at or past m are not written.
template <typename T, int kCodec, bool kSR>
__device__ __forceinline__ void encode_piece(uint4 raw, long long step,
                                             int lane, long long m,
                                             float qmax, float inv_qmax,
                                             uint32_t seed,
                                             uint8_t* __restrict__ q,
                                             float* __restrict__ scales) {
  using P = Piece<T>;
  uint32_t b[P::kV];
  unpack(raw, b);
  float v[P::kV];
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < P::kV; ++j) {
    v[j] = __uint_as_float(b[j]);
    a = j ? fmaxf(a, fabsf(v[j])) : fabsf(v[j]);
  }
#pragma unroll
  for (int o = P::kLanes / 2; o; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float scale = a > 0.f ? __fmul_rn(a, inv_qmax) : 1.f;
  const long long chunk = step * P::kChunks + lane / P::kLanes;
  if (chunk >= m) return;
  const long long base = step * P::kStep + lane * P::kV;
  uint32_t w[P::kV / 4];
#pragma unroll
  for (int j = 0; j < P::kV / 4; ++j)
    w[j] = encode4<kCodec, kSR>(v + 4 * j, static_cast<uint32_t>(base + 4 * j),
                                scale, qmax, seed);
  if constexpr (P::kV == 4)
    *reinterpret_cast<uint32_t*>(q + base) = w[0];
  else
    *reinterpret_cast<uint2*>(q + base) = make_uint2(w[0], w[1]);
  if (lane % P::kLanes == 0) scales[chunk] = scale;
}

// The SR seed's first pass: each block sums the f32 bits of its share of
// x's warp steps into partials[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(32 * kSeedWarps)
seed_kernel(const T* __restrict__ x, long long n, long long steps, bool vec,
            uint32_t* __restrict__ partials) {
  using P = Piece<T>;
  __shared__ uint32_t red[kSeedWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long stride =
      static_cast<long long>(gridDim.x) * kSeedWarps * kSeedUnroll;
  uint32_t sum = 0;  // u32 sums wrap mod 2^32, in any order
  for (long long s0 =
           (static_cast<long long>(blockIdx.x) * kSeedWarps + w) * kSeedUnroll;
       s0 < steps; s0 += stride) {
    uint4 raw[kSeedUnroll];
#pragma unroll
    for (int u = 0; u < kSeedUnroll; ++u)
      raw[u] = s0 + u < steps
                   ? load_piece(x, (s0 + u) * P::kStep + lane * P::kV, n, vec)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kSeedUnroll; ++u) sum += bits_sum<T>(raw[u]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red[w] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int i = 0; i < kSeedWarps; ++i) t += red[i];
    partials[blockIdx.x] = t;
  }
}

// Each warp takes kUnroll consecutive warp steps at a time, their loads
// issued before the first is encoded.  SR: every block first sums the seed
// pass's partials (in one order, so every block has the same seed = sum |
// 1; block 0 writes it to seed_out).
template <typename T, int kCodec, bool kSR>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, long long n, long long m, float qmax,
             float inv_qmax, bool vec, const uint32_t* __restrict__ partials,
             int n_partials, uint32_t* __restrict__ seed_out,
             uint8_t* __restrict__ q, float* __restrict__ scales) {
  using P = Piece<T>;
  const int lane = threadIdx.x & 31;
  uint32_t seed = 0;
  if constexpr (kSR) {
    __shared__ uint32_t seed_s;
    if (threadIdx.x < 32) {
      uint32_t t = 0;
      for (int b = lane; b < n_partials; b += 32) t += partials[b];
#pragma unroll
      for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) seed_s = t | 1u;
    }
    __syncthreads();
    seed = seed_s;
    if (blockIdx.x == 0 && threadIdx.x == 0 && seed_out) *seed_out = seed;
  }
  const long long steps = (m + P::kChunks - 1) / P::kChunks;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps *
                           kUnroll;
  for (long long s0 = (static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5)) * kUnroll;
       s0 < steps; s0 += stride) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = s0 + u < steps
                   ? load_piece(x, (s0 + u) * P::kStep + lane * P::kV, n, vec)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (s0 + u < steps)
        encode_piece<T, kCodec, kSR>(raw[u], s0 + u, lane, m, qmax, inv_qmax,
                                     seed, q, scales);
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

unsigned seed_grid(long long steps, int sms) {
  const long long want = (steps + kSeedWarps * kSeedUnroll - 1) /
                         (kSeedWarps * kSeedUnroll);
  const long long cap = static_cast<long long>(kSeedBlocksPerSm) * sms;
  return static_cast<unsigned>(want < cap ? want : cap);
}

template <typename T, int kCodec>
cudaError_t launch_quant(const T* x, long long n, bool stochastic,
                         float qmax, float inv_qmax, uint8_t* q,
                         float* scales, uint32_t* partials, int partials_len,
                         uint32_t* seed_out, int sms, cudaStream_t s) {
  const long long m = (n + kChunk - 1) / kChunk;
  const long long steps = (m + Piece<T>::kChunks - 1) / Piece<T>::kChunks;
  const bool vec = aligned_to(x, 16);
  const unsigned grid = grid_for(steps, kWarps * kUnroll, sms);
  if (!stochastic) {
    quant_kernel<T, kCodec, false><<<grid, kThreads, 0, s>>>(
        x, n, m, qmax, inv_qmax, vec, nullptr, 0, nullptr, q, scales);
    return cudaGetLastError();
  }
  const unsigned parts = seed_grid(steps, sms);
  if (partials == nullptr || static_cast<int>(parts) > partials_len)
    return cudaErrorInvalidValue;
  seed_kernel<T><<<parts, 32 * kSeedWarps, 0, s>>>(x, n, steps, vec,
                                                   partials);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  quant_kernel<T, kCodec, true><<<grid, kThreads, 0, s>>>(
      x, n, m, qmax, inv_qmax, vec, partials, static_cast<int>(parts),
      seed_out, q, scales);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_codec(const void* x, long long n, int codec,
                         bool stochastic, float qmax, float inv_qmax,
                         void* q, float* scales, uint32_t* partials,
                         int partials_len, uint32_t* seed_out, int sms,
                         cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  auto* qb = static_cast<uint8_t*>(q);
  return codec == kFp8
             ? launch_quant<T, kFp8>(xt, n, stochastic, qmax, inv_qmax, qb,
                                     scales, partials, partials_len,
                                     seed_out, sms, s)
             : launch_quant<T, kInt8>(xt, n, stochastic, qmax, inv_qmax, qb,
                                      scales, partials, partials_len,
                                      seed_out, sms, s);
}

}  // namespace

// The SR seed pass on a card of `sms` SMs: the most blocks it runs (the
// length `partials` needs) and the elements of dtype one pass of that grid
// covers.  Returns a cudaError_t.
extern "C" int quant_sr_plan(int dtype, int sms, int* blocks,
                             long long* pass_elems) {
  if (sms <= 0 || (dtype != repro::kF32 && dtype != repro::kBF16))
    return cudaErrorInvalidValue;
  *blocks = kSeedBlocksPerSm * sms;
  *pass_elems = static_cast<long long>(*blocks) * kSeedWarps * kSeedUnroll *
                (dtype == repro::kF32 ? Piece<float>::kStep
                                      : Piece<__nv_bfloat16>::kStep);
  return cudaSuccess;
}

// x: (n,) f32 or bf16 -> q: (ceil(n/128), 128) wire bytes (codec 0 = e4m3,
// 1 = int8), scales: (ceil(n/128),) f32.  qmax and inv_qmax = f32(1 / qmax)
// come from the caller, rounded as the reference's Python floats are.
// RTN is one launch.  stochastic != 0 is two: the seed pass into
// `partials` (u32 scratch of partials_len >= quant_sr_plan's blocks), then
// the quant kernel, which forms the seed from them and writes it (| 1) to
// seed_out where that is not null.  Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int quant_fwd(const void* x, int dtype, long long n, int codec,
                         int stochastic, float qmax, float inv_qmax, void* q,
                         float* scales, uint32_t* partials, int partials_len,
                         uint32_t* seed_out, int sms, void* stream) {
  if (n <= 0 || sms <= 0 || (codec != kFp8 && codec != kInt8) ||
      (stochastic && partials == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_codec<float>(x, n, codec, stochastic != 0, qmax, inv_qmax,
                               q, scales, partials, partials_len, seed_out,
                               sms, s);
  if (dtype == repro::kBF16)
    return launch_codec<__nv_bfloat16>(x, n, codec, stochastic != 0, qmax,
                                       inv_qmax, q, scales, partials,
                                       partials_len, seed_out, sms, s);
  return cudaErrorInvalidValue;
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
