// The SR quantizer as ONE cooperative launch, kept beside the shipped two
// launches (src/repro_torch/csrc/quant.cu) to be timed against them by
// tools/quant_sr_one_launch.py.  Not part of the package: the shipped
// kernels measured faster (PERF.md).
//
// Every block is resident.  Block b owns a contiguous span of warp steps:
//  1. it sums the f32 bits of its span, keeping the span's first steps in
//     shared memory (all a block can opt in to: ~30 MB over an H100), and
//     writes its partial sum;
//  2. the grid meets at one barrier, and every block sums the partials in
//     one order: seed = sum | 1;
//  3. it encodes the steps it did not keep, re-read last first (the lines
//     read last may still be in L2), then the kept steps.
// It reuses the shipped file's helpers (one 16-byte piece a lane, the
// chunk's absmax by shuffles, the bit-exact encode).
#include <cooperative_groups.h>

#include "quant.cu"

namespace {

namespace cg = cooperative_groups;

constexpr int kOneWarps = 32;   // warps a block
constexpr int kOneUnroll = 4;   // 16-byte loads in flight a lane
constexpr int kStepBytes = 512;  // one warp step: 32 lanes x 16 bytes

// SR in one cooperative launch, every block resident.  Block b owns a
// contiguous span of warp steps.
//  1. It sums the f32 bits of its span, keeping the span's first
//     `kept_steps` steps in shared memory, and writes its partial sum.
//  2. The grid meets at one barrier; every block sums the partials in the
//     same order: seed = sum | 1 (block 0 writes it to seed_out).
//  3. It encodes the steps it did not keep, re-read last first (the lines
//     read last may still be in L2), then the kept steps from shared memory.
template <typename T, int kCodec>
__global__ void __launch_bounds__(32 * kOneWarps)
quant_sr_one_kernel(const T* __restrict__ x, long long n, long long m,
                    float qmax, float inv_qmax, bool vec, int kept_steps,
                    uint8_t* __restrict__ q, float* __restrict__ scales,
                    uint32_t* __restrict__ partials, uint32_t* seed_out) {
  using P = Piece<T>;
  constexpr int kGroup = kOneWarps * kOneUnroll;
  extern __shared__ uint4 kept[];  // [kept_steps][32]
  __shared__ uint32_t red[kOneWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long steps = (m + P::kChunks - 1) / P::kChunks;
  const long long s_begin = steps * blockIdx.x / gridDim.x;
  const long long span = steps * (blockIdx.x + 1) / gridDim.x - s_begin;
  const long long n_kept = min(span, static_cast<long long>(kept_steps));
  const T* xs = x + s_begin * P::kStep + lane * P::kV;
  const long long ns = n - s_begin * P::kStep - lane * P::kV;  // n from xs

  uint32_t sum = 0;
  for (long long i0 = w; i0 < span; i0 += kGroup) {
    uint4 raw[kOneUnroll];
#pragma unroll
    for (int u = 0; u < kOneUnroll; ++u) {
      const long long i = i0 + u * kOneWarps;
      raw[u] = i < span ? load_piece(xs, i * P::kStep, ns, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kOneUnroll; ++u) {
      const long long i = i0 + u * kOneWarps;
      sum += bits_sum<T>(raw[u]);
      if (i < n_kept) kept[i * 32 + lane] = raw[u];
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red[w] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int i = 0; i < kOneWarps; ++i) t += red[i];
    partials[blockIdx.x] = t;
  }
  cg::this_grid().sync();

  if (w == 0) {
    uint32_t t = 0;
    for (int b = lane; b < gridDim.x; b += 32) t += __ldcg(partials + b);
#pragma unroll
    for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t | 1u;
  }
  __syncthreads();
  const uint32_t seed = red[0];
  if (blockIdx.x == 0 && threadIdx.x == 0 && seed_out) *seed_out = seed;

  for (long long i0 = span - 1 - w; i0 >= n_kept; i0 -= kGroup) {
    uint4 raw[kOneUnroll];
#pragma unroll
    for (int u = 0; u < kOneUnroll; ++u) {
      const long long i = i0 - u * kOneWarps;
      raw[u] = i >= n_kept ? load_piece(xs, i * P::kStep, ns, vec)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kOneUnroll; ++u) {
      const long long i = i0 - u * kOneWarps;
      if (i >= n_kept)
        encode_piece<T, kCodec, true>(raw[u], s_begin + i, lane, m, qmax,
                                      inv_qmax, seed, q, scales);
    }
  }
  for (long long i = w; i < n_kept; i += kOneWarps)
    encode_piece<T, kCodec, true>(kept[i * 32 + lane], s_begin + i, lane, m,
                                  qmax, inv_qmax, seed, q, scales);
}

// The SR launch's shape on the current device: the dynamic shared memory
// that keeps whole warp steps (all a block can opt in to, less its static
// part) and the resident blocks an SM at that size.
struct SrShape {
  size_t smem;
  int kept_steps;
  int per_sm;
};

template <typename T, int kCodec>
cudaError_t sr_shape(SrShape* out) {
  const auto kern = quant_sr_one_kernel<T, kCodec>;
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  out->kept_steps =
      static_cast<int>((optin - fa.sharedSizeBytes) / kStepBytes);
  out->smem = static_cast<size_t>(out->kept_steps) * kStepBytes;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(out->smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out->per_sm, kern, 32 * kOneWarps, out->smem);
  if (e == cudaSuccess && out->per_sm < 1)
    e = cudaErrorCooperativeLaunchTooLarge;
  return e;
}

template <typename T, int kCodec>
cudaError_t launch_sr(const T* x, long long n, long long m, float qmax,
                      float inv_qmax, bool vec, uint8_t* q, float* scales,
                      uint32_t* partials, int partials_len,
                      uint32_t* seed_out, int sms, cudaStream_t s) {
  SrShape sh;
  const cudaError_t e = sr_shape<T, kCodec>(&sh);
  if (e != cudaSuccess) return e;
  const long long steps =
      (m + Piece<T>::kChunks - 1) / Piece<T>::kChunks;
  const long long most = static_cast<long long>(sh.per_sm) * sms;
  const int grid = static_cast<int>(steps < most ? steps : most);
  if (grid > partials_len) return cudaErrorInvalidValue;
  int kept = sh.kept_steps;
  void* args[] = {&x,   &n,    &m,     &qmax,     &inv_qmax, &vec,
                  &kept, &q,   &scales, &partials, &seed_out};
  // every block must be resident for the grid barrier: a launch that
  // cannot be is refused, and the error returns to the caller
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quant_sr_one_kernel<T, kCodec>),
      dim3(grid), dim3(32 * kOneWarps), args, sh.smem, s);
}

}  // namespace

// The one-launch SR quantizer: quant_fwd's contract for stochastic != 0,
// partials of quant_sr_one_plan's blocks.  Returns the launch's error (a
// refused cooperative launch included).
extern "C" int quant_sr_one_launch(const void* x, int dtype, long long n,
                                   int codec, float qmax, float inv_qmax,
                                   void* q, float* scales, uint32_t* partials,
                                   int partials_len, uint32_t* seed_out,
                                   int sms, void* stream) {
  if (n <= 0 || sms <= 0 || (codec != kFp8 && codec != kInt8))
    return cudaErrorInvalidValue;
  const long long m = (n + kChunk - 1) / kChunk;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<uint8_t*>(q);
  if (dtype == repro::kF32) {
    const auto* xt = static_cast<const float*>(x);
    const bool vec = aligned_to(x, 16);
    return codec == kFp8
               ? launch_sr<float, kFp8>(xt, n, m, qmax, inv_qmax, vec, qb,
                                        scales, partials, partials_len,
                                        seed_out, sms, s)
               : launch_sr<float, kInt8>(xt, n, m, qmax, inv_qmax, vec, qb,
                                         scales, partials, partials_len,
                                         seed_out, sms, s);
  }
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const bool vec = aligned_to(x, 16);
  return codec == kFp8
             ? launch_sr<__nv_bfloat16, kFp8>(xt, n, m, qmax, inv_qmax, vec,
                                              qb, scales, partials,
                                              partials_len, seed_out, sms, s)
             : launch_sr<__nv_bfloat16, kInt8>(xt, n, m, qmax, inv_qmax, vec,
                                               qb, scales, partials,
                                               partials_len, seed_out, sms,
                                               s);
}

// (most blocks, elements kept on chip when n fills them) of the one launch
extern "C" int quant_sr_one_plan(int dtype, int sms, int* blocks,
                                 long long* kept_elems) {
  SrShape sh;
  const cudaError_t e = dtype == repro::kF32
                            ? sr_shape<float, kFp8>(&sh)
                            : sr_shape<__nv_bfloat16, kFp8>(&sh);
  if (e != cudaSuccess) return e;
  *blocks = sh.per_sm * sms;
  *kept_elems = static_cast<long long>(*blocks) * sh.kept_steps *
                (dtype == repro::kF32 ? Piece<float>::kStep
                                      : Piece<__nv_bfloat16>::kStep);
  return cudaSuccess;
}
