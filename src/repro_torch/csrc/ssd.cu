// Mamba-2 SSD (state-space dual) chunk-scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py `ssd_fwd`
// (pallas_call at :71, body `_ssd_kernel` at :30).  Per (batch, head) and
// chunk of Lc positions, with cum the inclusive cumsum of dt*A over the
// chunk:
//   y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s     (intra)
//        + exp(cum_t) C_t . S_in                                  (inter)
//        + D x_t                                                  (skip)
//   S_out = exp(cum_last) S_in + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// with the (P, N) state S carried from chunk to chunk in fp32.
//
// Differences from the TPU kernel, on purpose:
//  * Sequence.  The TPU kernel keeps S in VMEM scratch across a sequential
//    grid axis over the chunks.  Blocks on the GPU run in no order, so one
//    block owns one (b, h) pair and loops over the chunks itself, with S in
//    shared memory.
//  * Layout.  It reads the model's layout x (B,T,H,P), dt (B,T,H), Bm/Cm
//    (B,T,G,N) through the strides it is given, maps head h to group
//    h / (H / G) by index (the TPU wrapper materialises jnp.repeat of B and
//    C over the heads), and masks the ragged last chunk on the true T (the
//    TPU wrapper pads): rows at t >= T load as zeros, exactly the
//    reference's zero padding (dt = 0 keeps cum flat there).
//  * The D skip is fused; the TPU wrapper adds it outside the kernel.
//
// Bound on the H100: bytes.  At zamba2-1.2b (B 4, T 2048, H 64, P 64, N 64,
// Lc 128, bf16 x/B/C, fp32 dt) one call moves ~138 MB (x and y dominate)
// and does ~26 GFLOP, ~190 FLOP a byte, under the card's ridge.  This first
// kernel is simple and exact rather than fast: every product runs on the
// fp32 CUDA cores from fp32 tiles in shared memory (a 16x16 thread grid,
// each thread a register patch of the output), one block per (b, h), so it
// is bound by the fp32 FMA rate and by a grid of only B*H blocks.  Tensor
// cores (wgmma on the Lc x Lc and Lc x P products) and several blocks per
// sequence (a second pass to carry the state) are the later steps.
#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr int kMaxLc = 128;     // chunk length
constexpr int kMaxN = 64;       // state size
constexpr int kRows = kMaxLc / 16;   // chunk rows per thread
constexpr int kNJ = kMaxN / 16;      // state columns per thread

struct Params {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* D;
  void* y;
  int B, T, H, G, N, Lc, has_d;
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg;
  int dt_dtype, a_dtype, d_dtype;
};

// a scalar of an fp32 or bf16 array
__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int dtype) {
  return dtype == repro::kBF16
             ? to_f32(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// floats of shared memory for one block
__host__ __device__ constexpr size_t smem_floats(int Lc, int P, int N) {
  return static_cast<size_t>(Lc) * P            // x
         + 2 * static_cast<size_t>(Lc) * (N + 1)  // B, C
         + static_cast<size_t>(Lc) * (Lc + 1)     // decayed scores
         + static_cast<size_t>(P) * (N + 1)       // state
         + 4 * static_cast<size_t>(Lc);           // dt, cum, exp(cum), coef
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_kernel(Params p) {
  constexpr int PJ = P / 16;    // output columns per thread
  constexpr int PI = P / 16;    // state rows per thread
  const int Lc = p.Lc, N = p.N;
  const int BS = N + 1, GS = Lc + 1, SS = N + 1;
  extern __shared__ float smem[];
  float* Xs = smem;                 // Lc x P, raw x
  float* Bs = Xs + Lc * P;          // Lc x BS
  float* Cs = Bs + Lc * BS;         // Lc x BS
  float* Gs = Cs + Lc * BS;         // Lc x GS: (C B^T) * L * dt_s
  float* Ss = Gs + Lc * GS;         // P x SS, the carried state
  float* dts = Ss + P * SS;         // Lc
  float* cum = dts + Lc;            // Lc, inclusive cumsum of dt*A
  float* ecum = cum + Lc;           // Lc, exp(cum)
  float* coef = ecum + Lc;          // Lc, dt_s exp(cum_last - cum_s)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int g = h / (p.H / p.G);
  const T* x = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.sbb + g * p.sbg;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.scb + g * p.scg;
  const long long dt0 = b * p.sdb + h * p.sdh;
  // y is contiguous (B, T, H, P)
  T* y = static_cast<T*>(p.y) + (static_cast<long long>(b) * p.T * p.H + h) * P;
  const long long syt = static_cast<long long>(p.H) * P;
  const float A = load_any(p.A, h, p.a_dtype);
  const float Dh = p.has_d ? load_any(p.D, h, p.d_dtype) : 0.f;

  for (int i = tid; i < P * SS; i += kThreads) Ss[i] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += Lc) {
    const int rows = min(Lc, p.T - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Lc * P; i += kThreads) {
      const int r = i / P, c = i % P;
      Xs[i] = r < rows ? to_f32(x[(t0 + r) * p.sxt + c]) : 0.f;
    }
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int r = i / N, c = i % N;
      const bool in = r < rows;
      Bs[r * BS + c] = in ? to_f32(Bm[(t0 + r) * p.sbt + c]) : 0.f;
      Cs[r * BS + c] = in ? to_f32(Cm[(t0 + r) * p.sct + c]) : 0.f;
    }
    for (int r = tid; r < Lc; r += kThreads)
      dts[r] = r < rows ? load_any(p.dt, dt0 + (t0 + r) * p.sdt, p.dt_dtype)
                        : 0.f;
    __syncthreads();

    // inclusive cumsum of dt*A by warp 0: each lane a run of E positions
    if (tid < 32) {
      const int E = (Lc + 31) / 32;
      const int lo = tid * E;
      float run = 0.f;
      for (int r = lo; r < min(lo + E, Lc); ++r) run += dts[r] * A;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float acc = incl - run;
      for (int r = lo; r < min(lo + E, Lc); ++r) {
        acc += dts[r] * A;
        cum[r] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum[Lc - 1];
    for (int r = tid; r < Lc; r += kThreads) {
      ecum[r] = expf(cum[r]);
      coef[r] = dts[r] * expf(cum_last - cum[r]);
    }

    // scores: Gs[r][s] = (C_r . B_s) exp(cum_r - cum_s) dt_s for s <= r.
    // Row r = ty + 16 i, column s = tx + 16 j: s <= r needs j <= i.
    {
      float acc[kRows][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cr[kRows], bs[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = min(ty + 16 * i, Lc - 1);
          cr[i] = Cs[r * BS + n];
          bs[i] = Bs[min(tx + 16 * i, Lc - 1) * BS + n];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(cr[i], bs[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + 16 * i;
        if (r >= Lc) continue;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int s = tx + 16 * j;
          if (s >= Lc) continue;
          float v = 0.f;
          if (j <= i && s <= r) v = acc[i][j] * expf(cum[r] - cum[s]) * dts[s];
          Gs[r * GS + s] = v;
        }
      }
    }
    __syncthreads();

    // y: row r = ty + 16 i, column c = tx + 16 j
    {
      float acc[kRows][PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      // inter-chunk: exp(cum_r) C_r . S[c]
      for (int n = 0; n < N; ++n) {
        float cr[kRows], sv[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          cr[i] = Cs[min(ty + 16 * i, Lc - 1) * BS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = Ss[(tx + 16 * j) * SS + n];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cr[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float e = ecum[min(ty + 16 * i, Lc - 1)];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }
      // intra-chunk: sum_s Gs[r][s] x_s[c]
      for (int s = 0; s < Lc; ++s) {
        float gv[kRows], xv[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          gv[i] = Gs[min(ty + 16 * i, Lc - 1) * GS + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int c = tx + 16 * j;
          y[(t0 + r) * syt + c] =
              repro::from_f32<T>(acc[i][j] + Dh * Xs[r * P + c]);
        }
      }
    }

    if (t0 + Lc < p.T) {
      __syncthreads();  // every read of the old state is done
      // state: row c = ty + 16 i (P), column n = tx + 16 j (N)
      float acc[PI][kNJ];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < Lc; ++s) {
        const float cf = coef[s];
        float xv[PI], bv[kNJ];
#pragma unroll
        for (int i = 0; i < PI; ++i) xv[i] = Xs[s * P + ty + 16 * i] * cf;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          bv[j] = Bs[s * BS + min(tx + 16 * j, N - 1)];
#pragma unroll
        for (int i = 0; i < PI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float dec = expf(cum_last);
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = tx + 16 * j;
          if (n < N) {
            float* sp = &Ss[(ty + 16 * i) * SS + n];
            *sp = dec * *sp + acc[i][j];
          }
        }
    }
  }
}

template <typename T, int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.Lc, P, p.N) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ssd_fwd_kernel<T, P><<<p.B * p.H, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Params& p, int P, cudaStream_t stream) {
  switch (P) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B,T,H,P) in `x_dtype` (Bm, Cm too), dt: (B,T,H), A: (H,), Bm/Cm:
// (B,T,G,N), D: (H,) or null; element strides per (batch, position,
// head/group), unit stride on P and N; A and D contiguous.  dt, A and D are
// fp32 or bf16 by their own codes.  y: contiguous (B,T,H,P) in x_dtype.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported input).
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* D, void* y,
                       int B, int T, int H, int P, int G, int N, int Lc,
                       int has_d, long long sxb, long long sxt, long long sxh,
                       long long sdb, long long sdt, long long sdh,
                       long long sbb, long long sbt, long long sbg,
                       long long scb, long long sct, long long scg,
                       int x_dtype, int dt_dtype, int a_dtype, int d_dtype,
                       void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      N > kMaxN || Lc <= 0 || Lc > kMaxLc || (has_d && D == nullptr))
    return cudaErrorInvalidValue;
  const Params p{x,   dt,  A,   Bm,  Cm,  D,   y,   B,   T,        H,
                 G,   N,   Lc,  has_d, sxb, sxt, sxh, sdb, sdt,    sdh,
                 sbb, sbt, sbg, scb, sct, scg, dt_dtype, a_dtype, d_dtype};
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == repro::kF32) return launch_p<float>(p, P, s);
  if (x_dtype == repro::kBF16) return launch_p<__nv_bfloat16>(p, P, s);
  return cudaErrorInvalidValue;
}
