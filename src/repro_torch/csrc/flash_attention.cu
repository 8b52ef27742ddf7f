// Flash-attention forward for Hopper (sm_90a): the fp32 route.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// `flash_fwd` (pallas_call at :90) for fp32 inputs: online-softmax attention
// with an fp32 running max, sum and accumulator; static causal /
// sliding-window / tanh softcap masking; q_scale (default 1/sqrt(hd), set by
// the wrapper).  bf16 inputs take the tensor-core kernel,
// csrc/flash_attention_sm90.cu; this one stays on the CUDA cores because
// TF32 tensor cores would not hold fp32 tolerances.
//
// Differences from the TPU kernel, on purpose:
//  * Layout.  It reads the port's public layout q (B,S,H,hd), k/v
//    (B,T,Kh,hd) through the strides it is given: no transpose, no padding
//    copy, and no K/V head repeat.  q head h reads kv head h / (H / Kh),
//    the mapping of the reference wrapper's jnp.repeat.
//  * Length mask.  Keys at k_pos >= T (the true length) are masked.  The TPU
//    kernel masks on the padded length (kernel.py:89), so its zero-padded
//    keys take part in a non-causal softmax.
//  * Blocks run in parallel and in no order, so the KV loop lives inside the
//    block instead of on a sequential grid axis, and a block visits only the
//    KV tiles its query rows can see: causality ends the loop at the tile's
//    last row, a sliding window starts it at the first row's window.
//
// Bound on the H100: operations (~830 FLOP per byte of q/k/v/o at prefill,
// far above the card's ridge).  It multiplies on the fp32 CUDA cores from
// fp32 tiles in shared memory (a 16x16 thread grid, each thread a 4 x BN/16
// patch of scores and a 4 x hd/16 patch of the output), so it reaches at
// most the fp32 FMA rate; it serves the fp32 checks, not the main path.
#include <math_constants.h>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                   // query rows per block
constexpr int kThreads = 256;             // 16 x 16 thread grid
constexpr int kRM = kBM / 16;             // query rows per thread

// Keys per KV tile: 32 at hd=128 keeps shared memory near 76 KB, so two
// blocks fit on one SM.
template <int HD>
struct KvTile {
  static constexpr int kN = HD >= 128 ? 32 : 64;
};

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int BN = KvTile<HD>::kN;
  return sizeof(float) *
         (kBM * (HD + 1) + BN * (HD + 1) + BN * HD + kBM * (BN + 16));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, Kh;
  long long sqb, sqs, sqh, skb, skt, skh, svb, svt, svh, sob, sos, soh;
  int causal;
  int window;      // <= 0: none; else keep q_pos - k_pos < window
  float softcap;   // <= 0: none
  float q_scale;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Params p) {
  constexpr int BN = KvTile<HD>::kN;
  constexpr int CN = BN / 16;   // key columns per thread
  constexpr int DN = HD / 16;   // output dims per thread
  constexpr int QS = HD + 1;    // padded row strides: conflict-free columns
  constexpr int KS = HD + 1;
  constexpr int PS = BN + 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // kBM x QS, pre-scaled
  float* Ks = Qs + kBM * QS;    // BN x KS
  float* Vs = Ks + BN * KS;     // BN x HD
  float* Ps = Vs + BN * HD;     // kBM x PS, probabilities of this tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // lanes of one half-warp share a row set
  const int ty = tid >> 4;
  // Reverse order: under causality the last query tiles do the most work,
  // so they start first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.Kh);
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;
  float* o = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  for (int i = tid; i < kBM * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = m0 + r;
    Qs[r * QS + d] = s < p.S ? q[s * p.sqs + d] * p.q_scale : 0.f;
  }

  int n_end = p.T;
  if (p.causal) n_end = min(n_end, m0 + kBM);
  int n_begin = 0;
  if (p.window > 0) n_begin = max(0, m0 - p.window + 1) / BN * BN;

  float m_i[kRM], l_i[kRM], acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's K/V/P are consumed
    for (int i = tid; i < BN * HD; i += kThreads) {
      const int c = i / HD, d = i % HD, t = n0 + c;
      const bool in = t < p.T;  // zero, never garbage: 0 * NaN would leak
      Ks[c * KS + d] = in ? k[t * p.skt + d] : 0.f;
      Vs[c * HD + d] = in ? v[t * p.svt + d] : 0.f;
    }
    __syncthreads();

    float s[kRM][CN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRM], kv[CN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qpos = m0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = n0 + tx + 16 * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool keep = kpos < p.T && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = keep ? x : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float corr = 1.f, rs = 0.f;
      if (m_new == -CUDART_INF_F) {  // every key so far masked for this row
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
      } else {
        corr = expf(m_i[i] - m_new);  // 0 on the first visible tile
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < CN; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float vv[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float pv = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int s_ = m0 + ty + 16 * i;
    if (s_ >= p.S) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      o[s_ * p.sos + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kBM - 1) / kBM, p.B * p.H);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// fp32 q: (B,S,H,hd), k/v: (B,T,Kh,hd), o: (B,S,H,hd), with
// element strides given per (batch, position, head) and unit stride on hd.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported input).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int Kh, int hd, long long sqb, long long sqs, long long sqh,
    long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sos, long long soh, int causal,
    int window, float softcap, float q_scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   B,   S,   T,      H,      Kh,
                 sqb, sqs, sqh, skb, skt, skh, svb,    svt,    svh,
                 sob, sos, soh, causal, window, softcap, q_scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
