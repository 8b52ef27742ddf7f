// Flash attention for Hopper (sm_90a): the fp32 route, on tensor cores in
// TF32 with fp32 accuracy (3xTF32).  The forward first; the backward
// kernels follow it (see "the backward" below).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// `flash_fwd` (pallas_call at :90) for fp32 inputs: online-softmax attention
// with an fp32 running max, sum and accumulator; static causal /
// sliding-window / tanh softcap masking; q_scale (default 1/sqrt(hd), set by
// the wrapper).  bf16 inputs take csrc/flash_attention_sm90.cu.
//
// Precision (tf32.cuh, shared with ssd_sm90.cu's fp32 route): every fp32
// operand is split into TF32 hi + lo and each product taken as hi*hi +
// hi*lo + lo*hi, about 21 significant bits, so S = Q K^T and O = P V hold
// fp32 tolerances.  The tensor cores' fp32 sums truncate, so O is not
// summed in them over the whole row: each 16 keys' product is, and O adds
// it with round to nearest.  `products` = 1 keeps
// only hi*hi; it exists as a planted fault that the checks must reject.
//
// Layout: 4 warps a block, 16 query rows a warp (64 a block), mma.sync
// m16n8k8 with fp32 accumulators.
//  * Q's fragments are scaled and split once, before the KV loop, and stay
//    in registers (at hd 128 they would take 128 registers a thread, and the
//    kernel would spill: there the scaled Q tile waits in shared memory and
//    is split at each use).
//  * K and V tiles of BN keys come into shared memory with cp.async, two
//    stages, so tile j+1 lands while tile j is multiplied: 16-byte copies
//    where every row is 16-byte aligned, 4-byte copies otherwise, zero fill
//    past T.  Rows are padded by 4 floats, so the fragment reads below hit
//    32 distinct banks.
//  * P stays in registers.  The accumulator of S holds key columns (2t,
//    2t+1) of each 8-key tile, where the A operand of P V wants (t, t+4);
//    the order of keys inside a tile does not matter to P V, so V's rows
//    are read in the matching order (logical key t -> row 2t, t+4 -> 2t+1)
//    and nothing goes through shared memory.
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
// far above the card's ridge): each fp32-accurate product is three TF32
// products, so the least time is the FLOPs over 495 / 3 = 165 TFLOP/s.
#include <math_constants.h>

#include <cstdint>

#include <cuda_runtime.h>

#include "tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows a block
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  // Keys a KV tile: 32 keeps a thread's S, O, Q and P fragments within 255
  // registers without spills at hd 64 and 128, and at hd 16 and 32 it
  // measured faster than 64 (less of the causal diagonal tile is masked).
  static constexpr int kBN = 32;
  static constexpr int kLd = HD + 4;          // padded smem row, floats
  static constexpr int kTile = kBN * kLd;     // floats a K or V tile
  // Q's split fragments of a warp's 16 rows take HD registers a thread: they
  // stay in registers up to hd 64; at hd 128 the scaled Q tile waits in
  // shared memory and is split at each use.
  static constexpr bool kQInSmem = HD > 64;
  static constexpr int kQFloats = kQInSmem ? kBM * kLd : 0;
  static constexpr size_t kSmem = sizeof(float) * (4 * kTile + kQFloats);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;      // (B, H, S) row log-sum-exp; null: not written
  int B, S, T, H, Kh;
  long long sqb, sqs, sqh, skb, skt, skh, svb, svt, svh, sob, sos, soh;
  int causal;
  int window;      // <= 0: none; else keep q_pos - k_pos < window
  float softcap;   // <= 0: none
  float q_scale;
  int vec;         // k and v rows are 16-byte aligned
};

using tf32::mma3;
using tf32::split;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// keys [n0, n0 + BN) of one head of k (or v) into smem [BN][kLd], zero
// past T
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int n0, int T,
                                          bool vec) {
  using C = Cfg<HD>;
  static_assert(C::kBN * HD % (4 * kThreads) == 0, "whole vectors a thread");
  if (vec) {
    constexpr int kVw = HD / 4;
#pragma unroll
    for (int c = 0; c < C::kBN * kVw / kThreads; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int r = i / kVw, d = (i % kVw) * 4, t = n0 + r;
      cp_async16(dst + r * C::kLd + d, src + (t < T ? t * st + d : 0),
                 t < T ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < C::kBN * HD / kThreads; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int r = i / HD, d = i % HD, t = n0 + r;
      cp_async4(dst + r * C::kLd + d, src + (t < T ? t * st + d : 0),
                t < T ? 4 : 0);
    }
  }
}

// Q's A fragments of one warp's 16 rows: (row g, col t), (g+8, t),
// (g, t+4), (g+8, t+4) of each 8-column step, scaled by q_scale; split once
// and held (hd <= 64), or read from the block's Q tile in shared memory and
// split at each use (hd 128)
template <int HD>
struct QFrags {
  using C = Cfg<HD>;
  static constexpr int kS = HD / 8;
  uint32_t a[C::kQInSmem ? 1 : kS][4][2];
  const float* qs;  // in shared memory: this lane's (g, t) of its warp

  // every thread of the block calls it; Qs: the Q tile's shared memory
  __device__ __forceinline__ void load(const float* q, long long sqs, int m0,
                                       int S, float scale, float* Qs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    if constexpr (C::kQInSmem) {
      for (int i = threadIdx.x; i < kBM * HD; i += kThreads) {
        const int r = i / HD, d = i % HD, row = m0 + r;
        Qs[r * C::kLd + d] = row < S ? q[row * sqs + d] * scale : 0.f;
      }
      qs = Qs + (warp * 16 + g) * C::kLd + t;
    } else {
      const int r0 = m0 + warp * 16 + g;
#pragma unroll
      for (int kk = 0; kk < kS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + (i & 1) * 8, c = kk * 8 + t + (i >> 1) * 4;
          split(r < S ? q[r * sqs + c] * scale : 0.f, a[kk][i][0],
                a[kk][i][1]);
        }
    }
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (C::kQInSmem) {
        split(qs[(i & 1) * 8 * C::kLd + kk * 8 + (i >> 1) * 4], hi[i], lo[i]);
      } else {
        hi[i] = a[kk][i][0];
        lo[i] = a[kk][i][1];
      }
    }
  }
};

template <int HD, int P>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_tf32_kernel(Params p) {
  using C = Cfg<HD>;
  constexpr int BN = C::kBN;
  constexpr int NT = BN / 8;   // 8-key column tiles of S
  constexpr int DT = HD / 8;   // 8-dim column tiles of O
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
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
  const int r0 = m0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int r1 = r0 + 8;

  int n_end = p.T;
  if (p.causal) n_end = min(n_end, m0 + kBM);
  int n_begin = 0;
  if (p.window > 0) n_begin = max(0, m0 - p.window + 1) / BN * BN;
  const int tiles = n_end > n_begin ? (n_end - n_begin + BN - 1) / BN : 0;

  if (tiles > 0) {
    load_tile<HD>(smem, k, p.skt, n_begin, p.T, p.vec);
    load_tile<HD>(smem + C::kTile, v, p.svt, n_begin, p.T, p.vec);
    cp_async_commit();
  }

  QFrags<HD> qf;  // the first tile's __syncthreads also publishes Q's tile
  qf.load(q, p.sqs, m0, p.S, p.q_scale, smem + 4 * C::kTile);

  float m_i[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int n0 = n_begin + it * BN;
    if (it + 1 < tiles) {  // the next tile into the other stage
      float* nxt = smem + ((it + 1) & 1) * 2 * C::kTile;
      load_tile<HD>(nxt, k, p.skt, n0 + BN, p.T, p.vec);
      load_tile<HD>(nxt + C::kTile, v, p.svt, n0 + BN, p.T, p.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = smem + (it & 1) * 2 * C::kTile;
    const float* Vs = Ks + C::kTile;

    // S = (Q * scale) K^T: 16 rows x BN keys a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ah[4], al[4];
      qf.get(kk, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = Ks + (j * 8 + g) * C::kLd + kk * 8 + t;
        mma3<P>(s[j], ah, al, kr[0], kr[4]);
      }
    }

    // softcap, masks, online softmax.  s[j] holds rows (r0, r0, r1, r1) x
    // keys (2t, 2t+1, 2t, 2t+1) of tile j
    const bool edge = n0 + BN > p.T || (p.causal && n0 + BN - 1 > m0) ||
                      (p.window > 0 && m0 + kBM - 1 - n0 >= p.window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (edge) {
          const int row = e < 2 ? r0 : r1;
          const int col = n0 + j * 8 + 2 * t + (e & 1);
          const bool keep = col < p.T && (!p.causal || col <= row) &&
                            (p.window <= 0 || row - col < p.window);
          if (!keep) x = -CUDART_INF_F;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      // every key so far masked for this row: p = 0, nothing to rescale
      corr[r] = m_new == -CUDART_INF_F ? 1.f
                                       : exp2f((m_i[r] - m_new) * kLog2e);
      m_i[r] = m_new;
      mx[r] = m_new == -CUDART_INF_F ? 0.f : m_new * kLog2e;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -mx[e >> 1]));  // -inf -> 0
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * corr[r] + rs[r];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V.  P's A fragment of key tile j: logical key t is key 2t,
    // t + 4 is key 2t + 1, so V's rows are read in that order.  The tensor
    // cores' fp32 sums truncate: O summed in them over every key drifts
    // (4.2e-5 at llama3-8b's 32 fp32 layers, T 2064, against TOL32's 2e-5
    // near zero), so each 16 keys' product is summed in its own accumulator
    // and added to O with round to nearest.
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        split(s[j + u][0], ph[u][0], pl[u][0]);
        split(s[j + u][2], ph[u][1], pl[u][1]);
        split(s[j + u][1], ph[u][2], pl[u][2]);
        split(s[j + u][3], ph[u][3], pl[u][3]);
      }
      const float* vr = Vs + (j * 8 + 2 * t) * C::kLd + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mma3<P>(part, ph[u], pl[u], vr[u * 8 * C::kLd + d * 8],
                  vr[(u * 8 + 1) * C::kLd + d * 8]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] += part[e];
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= p.S) continue;
    // the row's log-sum-exp for the backward (+inf where no key is seen)
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
          l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : CUDART_INF_F;
    const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
    float* orow = o + row * p.sos + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(orow + d * 8) =
          make_float2(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
  }
}

template <int HD, int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Cfg<HD>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<HD, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kBM - 1) / kBM, p.B * p.H);
  flash_fwd_tf32_kernel<HD, P><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, P>(p, s);
    case 32: return launch<32, P>(p, s);
    case 64: return launch<64, P>(p, s);
    case 128: return launch<128, P>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}


// ---- the backward ----------------------------------------------------------
// Replaces the reference's lax backward src/repro/kernels/flash_attention/
// ops.py:62 `_vjp_bwd` for fp32 inputs (bf16 inputs take
// csrc/flash_attention_bwd_sm90.cu, whose header sets out the arithmetic):
// P = exp(c - lse) from the forward's row log-sum-exp, dP = dO V^T,
// D = rowsum(dO o O), dS = P o (dP - D) o (1 - tanh^2) * scale (the tanh
// factor under a softcap), dV = P^T dO, dK = dS^T Q, dQ = dS K.  A
// query-major and a key-major kernel, so that every output element is
// written once by one block and no float atomic is needed: dQ (64 rows a
// block, 32-key K/V tiles through two cp.async stages; its prologue writes
// D) and then dK and dV (64 keys a block, the group's query heads and the
// 32-row Q / dO tiles the masks leave, two cp.async stages).  Every product is
// the forward's mma.sync TF32 with `P` products a product (3: hi*hi +
// hi*lo + lo*hi; 1: the planted fault), operands split at each use from
// shared memory, and sums carried in registers with round to nearest every
// 16 keys or rows, as the forward's O.  A simple kernel: the fp32 route
// runs on the card-vs-CPU checks only, never on a bf16 path.  dK and dV
// are two launches of the key-major kernel (S and P computed in both): at
// hd 128 one thread's dK and dV sums alone take 128 registers, and the
// kernel holding both spilled.
struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S): D, written by the dQ kernel
  float* dq;
  float* dk;
  float* dv;
  int S, T, H, Kh;
  long long sqb, sqs, sqh, skb, skt, skh, svb, svt, svh;
  long long sob, sos, soh, sdb, sds, sdh;
  long long sqgb, sqgs, sqgh, skgb, skgs, skgh, svgb, svgs, svgh;
  int causal;
  int window;
  float softcap;
  float q_scale;
  int vec_kv;  // k and v rows are 16-byte aligned
  int vec_q;   // q and dout rows are 16-byte aligned
};

// P and dS of one score s = (q * scale) . k (the forward's S) with dp =
// dO . v, the row's lse * log2e and D; `ds_scale` multiplies dS.
__device__ __forceinline__ void bwd_grad(float& s, float& dp, float lse2,
                                         float d, bool keep, float softcap,
                                         float ds_scale) {
  float dz = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = softcap * th;
    dz = 1.f - th * th;
  }
  s = keep ? exp2f(fmaf(s, kLog2e, -lse2)) : 0.f;  // +inf lse2 -> 0
  dp = s * (dp - d) * dz * ds_scale;
}

// rows [r0, r0 + R) of one head into smem [R][kLd], times `scale`, zero
// past n (plain loads: once a block)
template <int HD, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long st, int r0, int n,
                                          float scale) {
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    dst[r * Cfg<HD>::kLd + d] = row < n ? src[row * st + d] * scale : 0.f;
  }
}

// A fragment of rows (g, g + 8) x cols (t, t + 4) of an 8-column k-step
// from a [16][kLd] block of shared memory, split into TF32 hi + lo
template <int HD>
__device__ __forceinline__ void a_frag(const float* rows, int kk,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split(rows[(g + (i & 1) * 8) * Cfg<HD>::kLd + kk * 8 + t + (i >> 1) * 4],
          hi[i], lo[i]);
}

// acc[16 rows x HD] += A B: A (16 x 32) in accumulator layout (a[j][e]: rows
// (g, g, g+8, g+8) x cols (2t, 2t+1, 2t, 2t+1) of 8-column tile j), B's 32
// rows at `b` in shared memory ([32][kLd]).  The accumulator holds columns
// (2t, 2t+1) where A's fragment wants (t, t+4), so B's rows are read in the
// matching order (logical row t -> 2t, t+4 -> 2t+1); each 16 rows' product
// is summed in its own accumulator and added with round to nearest.
template <int HD, int P>
__device__ __forceinline__ void acc_ab(float (&acc)[HD / 8][4],
                                       const float (&a)[4][4],
                                       const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kLd = Cfg<HD>::kLd;
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      split(a[j + u][0], ah[u][0], al[u][0]);
      split(a[j + u][2], ah[u][1], al[u][1]);
      split(a[j + u][1], ah[u][2], al[u][2]);
      split(a[j + u][3], ah[u][3], al[u][3]);
    }
    const float* br = b + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u)
        mma3<P>(part, ah[u], al[u], br[u * 8 * kLd + d * 8],
                br[(u * 8 + 1) * kLd + d * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] += part[e];
    }
  }
}

// c[16 x 32] = A B^T: A's 16 rows at `a` ([16][kLd]), B's 32 rows at `b`
// ([32][kLd]), times `bscale`, over HD
template <int HD, int P>
__device__ __forceinline__ void mm_abt(float (&c)[4][4], const float* a,
                                       const float* b, float bscale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kLd = Cfg<HD>::kLd;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ah[4], al[4];
    a_frag<HD>(a, kk, ah, al);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* br = b + (j * 8 + g) * kLd + kk * 8 + t;
      mma3<P>(c[j], ah, al, br[0] * bscale, br[4] * bscale);
    }
  }
}

// D = rowsum(dO o O) of row `row` (< S), summed by the 4 lanes of a quad
__device__ __forceinline__ float row_delta(const float* o, const float* d,
                                           int hd, int t) {
  float acc = 0.f;
  for (int c = t * (hd / 4); c < (t + 1) * (hd / 4); ++c)
    acc = fmaf(o[c], d[c], acc);
  return acc;
}

template <int HD, int P>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tf32_kernel(BwdParams p) {
  using C = Cfg<HD>;
  constexpr int BN = C::kBN;
  static_assert(BN == 32, "acc_ab and mm_abt take 32-key tiles");
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const Qs = smem + 4 * C::kTile;    // (Q * scale), kBM rows
  float* const Ds = Qs + kBM * C::kLd;      // dO, kBM rows

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.Kh);
  const float* k = p.k + b * p.skb + kvh * p.skh;
  const float* v = p.v + b * p.svb + kvh * p.svh;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int r0 = m0 + warp * 16 + g;

  int n_end = p.T;
  if (p.causal) n_end = min(n_end, m0 + kBM);
  int n_begin = 0;
  if (p.window > 0) n_begin = max(0, m0 - p.window + 1) / BN * BN;
  const int tiles = n_end > n_begin ? (n_end - n_begin + BN - 1) / BN : 0;
  if (tiles > 0) {
    load_tile<HD>(smem, k, p.skt, n_begin, p.T, p.vec_kv);
    load_tile<HD>(smem + C::kTile, v, p.svt, n_begin, p.T, p.vec_kv);
    cp_async_commit();
  }
  load_rows<HD, kBM>(Qs, p.q + b * p.sqb + h * p.sqh, p.sqs, m0, p.S,
                     p.q_scale);
  load_rows<HD, kBM>(Ds, p.dout + b * p.sdb + h * p.sdh, p.sds, m0, p.S, 1.f);

  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    float acc = row < p.S
                    ? row_delta(p.o + b * p.sob + h * p.soh + row * p.sos,
                                p.dout + b * p.sdb + h * p.sdh + row * p.sds,
                                HD, t)
                    : 0.f;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dd[r] = acc;
    lse2[r] = row < p.S ? p.lse[bh * p.S + row] * kLog2e : CUDART_INF_F;
    if (t == 0 && row < p.S) p.delta[bh * p.S + row] = acc;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int n0 = n_begin + it * BN;
    if (it + 1 < tiles) {
      float* nxt = smem + ((it + 1) & 1) * 2 * C::kTile;
      load_tile<HD>(nxt, k, p.skt, n0 + BN, p.T, p.vec_kv);
      load_tile<HD>(nxt + C::kTile, v, p.svt, n0 + BN, p.T, p.vec_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // also publishes Qs and Ds on the first tile
    const float* Ks = smem + (it & 1) * 2 * C::kTile;
    const float* Vs = Ks + C::kTile;

    float s[4][4], dp[4][4];
    mm_abt<HD, P>(s, Qs + warp * 16 * C::kLd, Ks, 1.f);
    mm_abt<HD, P>(dp, Ds + warp * 16 * C::kLd, Vs, 1.f);
    const bool edge = n0 + BN > p.T || (p.causal && n0 + BN - 1 > m0) ||
                      (p.window > 0 && m0 + kBM - 1 - n0 >= p.window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const bool keep = !edge || (col < p.T && (!p.causal || col <= row) &&
                                    (p.window <= 0 || row - col < p.window));
        bwd_grad(s[j][e], dp[j][e], lse2[e >> 1], dd[e >> 1], keep,
                 p.softcap, p.q_scale);
      }
    acc_ab<HD, P>(acc, dp, Ks);  // dQ += dS K
    __syncthreads();  // this stage is consumed before it is refilled
  }

  float* dq = p.dq + b * p.sqgb + h * p.sqgh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= p.S) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(dq + row * p.sqgs + d * 8 + 2 * t) =
          make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// dK (kDk) or dV: kBM keys a block, 32-row Q / dO tiles (`kBN` rows:
// load_tile's)
template <int HD, int P, bool kDk>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_tf32_kernel(BwdParams p) {
  using C = Cfg<HD>;
  constexpr int BM = C::kBN;  // query rows a tile
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);  // Q, dO stages
  float* const Ks = smem + 4 * C::kTile;                // kBM keys
  float* const Vs = Ks + kBM * C::kLd;
  float* const LD = Vs + kBM * C::kLd;  // 2 stages of BM lse2, BM D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBM;
  const int b = blockIdx.y / p.Kh;
  const int kvh = blockIdx.y % p.Kh;
  const int group = p.H / p.Kh;
  const int k0 = n0 + warp * 16 + g;  // this thread's keys k0 and k0 + 8

  const int m_begin = p.causal ? n0 / BM * BM : 0;
  const int m_end =
      p.window > 0 ? min(p.S, min(p.T, n0 + kBM) - 1 + p.window) : p.S;
  const int n_m = m_end > m_begin ? (m_end - m_begin + BM - 1) / BM : 0;
  const int n_it = group * n_m;

  // tile `it`'s Q and dO into stage it & 1 (cp.async), its lse2 and D
  // (plain loads)
  auto fetch = [&](int it) {
    const int hq = kvh * group + it / n_m;
    const int m0 = m_begin + (it % n_m) * BM;
    float* st = smem + (it & 1) * 2 * C::kTile;
    load_tile<HD>(st, p.q + b * p.sqb + hq * p.sqh, p.sqs, m0, p.S, p.vec_q);
    load_tile<HD>(st + C::kTile, p.dout + b * p.sdb + hq * p.sdh, p.sds, m0,
                  p.S, p.vec_q);
    cp_async_commit();
    if (threadIdx.x < 2 * BM) {
      const int i = threadIdx.x % BM, row = m0 + i;
      const long long at = (static_cast<long long>(b) * p.H + hq) * p.S + row;
      LD[(it & 1) * 2 * BM + threadIdx.x] =
          threadIdx.x < BM ? (row < p.S ? p.lse[at] * kLog2e : CUDART_INF_F)
                           : (row < p.S ? p.delta[at] : 0.f);
    }
  };
  if (n_it > 0) fetch(0);
  load_rows<HD, kBM>(Ks, p.k + b * p.skb + kvh * p.skh, p.skt, n0, p.T, 1.f);
  load_rows<HD, kBM>(Vs, p.v + b * p.svb + kvh * p.svh, p.svt, n0, p.T, 1.f);

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int m0 = m_begin + (it % n_m) * BM;
    if (it + 1 < n_it) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = smem + (it & 1) * 2 * C::kTile;
    const float* Dt = Qt + C::kTile;
    const float* ld = LD + (it & 1) * 2 * BM;

    // S^T = K (Q * scale)^T and (dK) dP^T = V dO^T: 16 keys x 32 rows a
    // warp
    float s[4][4], dp[4][4] = {};
    mm_abt<HD, P>(s, Ks + warp * 16 * C::kLd, Qt, p.q_scale);
    if (kDk) mm_abt<HD, P>(dp, Vs + warp * 16 * C::kLd, Dt, 1.f);
    const bool edge = (p.causal && m0 < n0 + kBM - 1) ||
                      (p.window > 0 && m0 + BM - 1 - n0 >= p.window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + (e >> 1) * 8;
        const int c = j * 8 + 2 * t + (e & 1), row = m0 + c;
        const bool keep = !edge || ((!p.causal || key <= row) &&
                                    (p.window <= 0 || row - key < p.window));
        bwd_grad(s[j][e], dp[j][e], ld[c], ld[BM + c], keep, p.softcap,
                 p.q_scale);
      }
    if (kDk)
      acc_ab<HD, P>(acc, dp, Qt);  // dK += dS^T Q
    else
      acc_ab<HD, P>(acc, s, Dt);   // dV += P^T dO
    __syncthreads();  // this stage is consumed before it is refilled
  }

  float* out = kDk ? p.dk + b * p.skgb + kvh * p.skgh
                   : p.dv + b * p.svgb + kvh * p.svgh;
  const long long st = kDk ? p.skgs : p.svgs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 8 * r;
    if (key >= p.T) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(out + key * st + d * 8 + 2 * t) =
          make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

template <int HD, int P>
cudaError_t launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  const size_t smem_dq = sizeof(float) * (4 * C::kTile + 2 * kBM * C::kLd);
  const size_t smem_dkv =
      sizeof(float) * (4 * C::kTile + 2 * kBM * C::kLd + 4 * C::kBN);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<HD, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_dq));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_tf32_kernel<HD, P, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_tf32_kernel<HD, P, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return e;
  // dQ first: it writes D, which the dK kernel reads
  flash_bwd_dq_tf32_kernel<HD, P>
      <<<dim3((p.S + kBM - 1) / kBM, B * p.H), kThreads, smem_dq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + kBM - 1) / kBM, B * p.Kh);
  flash_bwd_dkdv_tf32_kernel<HD, P, true>
      <<<grid, kThreads, smem_dkv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_tf32_kernel<HD, P, false>
      <<<grid, kThreads, smem_dkv, stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bwd_hd(const BwdParams& p, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<16, P>(p, B, s);
    case 32: return launch_bwd<32, P>(p, B, s);
    case 64: return launch_bwd<64, P>(p, B, s);
    case 128: return launch_bwd<128, P>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 q: (B,S,H,hd), k/v: (B,T,Kh,hd), o: (B,S,H,hd), with element
// strides given per (batch, position, head), unit stride on hd, and o 8-byte
// aligned with even strides.  products: 3 (hi*hi + hi*lo + lo*hi), or 1
// (hi*hi only, a planted fault for the checks).  `lse`, where not null,
// receives each row's log-sum-exp, (B, H, S) fp32, for the backward.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported input).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int Kh, int hd, long long sqb, long long sqs, long long sqh,
    long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sos, long long soh, int causal,
    int window, float softcap, float q_scale, int products, void* lse,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 ||
      B * H > 65535 || (products != 1 && products != 3) || sob % 2 ||
      sos % 2 || soh % 2 || reinterpret_cast<uintptr_t>(o) % 8)
    return cudaErrorInvalidValue;
  const bool vec = aligned16(k) && aligned16(v) && skb % 4 == 0 &&
                   skt % 4 == 0 && skh % 4 == 0 && svb % 4 == 0 &&
                   svt % 4 == 0 && svh % 4 == 0;
  const Params p{q,   k,   v,   o,   static_cast<float*>(lse),
                 B,   S,   T,   H,   Kh,
                 sqb, sqs, sqh, skb, skt, skh, svb, svt, svh,
                 sob, sos, soh, causal, window, softcap, q_scale,
                 static_cast<int>(vec)};
  const auto s = static_cast<cudaStream_t>(stream);
  return products == 3 ? launch_hd<3>(p, hd, s) : launch_hd<1>(p, hd, s);
}

// fp32 q, dout, o, dq: (B,S,H,hd); k, v, dk, dv: (B,T,Kh,hd), with element
// strides per (batch, position, head) and unit stride on hd; lse and delta
// (fp32 scratch for D): (B, H, S) contiguous; dq, dk, dv 8-byte aligned with
// even strides.  products: 3 (hi*hi + hi*lo + lo*hi), or 1 (hi*hi only, a
// planted fault for the checks).  Launches three kernels on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue for
// an unsupported input).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int Kh, int hd, long long sqb,
    long long sqs, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sob, long long sos,
    long long soh, long long sdb, long long sds, long long sdh,
    long long sqgb, long long sqgs, long long sqgh, long long skgb,
    long long skgs, long long skgh, long long svgb, long long svgs,
    long long svgh, int causal, int window, float softcap, float q_scale,
    int products, void* stream) {
  const long long even[9] = {sqgb, sqgs, sqgh, skgb, skgs,
                             skgh, svgb, svgs, svgh};
  for (long long e : even)
    if (e % 2) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 ||
      B * H > 65535 || (products != 1 && products != 3) ||
      reinterpret_cast<uintptr_t>(dq) % 8 ||
      reinterpret_cast<uintptr_t>(dk) % 8 ||
      reinterpret_cast<uintptr_t>(dv) % 8)
    return cudaErrorInvalidValue;
  const bool vec_kv = aligned16(k) && aligned16(v) && skb % 4 == 0 &&
                      skt % 4 == 0 && skh % 4 == 0 && svb % 4 == 0 &&
                      svt % 4 == 0 && svh % 4 == 0;
  const bool vec_q = aligned16(q) && aligned16(dout) && sqb % 4 == 0 &&
                     sqs % 4 == 0 && sqh % 4 == 0 && sdb % 4 == 0 &&
                     sds % 4 == 0 && sdh % 4 == 0;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const BwdParams p{f(q), f(k), f(v), f(o), f(dout), f(lse),
                    static_cast<float*>(delta), static_cast<float*>(dq),
                    static_cast<float*>(dk), static_cast<float*>(dv),
                    S, T, H, Kh,
                    sqb, sqs, sqh, skb, skt, skh, svb, svt, svh,
                    sob, sos, soh, sdb, sds, sdh,
                    sqgb, sqgs, sqgh, skgb, skgs, skgh, svgb, svgs, svgh,
                    causal, window, softcap, q_scale,
                    static_cast<int>(vec_kv), static_cast<int>(vec_q)};
  const auto s = static_cast<cudaStream_t>(stream);
  return products == 3 ? launch_bwd_hd<3>(p, B, hd, s)
                       : launch_bwd_hd<1>(p, B, hd, s);
}
