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

#include "sm90.cuh"
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
using tf32::split_rn;

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
// factor under a softcap), dV = P^T dO, dK = dS^T Q, dQ = dS K.
//
// Bound on the H100: operations.  The least work is five fp32-accurate
// products a (query tile, key tile) pair, S, dP, dV, dK and dQ (2.5 times
// the forward's FLOPs), each three TF32 products, so the least time is
// those FLOPs over 495 / 3 = 165 TFLOP/s.  This kernel computes each of the
// five once a pair: 15 TF32 mma.sync a pair's 8 x 8 x 8 step (the three
// kernels it replaced computed S three times and dP twice: 24).
//
// Two launches:
//  * prep: lse * log2e and D for every query row, padded to whole tiles
//    (+inf and 0 past S, so that P = dS = 0 there), into scratch; zeroes
//    the dQ tiles' counters and the work counter, and the dq rows of a tile
//    that no key block reaches (its rows see no key).
//  * main, one persistent key-major pass.  A work item is kKN = 128 keys of
//    one (b, kv head), 16 a consumer warp; K and V come into shared memory
//    once an item.  It walks the query tiles the masks leave (kBM = 64
//    rows; 32 at hd 64, 16 at hd 128), each for the group's query heads in
//    turn, with Q, dO, lse and D through two cp.async stages, each issued
//    a whole tile ahead.  Per tile each warp computes S^T = K Q^T and
//    dP^T = V dO^T once (16 keys x kBM rows), then P^T and dS^T in
//    registers, and adds dV += P^T dO and dK += dS^T Q into fp32 registers
//    that live over the whole item (written once; keys past T are not
//    written).  dS^T goes to shared memory, and the eight warps share the
//    tile's dQ partial over the item's 128 keys, dS K, a 16-row x
//    (hd / (8 / (kBM / 16)))-column piece each.  The partial goes to a staging buffer, and a writer warp
//    adds it into dq itself (fp32, so no scratch sum and no cast launch):
//    the first turn stores, each next one adds, by one bulk copy a row.
//
// Determinism: each dQ tile takes its key blocks' partials in one fixed
// order, highest key block first (`flash_attention/ops.py` `bwd_schedule`
// lists it, with rows = kBM).  A counter per (b, h, query tile) counts the
// partials made; the writer whose turn it is waits for it (acquire), adds
// its rows by bulk copies, and bumps it (release).  No float is summed in a
// varying order and no float atomic is used, so two calls are
// bit-identical.  Progress: the grid is persistent (at most one block an
// SM; the shared memory allows no second) and every block takes its next
// item from a counter, highest key block first, so an item waits only on
// the partials of items of higher key blocks, which came earlier in that
// order and whose blocks are running; no wait is circular.
//
// mma.sync and not wgmma, by the operands: wgmma reads a 32-bit operand
// from shared memory K-major only.  dV = P^T dO and dK = dS^T Q take dO and
// Q with the row axis as K, so wgmma would need a transposed copy of every
// streamed Q and dO tile besides the K-major one that S^T and dP^T read;
// at hd 128 K and V alone take 128 KB of the 227, and the two orientations
// of a 32-row Q and dO tile (hi and lo planes each) another 128 KB.
// mma.sync m16n8k8 reads its fragments from shared memory in any order, so
// one [rows][hd] copy of each tile serves both orientations.  Warps: two
// warpgroups of mma.sync consumer warps and a third whose first warp is the
// writer; setmaxnreg gives each consumer 232 registers (an SM's 64K over
// 384 threads would be 168, and with nine warps one of the four schedulers
// holds three): dK and dV of 16 keys at hd 128 take 128 of them, S^T and
// dP^T of 16 rows another 16 (of 32 rows, the kernel spilled).
//
// Operands split once a read, by `split_rn` (tf32.cuh: an integer add, a
// mask and an fp32 add, no conversion): K, V, Q and dO lie in shared
// memory as fp32 and each fragment value is split where a warp reads it;
// P^T and dS^T are split once in registers.  Raw fp32 and not hi / lo
// planes: no fragment of mma.sync is shared between warps, so every warp
// reads every B value it uses, and planes would double the shared-memory
// bytes of each read and of each resident tile.  `split_rn` and not
// `split_rz`: hi rounded to nearest leaves lo of either sign, so the
// tensor cores' truncation of lo does not bias every product toward zero.
// On an H100 at B4 T2048 H16 Kh8 hd128 causal the worst error read 0.52 of
// TOL32 against split_rz's 0.97 and `split`'s (cvt.rna) 0.57, in 5.23 ms
// against 5.47 and 6.84 (conversions issue at a quarter rate).
//
// Precision as the forward: three TF32 products (hi*hi + hi*lo + lo*hi;
// `products` = 1 keeps hi*hi, the planted fault), and since the tensor
// cores' fp32 sums truncate, dV, dK (over rows) and dQ (over keys) are each
// summed 16 rows or keys a part in their own accumulators and the parts
// added with round to nearest; S^T and dP^T sum over hd in one, as the
// forward's S does.
//
// Shared memory: tiles [rows][hd] fp32 whose 8-float groups are permuted
// by the row (`swz_x`), so that the fragment reads of both orientations (a
// float2 of two dims of one row; one value of two rows of one dim) hit 32
// banks; dS [kBM][kKN + 8] and the dQ staging rows [kBM][hd + 8], padded.

constexpr int kBwdWarps = 8;                      // consumer warps
constexpr int kBwdConsumers = 32 * kBwdWarps;
// and a third warpgroup, whose first warp is the writer (registers are
// allotted by warpgroup: setmaxnreg 40 there, 232 for the consumers)
constexpr int kBwdThreads = kBwdConsumers + 128;
constexpr int kKN = 16 * kBwdWarps;               // keys a work item

template <int HD>
struct BwdCfg {
  // query rows a tile: 16 at hd 128 and 32 at hd 64 keep S^T and dP^T
  // (kBM / 4 registers each) beside dK and dV (hd / 4 each) within the
  // consumers' 232 registers, spill-free
  static constexpr int kBM = HD == 128 ? 16 : HD == 64 ? 32 : 64;
  static constexpr int kNT = kBM / 8;              // 8-row tiles of S^T
  // dQ staging buffers: at hd 128 a second read 2.5% slower on the H100
  // (5.42-5.50 against 5.31-5.39 ms in turns at B4 T2048 H16 Kh8 causal)
  static constexpr int kBufs = HD == 128 ? 1 : 2;
  static constexpr int kDsLd = kKN + 8;            // floats a dS row
  static constexpr int kDqLd = HD + 8;             // floats a staged dQ row
  // the dQ tile's pieces: kBM / 16 row tiles, each over kSplit warps
  static constexpr int kSplit = kBwdWarps / (kBM / 16);
  static constexpr int kDqCols = HD / kSplit;      // dQ columns a warp
  // a stage: Q, dO (kBM x HD each), lse * log2e, D (kBM each)
  static constexpr int kStage = 2 * kBM * HD + 2 * kBM;
  static constexpr int kOffV = kKN * HD;
  static constexpr int kOffStage = 2 * kKN * HD;
  static constexpr int kOffDs = kOffStage + 2 * kStage;
  static constexpr int kOffDq = kOffDs + kBM * kDsLd;
  static constexpr int kOffInfo = kOffDq + kBufs * kBM * kDqLd;  // 8 ints
  static constexpr int kOffBar = kOffInfo + 8;  // full, empty a buffer
  static constexpr int kSmem = 4 * kOffBar + 16 * kBufs;
  static_assert(kSmem <= 232448, "shared memory a block");
  static_assert(kDqCols % 8 == 0, "whole 8-column tiles a warp");
};

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // (B, H, S), natural log
  float* ld;         // (2, B, H, Sp): lse * log2e, then D
  int* counts;       // (B, H, n_mt) dQ partials made, then the work counter
  float* dq;
  float* dk;
  float* dv;
  int B, S, T, H, Kh;
  int n_mt, nb;  // kBM-row query tiles (Sp = kBM n_mt), kKN-key blocks
  long long sqb, sqs, sqh, skb, skt, skh, svb, svt, svh;
  long long sob, sos, soh, sdb, sds, sdh;
  long long sqgb, sqgs, sqgh, skgb, skgs, skgh, svgb, svgs, svgh;
  int causal;
  int window;     // <= 0: none; else keep q_pos - k_pos < window
  float softcap;  // <= 0: none
  float q_scale;
  int vec_kv;  // k and v rows are 16-byte aligned
  int vec_q;   // q and dout rows are 16-byte aligned
};

// P and dS of one score s = (q . k) * scale (the forward's S) with dp =
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

// The XOR that places row r's 8-float groups: element (r, d) of a [rows][HD]
// tile lies at r * HD + (d ^ swz_x<HD>(r)).  Rows r, r + 4 take other
// groups, as do rows 2i and 2i + 1's (i = 0..3) two sets, so that reads of
// rows g (g = 0..3) x dims 2t, 2t+1 and of rows 2t + e x dims 8d + g both
// meet 32 banks (hd >= 32; hd 16 is not permuted).
template <int HD>
__device__ __forceinline__ int swz_x(int r) {
  if constexpr (HD < 32) return 0;
  else return ((r & 3) ^ ((r >> 2) & 1)) << 3;
}

__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kBwdConsumers)
               : "memory");
}

// rows [r0, r0 + R) of one head into a swizzled [R][HD] tile by the
// consumers' cp.async, zero past n
template <int HD, int R>
__device__ __forceinline__ void load_sw(float* dst, const float* src,
                                        long long st, int r0, int n,
                                        bool vec) {
  if (vec) {
    constexpr int kC = HD / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < R * kC; i += kBwdConsumers) {
      const int r = i / kC, c = (i % kC) * 4, row = r0 + r;
      cp_async16(dst + r * HD + (c ^ swz_x<HD>(r)),
                 src + (row < n ? row * st + c : 0), row < n ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < R * HD; i += kBwdConsumers) {
      const int r = i / HD, d = i % HD, row = r0 + r;
      cp_async4(dst + r * HD + (d ^ swz_x<HD>(r)),
                src + (row < n ? row * st + d : 0), row < n ? 4 : 0);
    }
  }
}

// The first (highest) key block whose dQ partial query tile m takes: the
// turn of block n there is first_block - n.
__device__ __forceinline__ int first_block(const BwdParams& p, int m,
                                           int bm) {
  return p.causal ? min(p.nb - 1, m * bm / kKN) : p.nb - 1;
}

// The query tiles [m_begin, m_begin + n_m) that key block n walks: from its
// first key under causality to its last key + window - 1 under a window
// (`bwd_schedule` in flash_attention/ops.py computes the same).
__device__ __forceinline__ void walk(const BwdParams& p, int n, int bm,
                                     int& m_begin, int& n_m) {
  m_begin = p.causal ? n * kKN / bm : 0;
  long long end = p.S;
  if (p.window > 0)
    end = min(end, static_cast<long long>(min(p.T, (n + 1) * kKN)) - 1 +
                       p.window);
  n_m = max(0, static_cast<int>((end + bm - 1) / bm) - m_begin);
}

// ---- prep: lse * log2e, D; counters; dq rows no key block reaches --------
// Grid (n_mt, B * H), 128 threads: a warp a row, its lanes over hd.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_prep_tf32_kernel(
    BwdParams p) {
  constexpr int BM = BwdCfg<HD>::kBM;
  const int m = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long sp = static_cast<long long>(p.n_mt) * BM;
  for (int r = warp; r < BM; r += 4) {
    const int row = m * BM + r;
    float acc = 0.f;
    if (row < p.S) {
      const float* o = p.o + b * p.sob + h * p.soh + row * p.sos;
      const float* d = p.dout + b * p.sdb + h * p.sdh + row * p.sds;
      for (int c = lane; c < HD; c += 32) acc = fmaf(o[c], d[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const long long at = bh * sp + row;
      p.ld[at] = row < p.S
                     ? p.lse[static_cast<long long>(bh) * p.S + row] * kLog2e
                     : CUDART_INF_F;
      p.ld[p.B * p.H * sp + at] = acc;
    }
  }
  // a tile no key block reaches: its rows see no key, dq = 0
  int m_begin, n_m;
  walk(p, first_block(p, m, BM), BM, m_begin, n_m);
  if (m >= m_begin + n_m) {
    float* dq = p.dq + b * p.sqgb + h * p.sqgh;
    for (int i = threadIdx.x; i < BM * HD; i += 128) {
      const int row = m * BM + i / HD;
      if (row < p.S) dq[row * p.sqgs + i % HD] = 0.f;
    }
  }
  // the tiles' counters and the work counter
  const long long n_counts = static_cast<long long>(p.B) * p.H * p.n_mt + 1;
  for (long long i = (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * 128 + threadIdx.x;
       i < n_counts; i += 128ll * gridDim.x * gridDim.y)
    p.counts[i] = 0;
}

// acc[16 keys x HD] += A B over a tile's rows, 16 a part, each part summed
// in its own accumulator and added with round to nearest: A (16 keys x 8 NT
// rows) in accumulator layout (a[j]: keys (g, g, g+8, g+8) x rows (2t,
// 2t+1, 2t, 2t+1) of row tile j), split once; B the tile's [rows][HD] in
// shared memory, its rows read in the accumulator's order (logical k t ->
// row 2t, t + 4 -> 2t + 1), at the lane's offsets `ob` (the kernel's).
template <int HD, int NT, int P>
__device__ __forceinline__ void acc_rows(float (&acc)[HD / 8][4],
                                         const float (&a)[NT][4],
                                         const float* b,
                                         const int (&ob)[2][4]) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      split_rn(a[j + u][0], ah[u][0], al[u][0]);
      split_rn(a[j + u][2], ah[u][1], al[u][1]);
      split_rn(a[j + u][1], ah[u][2], al[u][2]);
      split_rn(a[j + u][3], ah[u][3], al[u][3]);
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* r = b + 8 * (j + u) * HD + 32 * (d / 4);
        uint32_t h0, l0, h1, l1;
        split_rn(r[ob[0][d % 4]], h0, l0);
        split_rn(r[ob[1][d % 4]], h1, l1);
        mma3<P>(part, ah[u], al[u], h0, l0, h1, l1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] += part[e];
    }
  }
}

// ---- main: S^T, dP^T once a pair; dK, dV; dQ partials ----------------------
// mma.sync m16n8k8 fragments (g = lane / 4, t = lane % 4): A rows g, g + 8
// x k (t, t + 4); B k (t, t + 4) x column g; C rows g, g + 8 x columns 2t,
// 2t + 1.  Where both operands come from memory, logical k t, t + 4 are the
// physical 2t, 2t + 1 (a float2 of each operand); where A is an
// accumulator (P^T, dS^T), its columns 2t, 2t + 1 already are, and B's
// rows are read in that order.
template <int HD, int P>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_tf32_kernel(BwdParams p) {
  using C = BwdCfg<HD>;
  constexpr int BM = C::kBM, NT = C::kNT, DT = HD / 8;
  constexpr int kDT = C::kDqCols / 8;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const Ks = sm;
  float* const Vs = sm + C::kOffV;
  float* const Ds = sm + C::kOffDs;  // dS [BM][kDsLd]
  auto stage = [&](int st) { return sm + C::kOffStage + st * C::kStage; };
  auto staging = [&](int i) { return sm + C::kOffDq + i * BM * C::kDqLd; };
  // [0]: the item; [2 + 2 i], [3 + 2 i]: staging buffer i's tile (-1: stop)
  // and turn
  const uint32_t info = sm90::smem_addr(sm + C::kOffInfo);
  const uint32_t bar = sm90::smem_addr(sm + C::kOffBar);
  auto full = [&](int i) { return bar + 16 * i; };
  auto empty = [&](int i) { return bar + 16 * i + 8; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = p.H / p.Kh;
  const int n_items = p.nb * p.B * p.Kh;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kBufs; ++i) {
      sm90::mbar_init(full(i), kBwdConsumers);
      sm90::mbar_init(empty(i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == 2) {
    sm90::setmaxnreg_dec<40>();
    if (warp > kBwdWarps) return;
    // ---- the writer: each staged dQ partial into dq rows, in its turn ----
    for (int j = 0;; ++j) {
      const int buf = j % C::kBufs;
      sm90::mbar_wait(full(buf), (j / C::kBufs) & 1);
      const int tile = sm90::lds_volatile(info + 4 * (2 + 2 * buf));
      const int turn = sm90::lds_volatile(info + 4 * (3 + 2 * buf));
      if (tile < 0) break;
      int* const flag = p.counts + tile;
      sm90::wait_flag(flag, turn);
      sm90::fence_async_global();
      const int bh = tile / p.n_mt, m = tile % p.n_mt;
      float* const dq =
          p.dq + bh / p.H * p.sqgb + bh % p.H * p.sqgh;
      const float* const src = staging(buf);
      for (int r = lane; r < BM; r += 32) {
        const int row = m * BM + r;
        if (row >= p.S) break;
        const uint32_t s = sm90::smem_addr(src + r * C::kDqLd);
        if (turn == 0)
          sm90::bulk_store(dq + row * p.sqgs, s, HD * 4);
        else
          sm90::bulk_add_f32(dq + row * p.sqgs, s, HD * 4);
      }
      sm90::bulk_commit();
      sm90::bulk_wait_read();  // the buffer is read: it may be refilled
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty(buf));
      sm90::bulk_wait_all();
      sm90::fence_async_global();
      __syncwarp();
      if (lane == 0) {
        __threadfence();
        sm90::bump_flag(flag);
      }
    }
    return;
  }

  // ---- consumers: warp `warp` owns keys 16 warp .. + 15 of an item ------
  sm90::setmaxnreg_inc<232>();
  const int g = lane / 4, t = lane % 4;
  // Offsets (floats) of this lane's fragment reads in a [rows][HD] tile,
  // by the 8-float group i of a 32-float block: `swz_x` permutes the groups
  // within each block alike, so group 4 c + i lies at 32 c + the offset of
  // group i, and the unrolled loops add only constants to four offsets (no
  // XOR a group kept live).  oa: rows g (+ 8 j), dims 2t, 2t + 1 (the S^T
  // and dP^T reads); ob[e]: rows 2t + e (+ 8 j), dim g (the B reads over
  // rows or keys).
  int oa[4], ob[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    oa[i] = g * HD + 8 * (i ^ swz_x<HD>(g) / 8) + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ob[e][i] = (2 * t + e) * HD + 8 * (i ^ swz_x<HD>(2 * t + e) / 8) + g;
  }
  // this warp's piece of a tile's dQ: rows 16 mt .., columns cq ..
  const int mt = warp % (BM / 16), cq = warp / (BM / 16) * C::kDqCols;
  // K row 2t + e's column cq + 8 d + g (the dQ B reads)
  auto kcol = [&](int e, int d) {
    if constexpr (C::kDqCols % 32 == 0)
      return ob[e][d] + cq;
    else
      return (2 * t + e) * HD + ((cq + 8 * d + g) ^ swz_x<HD>(2 * t + e));
  };
  int it_s = 0;  // the tiles walked so far: their stage and staging buffer
  for (;;) {
    consumer_sync(1);  // the last item's K, V and dS are read
    if (threadIdx.x == 0)
      sm90::sts_volatile(info, atomicAdd(p.counts + static_cast<long long>(
                                             p.B) * p.H * p.n_mt, 1));
    consumer_sync(1);
    const int item = sm90::lds_volatile(info);
    if (item >= n_items) break;
    const int bk = p.B * p.Kh;
    const int n = p.nb - 1 - item / bk;
    const int b = item % bk / p.Kh, kvh = item % p.Kh;
    int m_begin, n_m;
    walk(p, n, BM, m_begin, n_m);
    const int steps = n_m * group;

    // the tile of step `s` (query tile m_begin + s / group, head
    // kvh * group + s % group) into stage `st`
    auto fetch = [&](int s, int st) {
      const int m0 = (m_begin + s / group) * BM;
      const int hq = kvh * group + s % group;
      float* const d = stage(st);
      load_sw<HD, BM>(d, p.q + b * p.sqb + hq * p.sqh, p.sqs, m0, p.S,
                      p.vec_q);
      load_sw<HD, BM>(d + BM * HD, p.dout + b * p.sdb + hq * p.sdh, p.sds,
                      m0, p.S, p.vec_q);
      if (threadIdx.x < BM / 2) {  // lse * log2e, then D: BM / 4 each
        const int i = threadIdx.x % (BM / 4), which = threadIdx.x / (BM / 4);
        const long long sp = static_cast<long long>(p.n_mt) * BM;
        const float* src = p.ld + which * p.B * p.H * sp +
                           (static_cast<long long>(b) * p.H + hq) * sp + m0 +
                           4 * i;
        cp_async16(d + 2 * BM * HD + which * BM + 4 * i, src, 16);
      }
    };
    if (steps > 0) {
      load_sw<HD, kKN>(Ks, p.k + b * p.skb + kvh * p.skh, p.skt, n * kKN,
                       p.T, p.vec_kv);
      load_sw<HD, kKN>(Vs, p.v + b * p.svb + kvh * p.svh, p.svt, n * kKN,
                       p.T, p.vec_kv);
      fetch(0, it_s & 1);
    }
    cp_async_commit();

    float dk[DT][4], dv[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
    const float* const Kw = Ks + 16 * warp * HD;
    const float* const Vw = Vs + 16 * warp * HD;

    for (int s = 0; s < steps; ++s, ++it_s) {
      const int m = m_begin + s / group;
      const int m0 = m * BM;
      cp_async_wait<0>();
      consumer_sync(1);  // the tile landed; the other stage and dS are free
      if (s + 1 < steps) fetch(s + 1, (it_s + 1) & 1);
      cp_async_commit();
      const float* const Qs = stage(it_s & 1);
      const float* const Os = Qs + BM * HD;
      const float* const L2 = Qs + 2 * BM * HD;  // lse * log2e; D at + BM

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x BM rows
      float s_[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        const int a = oa[kk % 4] + 32 * (kk / 4);
        uint32_t kh[4], kl[4], vh[4], vl[4];
        {
          const float2 a0 = *reinterpret_cast<const float2*>(Kw + a);
          const float2 a1 = *reinterpret_cast<const float2*>(Kw + a + 8 * HD);
          split_rn(a0.x, kh[0], kl[0]);
          split_rn(a1.x, kh[1], kl[1]);
          split_rn(a0.y, kh[2], kl[2]);
          split_rn(a1.y, kh[3], kl[3]);
          const float2 c0 = *reinterpret_cast<const float2*>(Vw + a);
          const float2 c1 = *reinterpret_cast<const float2*>(Vw + a + 8 * HD);
          split_rn(c0.x, vh[0], vl[0]);
          split_rn(c1.x, vh[1], vl[1]);
          split_rn(c0.y, vh[2], vl[2]);
          split_rn(c1.y, vh[3], vl[3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t h0, l0, h1, l1;
          const float2 qv =
              *reinterpret_cast<const float2*>(Qs + a + 8 * j * HD);
          split_rn(qv.x, h0, l0);
          split_rn(qv.y, h1, l1);
          mma3<P>(s_[j], kh, kl, h0, l0, h1, l1);
          const float2 ov =
              *reinterpret_cast<const float2*>(Os + a + 8 * j * HD);
          split_rn(ov.x, h0, l0);
          split_rn(ov.y, h1, l1);
          mma3<P>(dp[j], vh, vl, h0, l0, h1, l1);
        }
      }

      // P^T and dS^T in place; s_[j] holds keys (g, g, g+8, g+8) x rows
      // (2t, 2t+1, 2t, 2t+1) of row tile j
      // this warp's first key, from the key block read anew (so that the
      // compiler keeps no copy live across the loop: registers are scarce)
      int n_now;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(n_now) : "r"(n));
      const int key_w = n_now * kKN + 16 * warp;
      const bool edge = key_w + 15 >= p.T ||
                        (p.causal && m0 < key_w + 15) ||
                        (p.window > 0 && m0 + BM - 1 - key_w >= p.window);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(L2 + 8 * j + 2 * t);
        const float2 dd =
            *reinterpret_cast<const float2*>(L2 + BM + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + g + (e >> 1) * 8;
          const int row = m0 + 8 * j + 2 * t + (e & 1);
          const bool keep =
              !edge || (key < p.T && (!p.causal || key <= row) &&
                        (p.window <= 0 || row - key < p.window));
          s_[j][e] *= p.q_scale;
          bwd_grad(s_[j][e], dp[j][e], e & 1 ? l2.y : l2.x,
                   e & 1 ? dd.y : dd.x, keep, p.softcap, p.q_scale);
        }
      }

      // dS^T to shared memory as dS [row][key] for the dQ product
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ds[(8 * j + 2 * t + (e & 1)) * C::kDsLd + 16 * warp + g +
             (e >> 1) * 8] = dp[j][e];

      // dV += P^T dO, then dK += dS^T Q, over the tile's rows, 16 a part
      acc_rows<HD, NT, P>(dv, s_, Os, ob);
      acc_rows<HD, NT, P>(dk, dp, Qs, ob);
      consumer_sync(2);  // dS is whole

      // this warp's piece of the tile's dQ partial, dS K over the item's
      // keys, 16 a part
      float dq[kDT][4];
#pragma unroll
      for (int d = 0; d < kDT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kKN / 8; ks += 2) {
        float part[kDT][4];
#pragma unroll
        for (int d = 0; d < kDT; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[d][e] = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = 8 * (ks + u) + 2 * t;
          const float2 a0 = *reinterpret_cast<const float2*>(
              Ds + (16 * mt + g) * C::kDsLd + key);
          const float2 a1 = *reinterpret_cast<const float2*>(
              Ds + (16 * mt + g + 8) * C::kDsLd + key);
          uint32_t ah[4], al[4];
          split_rn(a0.x, ah[0], al[0]);
          split_rn(a1.x, ah[1], al[1]);
          split_rn(a0.y, ah[2], al[2]);
          split_rn(a1.y, ah[3], al[3]);
#pragma unroll
          for (int d = 0; d < kDT; ++d) {
            uint32_t h0, l0, h1, l1;
            split_rn(Ks[8 * (ks + u) * HD + kcol(0, d)], h0, l0);
            split_rn(Ks[8 * (ks + u) * HD + kcol(1, d)], h1, l1);
            mma3<P>(part[d], ah, al, h0, l0, h1, l1);
          }
        }
#pragma unroll
        for (int d = 0; d < kDT; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[d][e] += part[d][e];
      }

      // to the staging buffer, for the writer
      const int buf = it_s % C::kBufs;
      sm90::mbar_wait(empty(buf), ((it_s / C::kBufs) & 1) ^ 1);
      float* const out = staging(buf);
#pragma unroll
      for (int d = 0; d < kDT; ++d)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(
              out + (16 * mt + g + 8 * i) * C::kDqLd + cq + 8 * d + 2 * t) =
              make_float2(dq[d][2 * i], dq[d][2 * i + 1]);
      if (threadIdx.x == 0) {
        const int hq = kvh * group + s % group;
        sm90::sts_volatile(info + 4 * (2 + 2 * buf),
                           (b * p.H + hq) * p.n_mt + m);
        sm90::sts_volatile(info + 4 * (3 + 2 * buf),
                           first_block(p, m, BM) - n);
      }
      sm90::fence_async_shared();
      sm90::mbar_arrive(full(buf));
    }
    cp_async_wait<0>();

    // dK and dV of the group, keys past T left out
    float* const ok = p.dk + b * p.skgb + kvh * p.skgh;
    float* const ov = p.dv + b * p.svgb + kvh * p.svgh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = n * kKN + 16 * warp + g + 8 * i;
      if (key >= p.T) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<float2*>(ok + key * p.skgs + 8 * d + 2 * t) =
            make_float2(dk[d][2 * i], dk[d][2 * i + 1]);
        *reinterpret_cast<float2*>(ov + key * p.svgs + 8 * d + 2 * t) =
            make_float2(dv[d][2 * i], dv[d][2 * i + 1]);
      }
    }
  }
  // no items left: the writer stops at a tile of -1
  const int buf = it_s % C::kBufs;
  sm90::mbar_wait(empty(buf), ((it_s / C::kBufs) & 1) ^ 1);
  if (threadIdx.x == 0) sm90::sts_volatile(info + 4 * (2 + 2 * buf), -1);
  sm90::mbar_arrive(full(buf));
}

template <int HD, int P>
cudaError_t launch_bwd(BwdParams p, cudaStream_t stream) {
  using C = BwdCfg<HD>;
  static bool opted[64] = {};
  cudaError_t e = sm90::opt_in_smem(flash_bwd_tf32_kernel<HD, P>, C::kSmem,
                                    opted);
  if (e != cudaSuccess) return e;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  flash_bwd_prep_tf32_kernel<HD><<<dim3(p.n_mt, p.B * p.H), 128, 0,
                                   stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_tf32_kernel<HD, P>
      <<<min(sms, p.nb * p.B * p.Kh), kBwdThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bwd_hd(const BwdParams& p, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<16, P>(p, s);
    case 32: return launch_bwd<32, P>(p, s);
    case 64: return launch_bwd<64, P>(p, s);
    case 128: return launch_bwd<128, P>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

int bwd_rows(int hd) {
  switch (hd) {
    case 16: return BwdCfg<16>::kBM;
    case 32: return BwdCfg<32>::kBM;
    case 64: return BwdCfg<64>::kBM;
    case 128: return BwdCfg<128>::kBM;
    default: return 0;
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
// strides per (batch, position, head) and unit stride on hd; lse: (B, H, S)
// contiguous.  `scratch`, 16-byte aligned, holds (2, B, H, Sp) fp32 lse *
// log2e and D, then int counters: (B, H, n_mt) and the work counter (n_mt
// = ceil(S / rows), Sp = rows n_mt; rows: 32 at hd 128, else 64, ops.py's
// `BWD_ROWS_F32`; `_bwd_scratch` there allocates it).  dq rows are
// written by bulk copies: dq 16-byte aligned, its strides multiples of 4;
// dk, dv 8-byte aligned with even strides.  products: 3 (hi*hi + hi*lo +
// lo*hi), or 1 (hi*hi only, a planted fault for the checks).  Launches two
// kernels on `stream` (prep, then the persistent main pass), allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported input).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int Kh, int hd, long long sqb,
    long long sqs, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sob, long long sos,
    long long soh, long long sdb, long long sds, long long sdh,
    long long sqgb, long long sqgs, long long sqgh, long long skgb,
    long long skgs, long long skgh, long long svgb, long long svgs,
    long long svgh, int causal, int window, float softcap, float q_scale,
    int products, void* stream) {
  const long long even[6] = {skgb, skgs, skgh, svgb, svgs, svgh};
  for (long long e : even)
    if (e % 2) return cudaErrorInvalidValue;
  const int rows = bwd_rows(hd);
  if (B <= 0 || S <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 || rows == 0 ||
      static_cast<long long>(B) * H > 65535 ||
      (products != 1 && products != 3) || sqgb % 4 || sqgs % 4 ||
      sqgh % 4 || !aligned16(dq) || !aligned16(scratch) ||
      reinterpret_cast<uintptr_t>(dk) % 8 ||
      reinterpret_cast<uintptr_t>(dv) % 8)
    return cudaErrorInvalidValue;
  const int n_mt = (S + rows - 1) / rows, nb = (T + kKN - 1) / kKN;
  const long long sp = static_cast<long long>(n_mt) * rows;
  if (static_cast<long long>(nb) * B * Kh > (1ll << 30) ||
      static_cast<long long>(B) * H * n_mt > (1ll << 30))
    return cudaErrorInvalidValue;
  const bool vec_kv = aligned16(k) && aligned16(v) && skb % 4 == 0 &&
                      skt % 4 == 0 && skh % 4 == 0 && svb % 4 == 0 &&
                      svt % 4 == 0 && svh % 4 == 0;
  const bool vec_q = aligned16(q) && aligned16(dout) && sqb % 4 == 0 &&
                     sqs % 4 == 0 && sqh % 4 == 0 && sdb % 4 == 0 &&
                     sds % 4 == 0 && sdh % 4 == 0;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  float* const ld = static_cast<float*>(scratch);
  const BwdParams p{f(q), f(k), f(v), f(o), f(dout), f(lse), ld,
                    reinterpret_cast<int*>(ld + 2 * B * H * sp),
                    static_cast<float*>(dq), static_cast<float*>(dk),
                    static_cast<float*>(dv),
                    B, S, T, H, Kh, n_mt, nb,
                    sqb, sqs, sqh, skb, skt, skh, svb, svt, svh,
                    sob, sos, soh, sdb, sds, sdh,
                    sqgb, sqgs, sqgh, skgb, skgs, skgh, svgb, svgs, svgh,
                    causal, window, softcap, q_scale,
                    static_cast<int>(vec_kv), static_cast<int>(vec_q)};
  const auto s = static_cast<cudaStream_t>(stream);
  return products == 3 ? launch_bwd_hd<3>(p, hd, s)
                       : launch_bwd_hd<1>(p, hd, s);
}
