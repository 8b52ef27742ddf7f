// Flash-attention forward on Hopper's tensor cores (sm_90a): the bf16 route.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// `flash_fwd` (pallas_call at :90) for bf16 inputs: online-softmax attention
// with an fp32 running max, sum and accumulator; causal / sliding-window
// (q - k < window) / tanh-softcap masking; q_scale (default 1/sqrt(hd), set by
// the wrapper); bf16 output.  fp32 inputs take csrc/flash_attention.cu.
//
// Semantics as the fp32 route: the public layout q (B,S,H,hd), k/v
// (B,T,Kh,hd) read through strides (no transpose, repeat or padding copy);
// q head h reads kv head h / (H / Kh); keys at position >= T (the true
// length) are masked; a row that sees no key writes 0.
//
// Bound on the H100: operations.  Causal attention at B 4, T 2064, H 32,
// hd 128 does ~830 FLOP per byte of q/k/v/o, far above the card's ~295
// FLOP/byte ridge, so only the bf16 tensor cores (wgmma) can approach the
// least time.  Design:
//  * A block owns 128 query rows of one (b, h): two consumer warpgroups of
//    64 rows each and one producer warpgroup, of which one thread issues
//    loads.  The grid is (ceil(S/128), B*H), longest causal tiles first.
//  * Loads go through TMA on 4-D tensor maps over (hd, seq, heads, batch)
//    built from the tensors' own strides.  The Q tile is loaded once; K and
//    V tiles (128 keys x hd) go through a 2-stage ring, each tile on its own
//    "full" mbarrier, and each released by the consumers on its own "empty"
//    mbarrier as soon as the product that reads it is done.  Rows are
//    stored as column blocks of at most 128 bytes, swizzled to that width
//    (128, 64 or 32 bytes at hd >= 64, 32, 16), the layouts wgmma reads.
//    TMA fills rows past S or T with zeros; keys past T still get -inf.
//  * S = Q K^T: wgmma m64n128k16 with both operands in shared memory
//    (K-major); the fp32 accumulator stays in registers.
//  * Online softmax on the accumulator fragments: scale (and softcap), in
//    the log2 domain so that exp is one ex2; row max and sum across the
//    quad of lanes that share a row; masks only on tiles that cross the
//    diagonal, the window edge or T.  Tiles wholly outside causality or the
//    window are never loaded.
//  * O += P V: P stays in registers as wgmma's A operand (the accumulator
//    layout is the A-fragment layout), split into two bf16 parts, P_hi +
//    P_lo, each multiplied by V: as the reference's fp32 P V to ~16 bits of
//    P, where one bf16 P (8 bits) moved llama3-8b's prefill logits by
//    ~4x the output's own rounding.  V is read MN-major from shared memory
//    through the transpose bit.
//  * Software pipeline in each consumer: the product S of tile j and P V
//    of tile j - 1 are issued together, and the softmax of tile j runs
//    while P V is on the tensor cores.
//  * setmaxnreg moves registers from the producer (24) to the consumers
//    (240).  The epilogue normalises in registers and stores bf16 pairs
//    through the output strides; where the caller passes `lse` (a gradient
//    is needed) it also writes each row's log-sum-exp, which the backward
//    (flash_attention_bwd_sm90.cu) rebuilds P from.
#include "sm90.cuh"

#include <math_constants.h>

namespace {

using namespace sm90;

constexpr int kBM = 128;       // query rows per block
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile sizes of one head dim (the column blocks of sm90::Sw)
template <int HD>
struct Layout : Sw<HD> {
  static constexpr uint32_t kQBytes = kBM * HD * 2;
  static constexpr uint32_t kKVBytes = kBN * HD * 2;
  // 1024 of slack to align the tiles to the 128B swizzle's 1 KB period,
  // Q, the K and V rings, then the mbarriers (Q full; K and V full, empty)
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages);
};

struct Params {
  void* o;
  float* lse;     // (B, H, S) row log-sum-exp, natural log; null: not written
  int S, T, H, Kh;
  long long sob, sos, soh;
  int causal;
  int window;     // <= 0: none; else keep q_pos - k_pos < window
  float softcap;  // <= 0: none
  float q_scale;
};

// ---- the kernel ------------------------------------------------------------
// Accumulator fragment of wgmma m64nN (fp32): thread t of the warpgroup
// holds, for r in [0, N/2), the element at row 16 * (t / 32) + (t % 32) / 4
// + 8 * ((r / 2) % 2) and column 8 * (r / 4) + 2 * (t % 4) + r % 2.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + L::kQBytes;               // kStages K tiles
  const uint32_t s_v = s_k + kStages * L::kKVBytes;    // kStages V tiles
  const uint32_t bar = s_v + kStages * L::kKVBytes;    // mbarriers
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  // Reverse order: under causality the last query tiles do the most work,
  // so they start first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int n_end = p.causal ? min(p.T, m0 + kBM) : p.T;
  const int n_begin =
      p.window > 0 ? max(0, m0 - p.window + 1) / kBN * kBN : 0;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const int kvh = h / (p.H / p.Kh);
      mbar_expect_tx(q_full, L::kQBytes);
      tma_tile<HD, kBM>(s_q, &tm_q, q_full, m0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;
        const int n0 = n_begin + it * kBN;
        const uint32_t kt = s_k + st * L::kKVBytes;
        const uint32_t vt = s_v + st * L::kKVBytes;
        mbar_wait(k_empty(st), parity);
        mbar_expect_tx(k_full(st), L::kKVBytes);
        tma_tile<HD, kBN>(kt, &tm_k, k_full(st), n0, kvh, b);
        mbar_wait(v_empty(st), parity);
        mbar_expect_tx(v_full(st), L::kKVBytes);
        tma_tile<HD, kBN>(vt, &tm_v, v_full(st), n0, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows m0 + 64 wg .. + 63 ----
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = m0 + 64 * wg;                      // warpgroup's rows
    const int row0 = row_lo + 16 * (t / 32) + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = s_q + 64 * wg * L::kSw;

    // scores in the log2 domain: x = s * c1, or c2 * tanh(s * c3) under a
    // softcap
    const bool capped = p.softcap > 0.f;
    const float c1 = p.q_scale * kLog2e;
    const float c2 = p.softcap * kLog2e;
    const float c3 = capped ? p.q_scale / p.softcap : 0.f;

    // S = Q K^T of tile `it` into s, issued and committed, not waited for
    auto issue_s = [&](float (&s)[64], int it) {
      const int st = it % kStages;
      mbar_wait(k_full(st), (it / kStages) & 1);
      const uint32_t kt = s_k + st * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(s, desc_kmajor<HD>(q_wg, kBM, kk),
                      desc_kmajor<HD>(kt, kBN, kk), kk > 0);
      wgmma_commit();
    };
    // O += P V of tile `it`, issued and committed, not waited for
    auto issue_pv = [&](float (&o)[HD / 2],
                        const uint32_t (&pa)[2][kBN / 16][4], int it) {
      const int st = it % kStages;
      mbar_wait(v_full(st), (it / kStages) & 1);
      const uint32_t vt = s_v + st * L::kKVBytes;
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs(o, pa[part][kk], desc_mnmajor<HD>(vt, kBN, kk));
      wgmma_commit();
    };

    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    // Scores of tile `it` to probabilities, in place; updates the running
    // max and sums and returns in corr the factors that rescale O.
    auto softmax = [&](float (&s)[64], int it, float (&corr)[2]) {
      const int n0 = n_begin + it * kBN;
      if (capped) {
#pragma unroll
        for (int r = 0; r < 64; ++r) s[r] = c2 * tanh_approx(s[r] * c3);
      } else {
#pragma unroll
        for (int r = 0; r < 64; ++r) s[r] *= c1;
      }
      const bool edge = (p.causal && n0 + kBN - 1 > row_lo) ||
                        (p.window > 0 && row_lo + 63 - n0 >= p.window) ||
                        n0 + kBN > p.T;
      if (edge) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const int qp = row0 + 8 * ((r / 2) % 2);
          const int kp = n0 + 8 * (r / 4) + col0 + r % 2;
          const bool keep = kp < p.T && (!p.causal || kp <= qp) &&
                            (p.window <= 0 || qp - kp < p.window);
          if (!keep) s[r] = -CUDART_INF_F;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int r = 0; r < 64; ++r)
        mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], s[r]);
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row with every key so far masked keeps p = 0 and corr = 0
        base[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];
        corr[i] = ex2(m_run[i] - base[i]);
        m_run[i] = mx[i];
        l_run[i] *= corr[i];
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        s[r] = ex2(s[r] - base[(r / 2) % 2]);
        l_run[(r / 2) % 2] += s[r];
      }
    };
    // a K or V tile is released once the products that read it are done
    auto release_k = [&](int it) {
      if (lane == 0) mbar_arrive(k_empty(it % kStages));
    };
    auto release_v = [&](int it) {
      if (lane == 0) mbar_arrive(v_empty(it % kStages));
    };

    // Software pipeline: the product S of tile it and P V of tile it - 1
    // run on the tensor cores while the softmax of tile it runs beside P V.
    float o[HD / 2];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) o[r] = 0.f;
    float s[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) s[r] = 0.f;
    uint32_t pa[2][kBN / 16][4];
    float corr[2];
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      pin(s);
      wgmma_fence();
      issue_s(s, 0);
      wgmma_wait<0>();
      pin(s);
      release_k(0);
      softmax(s, 0, corr);
      to_a<kBN>(s, pa);
    }
    for (int it = 1; it < n_tiles; ++it) {
      pin(s);
      pin(o);
      wgmma_fence();
      issue_s(s, it);
      issue_pv(o, pa, it - 1);
      wgmma_wait<1>();  // S of tile it is done; P V runs on
      pin(s);
      release_k(it);
      softmax(s, it, corr);
      wgmma_wait<0>();
      pin(o);
      release_v(it - 1);
#pragma unroll
      for (int r = 0; r < HD / 2; ++r) o[r] *= corr[(r / 2) % 2];
      to_a<kBN>(s, pa);
    }
    if (n_tiles > 0) {
      pin(o);
      wgmma_fence();
      issue_pv(o, pa, n_tiles - 1);
      wgmma_wait<0>();
      pin(o);
      release_v(n_tiles - 1);
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[i] = l > 0.f ? 1.f / l : 0.f;
      // the row's log-sum-exp for the backward; a row that sees no key
      // gets +inf, so that its probabilities there read 0
      const int row = row0 + 8 * i;
      if (p.lse != nullptr && lane % 4 == 0 && row < p.S)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
            l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : CUDART_INF_F;
    }
    __nv_bfloat16* out =
        static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
    for (int r = 0; r < HD / 2; r += 2) {
      const int i = (r / 2) % 2;
      const int row = row0 + 8 * i;
      if (row < p.S) {
        const int col = 8 * (r / 4) + col0;
        *reinterpret_cast<__nv_bfloat162*>(out + row * p.sos + col) =
            __floats2bfloat162_rn(o[r] * inv[i], o[r + 1] * inv[i]);
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   const long long* st, const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(&tq, q, p.S, p.H, B, st[1], st[2], st[0], kBM) ||
      !encode<HD>(&tk, k, p.T, p.Kh, B, st[4], st[5], st[3], kBN) ||
      !encode<HD>(&tv, v, p.T, p.Kh, B, st[7], st[8], st[6], kBN))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<HD>::kSmem;
  static bool opted_in[64] = {};
  const cudaError_t e =
      opt_in_smem(flash_fwd_sm90_kernel<HD>, smem, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kBM - 1) / kBM, B * p.H);
  flash_fwd_sm90_kernel<HD><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// bf16 q: (B,S,H,hd), k/v: (B,T,Kh,hd), o: (B,S,H,hd), with element strides
// per (batch, position, head) and unit stride on hd.  TMA needs 16-byte
// aligned q/k/v base pointers and strides that are multiples of 8 elements
// (the wrapper checks).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported input or a
// tensor map that cuTensorMapEncodeTiled refuses).  `lse`, where not null,
// receives each row's log-sum-exp, (B, H, S) fp32, for the backward.
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int Kh, int hd, long long sqb, long long sqs, long long sqh,
    long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sos, long long soh, int causal,
    int window, float softcap, float q_scale, void* lse, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  const long long st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  const Params p{o,   static_cast<float*>(lse), S,      T,
                 H,   Kh,  sob,    sos,    soh,     causal,
                 window, softcap, q_scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, B, st, p, s);
    case 32: return launch<32>(q, k, v, B, st, p, s);
    case 64: return launch<64>(q, k, v, B, st, p, s);
    case 128: return launch<128>(q, k, v, B, st, p, s);
    default: return cudaErrorInvalidValue;
  }
}
