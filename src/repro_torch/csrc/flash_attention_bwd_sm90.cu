// Flash-attention backward on Hopper's tensor cores (sm_90a): the bf16 route.
//
// Replaces the reference's lax backward src/repro/kernels/flash_attention/
// ops.py:62 `_vjp_bwd` (the VJP of models/layers.py `attention_chunked`,
// which the Pallas forward's custom_vjp takes) for bf16 inputs: dQ, dK and
// dV of O = softmax(softcap(Q K^T * scale) + mask) V, with the forward's
// causal / sliding-window (q - k < window) masks, tanh softcap, q_scale and
// GQA (q head h reads kv head h / (H / Kh); dK and dV sum over the group).
// fp32 inputs take csrc/flash_attention.cu's backward.
//
// From the forward's row log-sum-exp `lse` (flash_attention_sm90.cu writes
// it where a gradient is needed), with x the forward's score in the log2
// domain, per (query row i, key j):
//   P = exp2(x - lse * log2e)         D_i = sum_c dO[i, c] O[i, c]
//   dP = dO V^T                       dS = P o (dP - D) o (1 - tanh^2) * scale
//   dV = P^T dO                       dK = dS^T Q        dQ = dS K
// (the tanh factor only under a softcap: x = cap * tanh(s * scale / cap)).
//
// Two kernels, so that every output element is written once, by one block,
// in a fixed order: no float atomics, and a restart is bit-exact.
//  * dQ (first launch): a block owns 128 query rows of one (b, h), two
//    consumer warpgroups of 64 rows and one producer warpgroup, as the
//    forward.  Its prologue computes D for its rows from dO and O (fp32)
//    and writes it for the second launch.  Q and dO are loaded once by TMA;
//    K and V tiles of 64 keys go through a 2-stage ring (full / empty
//    mbarriers), only the tiles the causal mask and the window leave.  Per
//    tile: S = Q K^T and dP = dO V^T (wgmma, both operands in shared
//    memory), P and dS in registers, dQ += dS K (dS from registers, K read
//    MN-major through the transpose bit).
//  * dK / dV (second launch): a block owns 128 keys of one (b, kv head),
//    64 a consumer warpgroup; K and V are loaded once.  It walks the group's
//    H / Kh query heads and, for each, the 64-row Q / dO tiles the masks
//    leave, through a 2-stage TMA ring.  Per tile: S^T = K Q^T, dP^T =
//    V dO^T, then P^T and dS^T, dV += P^T dO, dK += dS^T Q.  The tile's lse
//    and D pass through a small shared buffer of the warpgroup.  dK and dV
//    stay in fp32 registers over the whole group and are written once.
//  * Masks only on tiles that cross the diagonal or the window edge; keys
//    at position >= T are masked in dQ (the dK / dV rows past T are not
//    written); query rows past S read lse = +inf (P = 0) and D = 0.
//
// Precision.  Q, K, V and dO are exact in bf16, so S and dP are one bf16
// product each.  P and dS are fp32 values; each enters its product as bf16
// hi + lo, two wgmma products (sm90::split_bf16), as the forward's P V
// does: one bf16 part would carry 8 bits of them.  That is 10 bf16 products
// a (query tile, key tile) pair over the two kernels, where the least work
// is 3.5 forward products' worth (chip_smoke._bound's count).
//
// Bound on the H100: operations (the backward does 2.5x the forward's
// FLOPs on the same bytes; the forward is ~830 FLOP a byte at qwen3's
// training shape).  Design for it: wgmma on every product, TMA loads,
// setmaxnreg 24 / 240 between producer and consumers.  No warpgroup
// pipelines its own tiles (the forward issues tile j + 1's S with tile j's
// P V): the two consumer warpgroups of a block interleave on the tensor
// cores instead.  In dK / dV a second tile's S^T and dP^T would not fit in
// registers beside dK and dV (128 a thread at hd 128).
#include "sm90.cuh"

#include <math_constants.h>

namespace {

using namespace sm90;

constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kStages = 2;     // TMA ring depth
constexpr float kLog2e = 1.4426950408889634f;
// dQ kernel: query rows a block (64 a consumer warpgroup), keys a K/V tile
constexpr int kQM = 128, kQN = 64;
// dK / dV kernel: keys a block (64 a consumer warpgroup), rows a Q/dO tile
constexpr int kKN = 128, kKM = 64;

template <int HD>
struct Tiles : Sw<HD> {
  static constexpr uint32_t kQBytes = kQM * HD * 2;   // dQ: Q, dO
  static constexpr uint32_t kKVBytes = kQN * HD * 2;  // dQ: a K, V stage
  static constexpr uint32_t kKBytes = kKN * HD * 2;   // dK/dV: K, V
  static constexpr uint32_t kRowBytes = kKM * HD * 2;  // dK/dV: Q, dO stage
  // 1024 of slack to align the tiles to the 128B swizzle's 1 KB period;
  // then the tiles, (dK/dV) the lse / D buffers, the mbarriers
  static constexpr int kSmemDq =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages);
  static constexpr int kSmemDkv = 1024 + 2 * kKBytes + 2 * kStages * kRowBytes +
                                  2 * 2 * 2 * kKM * 4 + 8 * (1 + 2 * kStages);
};

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, S), natural log
  float* delta;      // (B, H, S): D, written by the dQ kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, T, H, Kh;
  long long sob, sos, soh;     // o
  long long sdb, sds, sdh;     // dout
  long long sqgb, sqgs, sqgh;  // dq
  long long skgb, skgs, skgh;  // dk
  long long svgb, svgs, svgh;  // dv
  int causal;
  int window;     // <= 0: none; else keep q_pos - k_pos < window
  float softcap;  // <= 0: none
  float q_scale;
};

// P and dS of one score from the forward's arithmetic: x = s * c1, or c2 *
// tanh(s * c3) under a softcap, in the log2 domain as the forward computes
// it (so that P sums to 1 against its lse).
struct Grad {
  bool capped;
  float c1, c2, c3, scale;
  __device__ explicit Grad(const Params& p)
      : capped(p.softcap > 0.f),
        c1(p.q_scale * kLog2e),
        c2(p.softcap * kLog2e),
        c3(p.softcap > 0.f ? p.q_scale / p.softcap : 0.f),
        scale(p.q_scale) {}
  // s: the raw score q . k; dp: dO . v; lse2: the row's lse * log2e;
  // d: the row's D.  Writes P to s and dS to dp.
  __device__ __forceinline__ void operator()(float& s, float& dp, float lse2,
                                             float d, bool keep) const {
    float x, dz = 1.f;
    if (capped) {
      const float th = tanh_approx(s * c3);
      x = c2 * th;
      dz = 1.f - th * th;
    } else {
      x = s * c1;
    }
    s = keep ? ex2(x - lse2) : 0.f;
    dp = s * (dp - d) * dz * scale;
  }
};

// ---- dQ (and D) ------------------------------------------------------------
// Accumulator fragment of wgmma m64nN (fp32): thread t of the warpgroup
// holds, for r in [0, N/2), the element at row 16 * (t / 32) + (t % 32) / 4
// + 8 * ((r / 2) % 2) and column 8 * (r / 4) + 2 * (t % 4) + r % 2.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             Params p) {
  using L = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_do = s_q + L::kQBytes;
  const uint32_t s_k = s_do + L::kQBytes;              // kStages K tiles
  const uint32_t s_v = s_k + kStages * L::kKVBytes;    // kStages V tiles
  const uint32_t bar = s_v + kStages * L::kKVBytes;    // mbarriers
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  // Reverse order: under causality the last query tiles do the most work.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kQM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int n_end = p.causal ? min(p.T, m0 + kQM) : p.T;
  const int n_begin =
      p.window > 0 ? max(0, m0 - p.window + 1) / kQN * kQN : 0;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + kQN - 1) / kQN : 0;

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
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      tma_tile<HD, kQM>(s_q, &tm_q, q_full, m0, h, b);
      tma_tile<HD, kQM>(s_do, &tm_do, q_full, m0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;
        const int n0 = n_begin + it * kQN;
        mbar_wait(k_empty(st), parity);
        mbar_expect_tx(k_full(st), L::kKVBytes);
        tma_tile<HD, kQN>(s_k + st * L::kKVBytes, &tm_k, k_full(st), n0, kvh,
                          b);
        mbar_wait(v_empty(st), parity);
        mbar_expect_tx(v_full(st), L::kKVBytes);
        tma_tile<HD, kQN>(s_v + st * L::kKVBytes, &tm_v, v_full(st), n0, kvh,
                          b);
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg owns query rows m0 + 64 wg .. + 63 ----
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_lo = m0 + 64 * wg;                      // warpgroup's rows
  const int row0 = row_lo + 16 * (t / 32) + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const long long bh = static_cast<long long>(b) * p.H + h;

  // D = rowsum(dO o O) of rows row0 and row0 + 8: the quad of lanes that
  // holds a row sums a quarter of its columns each
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float acc = 0.f;
    if (row < p.S) {
      const int c0 = (lane % 4) * (HD / 4);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(
          p.o + b * p.sob + h * p.soh + row * p.sos + c0);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(
          p.dout + b * p.sdb + h * p.sdh + row * p.sds + c0);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float2 of = __bfloat1622float2(o2[c]);
        const float2 df = __bfloat1622float2(d2[c]);
        acc = fmaf(of.x, df.x, acc);
        acc = fmaf(of.y, df.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dd[i] = acc;
    lse2[i] = row < p.S ? p.lse[bh * p.S + row] * kLog2e : CUDART_INF_F;
    if (lane % 4 == 0 && row < p.S) p.delta[bh * p.S + row] = acc;
  }

  const Grad grad(p);
  const uint32_t q_wg = s_q + 64 * wg * L::kSw;
  const uint32_t do_wg = s_do + 64 * wg * L::kSw;
  float dq[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) dq[r] = 0.f;
  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int n0 = n_begin + it * kQN;
    const uint32_t kt = s_k + st * L::kKVBytes;
    const uint32_t vt = s_v + st * L::kKVBytes;
    // S = Q K^T and dP = dO V^T: the first k-step overwrites, so the
    // accumulators carry nothing from the previous tile
    float s[kQN / 2], dp[kQN / 2];
    mbar_wait(k_full(st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, desc_kmajor<HD>(q_wg, kQM, kk),
               desc_kmajor<HD>(kt, kQN, kk), kk > 0);
    mbar_wait(v_full(st), ph);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, desc_kmajor<HD>(do_wg, kQM, kk),
               desc_kmajor<HD>(vt, kQN, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    if (lane == 0) mbar_arrive(v_empty(st));

    const bool edge = (p.causal && n0 + kQN - 1 > row_lo) ||
                      (p.window > 0 && row_lo + 63 - n0 >= p.window) ||
                      n0 + kQN > p.T;
#pragma unroll
    for (int r = 0; r < kQN / 2; ++r) {
      const int i = (r / 2) % 2;
      const int qp = row0 + 8 * i;
      const int kp = n0 + 8 * (r / 4) + col0 + r % 2;
      const bool keep = !edge || (kp < p.T && (!p.causal || kp <= qp) &&
                                  (p.window <= 0 || qp - kp < p.window));
      grad(s[r], dp[r], lse2[i], dd[i], keep);
    }
    uint32_t da[2][kQN / 16][4];
    to_a<kQN>(dp, da);

    // dQ += dS K, dS as bf16 hi + lo
    pin(dq);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk)
        wgmma_rs(dq, da[part][kk], desc_mnmajor<HD>(kt, kQN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);
    if (lane == 0) mbar_arrive(k_empty(st));
  }

  __nv_bfloat16* out = p.dq + b * p.sqgb + h * p.sqgh;
#pragma unroll
  for (int r = 0; r < HD / 2; r += 2) {
    const int row = row0 + 8 * ((r / 2) % 2);
    if (row < p.S) {
      const int col = 8 * (r / 4) + col0;
      *reinterpret_cast<__nv_bfloat162*>(out + row * p.sqgs + col) =
          __floats2bfloat162_rn(dq[r], dq[r + 1]);
    }
  }
}

// ---- dK, dV ----------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               Params p) {
  using L = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_k = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_v = s_k + L::kKBytes;
  const uint32_t s_q = s_v + L::kKBytes;                // kStages Q tiles
  const uint32_t s_do = s_q + kStages * L::kRowBytes;   // kStages dO tiles
  const uint32_t s_ld = s_do + kStages * L::kRowBytes;  // lse / D buffers
  const uint32_t bar = s_ld + 2 * 2 * 2 * kKM * 4;      // mbarriers
  const uint32_t kv_full = bar;
  auto q_full = [&](int s) { return bar + 8 * (1 + s); };
  auto q_empty = [&](int s) { return bar + 8 * (1 + kStages + s); };

  // In order: under causality the first key blocks do the most work.
  const int n0 = blockIdx.x * kKN;
  const int b = blockIdx.y / p.Kh;
  const int kvh = blockIdx.y % p.Kh;
  const int group = p.H / p.Kh;
  // the query rows that see a key of this block: from the block's first key
  // under causality, to its last key + window - 1 under a window
  const int m_begin = p.causal ? n0 / kKM * kKM : 0;
  const int m_end =
      p.window > 0 ? min(p.S, min(p.T, n0 + kKN) - 1 + p.window) : p.S;
  const int n_m = m_end > m_begin ? (m_end - m_begin + kKM - 1) / kKM : 0;
  const int n_it = group * n_m;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * L::kKBytes);
      tma_tile<HD, kKN>(s_k, &tm_k, kv_full, n0, kvh, b);
      tma_tile<HD, kKN>(s_v, &tm_v, kv_full, n0, kvh, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;
        const int hq = kvh * group + it / n_m;
        const int m0 = m_begin + (it % n_m) * kKM;
        mbar_wait(q_empty(st), parity);
        mbar_expect_tx(q_full(st), 2 * L::kRowBytes);
        tma_tile<HD, kKM>(s_q + st * L::kRowBytes, &tm_q, q_full(st), m0, hq,
                          b);
        tma_tile<HD, kKM>(s_do + st * L::kRowBytes, &tm_do, q_full(st), m0,
                          hq, b);
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg owns keys n0 + 64 wg .. + 63 ----
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int key_lo = n0 + 64 * wg;                     // warpgroup's keys
  const int key0 = key_lo + 16 * (t / 32) + lane / 4;  // and key0 + 8
  const int col0 = 2 * (lane % 4);
  // this warpgroup's two lse / D buffers: kKM lse * log2e, then kKM D
  float* const ld_base = reinterpret_cast<float*>(
      smem_raw + (s_ld - smem_addr(smem_raw))) + wg * 2 * 2 * kKM;

  const Grad grad(p);
  const uint32_t k_wg = s_k + 64 * wg * L::kSw;
  const uint32_t v_wg = s_v + 64 * wg * L::kSw;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) dk[r] = dv[r] = 0.f;
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int hq = kvh * group + it / n_m;
    const int m0 = m_begin + (it % n_m) * kKM;
    const uint32_t qt = s_q + st * L::kRowBytes;
    const uint32_t dot = s_do + st * L::kRowBytes;
    // this tile's lse (log2 units; +inf past S, so P = 0 there) or D, one
    // value a thread, read while the products run
    const int qrow = m0 + t % kKM;
    const long long at = (static_cast<long long>(b) * p.H + hq) * p.S + qrow;
    const float val =
        t < kKM ? (qrow < p.S ? p.lse[at] * kLog2e : CUDART_INF_F)
                : (qrow < p.S ? p.delta[at] : 0.f);

    // S^T = K Q^T, dP^T = V dO^T
    float s[kKM / 2], dp[kKM / 2];
    mbar_wait(q_full(st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, desc_kmajor<HD>(k_wg, kKN, kk),
               desc_kmajor<HD>(qt, kKM, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, desc_kmajor<HD>(v_wg, kKN, kk),
               desc_kmajor<HD>(dot, kKM, kk), kk > 0);
    wgmma_commit();
    // the buffer written here was last read two tiles ago, before every
    // thread of the warpgroup passed the previous tile's barrier
    float* const ld = ld_base + (it & 1) * 2 * kKM;
    ld[t] = val;
    warpgroup_sync(1 + wg);
    wgmma_wait<0>();
    pin(s);
    pin(dp);

    const bool edge = (p.causal && m0 < key_lo + 63) ||
                      (p.window > 0 && m0 + kKM - 1 - key_lo >= p.window);
#pragma unroll
    for (int r = 0; r < kKM / 2; ++r) {
      const int kp = key0 + 8 * ((r / 2) % 2);
      const int qc = 8 * (r / 4) + col0 + r % 2;
      const int qp = m0 + qc;
      const bool keep = !edge || ((!p.causal || kp <= qp) &&
                                  (p.window <= 0 || qp - kp < p.window));
      grad(s[r], dp[r], ld[qc], ld[kKM + qc], keep);
    }
    // dV += P^T dO, then dK += dS^T Q: P and dS as bf16 hi + lo, dO and Q
    // read MN-major through the transpose bit.  dS is split while the dV
    // products run, so that P's and dS's fp32 and split registers are not
    // all live at once.
    uint32_t pa[2][kKM / 16][4], da[2][kKM / 16][4];
    to_a<kKM>(s, pa);
    pin(dv);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < kKM / 16; ++kk)
        wgmma_rs(dv, pa[part][kk], desc_mnmajor<HD>(dot, kKM, kk));
    to_a<kKM>(dp, da);
    pin(dk);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < kKM / 16; ++kk)
        wgmma_rs(dk, da[part][kk], desc_mnmajor<HD>(qt, kKM, kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv);
    pin(dk);
    if (lane == 0) mbar_arrive(q_empty(st));
  }

  __nv_bfloat16* const ok = p.dk + b * p.skgb + kvh * p.skgh;
  __nv_bfloat16* const ov = p.dv + b * p.svgb + kvh * p.svgh;
#pragma unroll
  for (int r = 0; r < HD / 2; r += 2) {
    const int key = key0 + 8 * ((r / 2) % 2);
    if (key < p.T) {
      const int col = 8 * (r / 4) + col0;
      *reinterpret_cast<__nv_bfloat162*>(ok + key * p.skgs + col) =
          __floats2bfloat162_rn(dk[r], dk[r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ov + key * p.svgs + col) =
          __floats2bfloat162_rn(dv[r], dv[r + 1]);
    }
  }
}

// ---- host ------------------------------------------------------------------
// st: element strides (batch, position, head) of q, k, v, dout
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   const long long* st, const Params& p, cudaStream_t stream) {
  using L = Tiles<HD>;
  const void* dout = p.dout;
  CUtensorMap q128, do128, k64, v64, q64, do64, k128, v128;
  if (!encode<HD>(&q128, q, p.S, p.H, B, st[1], st[2], st[0], kQM) ||
      !encode<HD>(&do128, dout, p.S, p.H, B, st[10], st[11], st[9], kQM) ||
      !encode<HD>(&k64, k, p.T, p.Kh, B, st[4], st[5], st[3], kQN) ||
      !encode<HD>(&v64, v, p.T, p.Kh, B, st[7], st[8], st[6], kQN) ||
      !encode<HD>(&q64, q, p.S, p.H, B, st[1], st[2], st[0], kKM) ||
      !encode<HD>(&do64, dout, p.S, p.H, B, st[10], st[11], st[9], kKM) ||
      !encode<HD>(&k128, k, p.T, p.Kh, B, st[4], st[5], st[3], kKN) ||
      !encode<HD>(&v128, v, p.T, p.Kh, B, st[7], st[8], st[6], kKN))
    return cudaErrorInvalidValue;
  static bool dq_in[64] = {}, dkv_in[64] = {};
  cudaError_t e =
      opt_in_smem(flash_bwd_dq_sm90_kernel<HD>, L::kSmemDq, dq_in);
  if (e != cudaSuccess) return e;
  e = opt_in_smem(flash_bwd_dkdv_sm90_kernel<HD>, L::kSmemDkv, dkv_in);
  if (e != cudaSuccess) return e;
  // dQ first: it writes D, which the dK / dV kernel reads
  flash_bwd_dq_sm90_kernel<HD>
      <<<dim3((p.S + kQM - 1) / kQM, B * p.H), kThreads, L::kSmemDq,
         stream>>>(q128, do128, k64, v64, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_sm90_kernel<HD>
      <<<dim3((p.T + kKN - 1) / kKN, B * p.Kh), kThreads, L::kSmemDkv,
         stream>>>(q64, do64, k128, v128, p);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, dout, o, dq: (B,S,H,hd); k, v, dk, dv: (B,T,Kh,hd), with element
// strides per (batch, position, head) and unit stride on hd; lse, delta
// (fp32 scratch for D): (B, H, S) contiguous.  TMA reads q, k, v and dout:
// 16-byte aligned base pointers and strides that are multiples of 8
// elements (the wrapper checks); o, dq, dk, dv need even strides.  Launches
// two kernels on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported input or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int Kh, int hd, long long sqb,
    long long sqs, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sob, long long sos,
    long long soh, long long sdb, long long sds, long long sdh,
    long long sqgb, long long sqgs, long long sqgh, long long skgb,
    long long skgs, long long skgh, long long svgb, long long svgs,
    long long svgh, int causal, int window, float softcap, float q_scale,
    void* stream) {
  const long long even[12] = {sob,  sos,  soh,  sqgb, sqgs, sqgh,
                              skgb, skgs, skgh, svgb, svgs, svgh};
  for (long long e : even)
    if (e % 2) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  const long long st[12] = {sqb, sqs, sqh, skb, skt, skh,
                            svb, svt, svh, sdb, sds, sdh};
  const Params p{static_cast<const __nv_bfloat16*>(o),
                 static_cast<const __nv_bfloat16*>(dout),
                 static_cast<const float*>(lse),
                 static_cast<float*>(delta),
                 static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 S, T, H, Kh,
                 sob, sos, soh, sdb, sds, sdh,
                 sqgb, sqgs, sqgh, skgb, skgs, skgh, svgb, svgs, svgh,
                 causal, window, softcap, q_scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, B, st, p, s);
    case 32: return launch<32>(q, k, v, B, st, p, s);
    case 64: return launch<64>(q, k, v, B, st, p, s);
    case 128: return launch<128>(q, k, v, B, st, p, s);
    default: return cudaErrorInvalidValue;
  }
}
