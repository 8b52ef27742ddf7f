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
// Bound on the H100: operations (the backward does 2.5x the forward's
// FLOPs on the same bytes; the forward is ~830 FLOP a byte at qwen3's
// training shape).  The least work is five bf16 products a (query tile,
// key tile) pair: S, dP, dV, dK, dQ.  P and dS are fp32 values; each enters
// its products as bf16 hi + lo, two wgmma products (sm90::split_bf16), as
// the forward's P V does: one bf16 part would carry 8 bits of them.  So a
// pair costs 8 products: S^T and dP^T once, dV, dK and dQ twice (the
// kernel this one replaced computed S and dP twice, in a dQ kernel and a
// dK / dV kernel: 10).
//
// Three launches:
//  * prep: lse * log2e and D * scale (D = rowsum(dO o O), fp32) for every
//    query row, padded to whole 64-row tiles (lse +inf, D 0 past S, so P =
//    dS = 0 there), into scratch; zeroes the dQ tiles' counters and the
//    work counter.
//  * main, one pass: a work item is 128 keys of one (b, kv head), 64 a
//    consumer warpgroup, K and V loaded once by TMA.  It walks the query
//    tiles the masks leave, each for the group's H / Kh query heads in
//    turn, through a TMA ring of Q, dO (and, by bulk copy, the tile's lse
//    and D).  Per tile each consumer warpgroup computes S^T = K Q^T and
//    dP^T = V dO^T once (wgmma, both operands in shared memory), then P^T
//    and dS^T in registers (straight-line code: the mask and the softcap
//    are chosen once a tile); dS^T (hi, lo) goes to shared memory; dV +=
//    P^T dO takes P from registers (its fragments are the accumulator's)
//    and dK += dS^T Q takes dS^T from shared memory; then the dQ partial
//    over the warpgroup's 64 keys, dS K, in passes of at most 64 columns
//    (32 accumulator registers).  Warpgroup 0 stores its partial in a dQ
//    buffer, warpgroup 1 adds its own, and a writer thread adds the sum
//    into the tile's fp32 sum in scratch.  dK and dV stay in fp32
//    registers over the whole group and are written once.
//  * dq: each 64-row tile's fp32 sum to bf16 dq; zeros where no key block
//    added (a row that sees no key).
//
// Determinism: every dQ tile's fp32 sum in scratch takes its key blocks'
// partials in one fixed order, highest key block first (the first stores,
// each next adds; `flash_attention/ops.py` `bwd_schedule` lists it).  A
// counter per (b, h, query tile) counts the partials made; the writer
// whose turn it is waits for it (acquire), adds its partial by one bulk
// reduce from shared memory, and bumps it (release).  No float is summed
// in a varying order and no float atomic is used, so two calls are
// bit-identical.  Under causality key block n first reaches query tile 2n,
// so a higher block reaches every tile two tiles (2 * group tile steps)
// before a lower one that starts with it: that order is also the order of
// arrival.
//
// Progress does not rest on the order in which blocks are dispatched: the
// grid is persistent (at most one block an SM) and every block takes its
// next item from a counter, in the order highest key block first.  An item
// waits only on the partials of the item with the next higher key block of
// its (b, kv head), which comes earlier in that order, so a block that took
// it is running; by induction on the order no wait is circular.  The cost
// of that order is a tail under causality: the longest items (the lowest
// key blocks) come last.
//
// Warp roles (setmaxnreg 40 / 232; 40 + 2 * 232 a lane is what the launch
// allots): warpgroups 0 and 1 consume and run offset from each other, so
// that one's softmax-gradient arithmetic overlaps the other's products;
// warp 8 takes items and issues the loads (K, V once an item; Q, dO, lse,
// D a tile, 2 stages at hd 128 and 3 below); warps 9 and 10 each pass one
// of the two dQ buffers to the scratch sums, so that one's bulk add
// overlaps the other's wait for its turn.  Masks only on tiles that cross
// the diagonal, the window edge or T; keys past T are masked (their dK /
// dV rows are not written).
#include "sm90.cuh"

#include <math_constants.h>

namespace {

using namespace sm90;

constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2: warps 8-10
constexpr int kLoader = 256, kWriter = 288;  // and kWriter + 32
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKN = 128;  // keys a work item, 64 a consumer warpgroup
constexpr int kKM = 64;   // query rows a Q / dO tile

// Shared memory of one head dim, from a 1024-aligned base: K, V; the Q and
// dO stages; dS^T's bf16 hi and lo parts (128 keys x 64 rows, 128B swizzle);
// two fp32 dQ partials; the stages' lse and D; the item and the two dQ
// buffers' (tile, turn); the mbarriers.
template <int HD>
struct Cfg : Sw<HD> {
  static constexpr int kStages = HD == 128 ? 2 : 3;
  static constexpr int kDqCols = HD < 64 ? HD : 64;  // columns a dQ pass
  static constexpr uint32_t kKBytes = kKN * HD * 2;
  static constexpr uint32_t kRowBytes = kKM * HD * 2;
  static constexpr uint32_t kDsBytes = kKN * kKM * 2;
  static constexpr uint32_t kDqBytes = kKM * HD * 4;
  static constexpr uint32_t kLdBytes = 2 * kKM * 4;
  static constexpr uint32_t kOffV = kKBytes;
  static constexpr uint32_t kOffQ = 2 * kKBytes;
  static constexpr uint32_t kOffDo = kOffQ + kStages * kRowBytes;
  static constexpr uint32_t kOffDs = kOffDo + kStages * kRowBytes;
  static constexpr uint32_t kOffDq = kOffDs + 2 * kDsBytes;
  static constexpr uint32_t kOffLd = kOffDq + 2 * kDqBytes;
  static constexpr uint32_t kOffInfo = kOffLd + kStages * kLdBytes;
  static constexpr uint32_t kOffBar = kOffInfo + 32;
  static constexpr int kBars = 2 + 2 * kStages + 6;
  static constexpr int kSmem = 1024 + kOffBar + 8 * kBars;
};

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, S), natural log
  float* ld;         // (2, B, H, Sp): lse * log2e, then D * q_scale
  float* acc;        // (B, H, n_mt, 64 * hd): dQ tiles' fp32 sums
  int* counts;       // (B, H, n_mt) dQ partials made, then the work counter
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, S, T, H, Kh;
  int n_mt, nb;  // 64-row query tiles (Sp = 64 n_mt), 128-key blocks
  long long sob, sos, soh;     // o
  long long sdb, sds, sdh;     // dout
  long long sqgb, sqgs, sqgh;  // dq
  long long skgb, skgs, skgh;  // dk
  long long svgb, svgs, svgh;  // dv
  int causal;
  int window;     // <= 0: none; else keep q_pos - k_pos < window
  float softcap;  // <= 0: none
  float q_scale;
  // x = s * c1, or c2 * tanh(s * c3) under a softcap: the forward's score
  // in the log2 domain (set by the host, so that they stay constants)
  float c1, c2, c3;
};

// P and dS of one score from the forward's arithmetic, in the log2 domain
// as the forward computes it (so that P sums to 1 against its lse).  s:
// the raw score q . k; dp: dO . v; lse2: the row's lse * log2e; ds: the
// row's D * scale.  Writes P to s and dS to dp, with no branch.
template <bool kCap>
__device__ __forceinline__ void grad(const Params& p, float& s, float& dp,
                                     float lse2, float ds, bool keep) {
  float pr;
  if (kCap) {
    const float th = tanh_approx(s * p.c3);
    pr = ex2(fmaf(p.c2, th, -lse2));
    pr = keep ? pr : 0.f;
    dp = pr * fmaf(dp, p.q_scale, -ds) * (1.f - th * th);
  } else {
    pr = ex2(fmaf(s, p.c1, -lse2));
    pr = keep ? pr : 0.f;
    dp = pr * fmaf(dp, p.q_scale, -ds);
  }
  s = pr;
}

// P^T and dS^T of a warpgroup's tile in place of S^T and dP^T (fragments
// of m64n64: keys key0, key0 + 8; query columns q0 + 8 c + {0, 1}, q0 =
// m0 + col0).  `ld`: the shared address of the tile's 64 lse * log2e,
// then its 64 D * scale.
// kMask: the tile crosses the diagonal, the window edge or T.  Straight-line
// code, so that the loads, exps and products of the 32 elements interleave.
template <bool kCap, bool kMask>
__device__ __forceinline__ void tile_grads(float (&s)[kKM / 2],
                                           float (&dp)[kKM / 2],
                                           uint32_t ld, const Params& p,
                                           int key0,
                                           int q0, int col0) {
#pragma unroll
  for (int c = 0; c < kKM / 8; ++c) {
    const float2 l2 = lds_f2(ld + 4 * (8 * c + col0));
    const float2 d2 = lds_f2(ld + 4 * (kKM + 8 * c + col0));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool keep = true;
      if (kMask) {
        const int kp = key0 + 8 * (e / 2);
        const int qp = q0 + 8 * c + e % 2;
        keep = (kp < p.T) & (!p.causal | (kp <= qp)) &
               ((p.window <= 0) | (qp - kp < p.window));
      }
      grad<kCap>(p, s[4 * c + e], dp[4 * c + e], e % 2 ? l2.y : l2.x,
                 e % 2 ? d2.y : d2.x, keep);
    }
  }
}

// A work item: key block n of (b, kv head kvh): the query tiles [m_begin,
// m_begin + n_m) that see one of the block's keys, from its first key under
// causality to its last key + window - 1 under a window (`bwd_schedule` in
// flash_attention/ops.py computes the same), each for the group's query
// heads in turn.  Items go highest key block first, then by (b, kv head);
// so every item that adds into a dQ tile before this one comes earlier.  A
// lower key block's walk starts at the same tile as a higher one's or
// before, so it reaches each tile no sooner.
struct Item {
  int n, b, kvh, m_begin, n_m;
};

__device__ __forceinline__ Item item_of(const Params& p, int item) {
  const int bk = p.B * p.Kh;
  Item it;
  it.n = p.nb - 1 - item / bk;
  it.b = item % bk / p.Kh;
  it.kvh = item % p.Kh;
  it.m_begin = p.causal ? it.n * (kKN / kKM) : 0;
  const long long last = min(p.T, (it.n + 1) * kKN) - 1;
  long long end = p.S;
  if (p.window > 0) end = min(end, last + p.window);
  it.n_m = max(0, static_cast<int>((end + kKM - 1) / kKM) - it.m_begin);
  return it;
}

// The turn of key block n at query tile m: how many blocks add before it
// (the highest block that reaches m goes first).
__device__ __forceinline__ int turn(const Params& p, int m, int n) {
  return (p.causal ? min(p.nb - 1, m * kKM / kKN) : p.nb - 1) - n;
}

// ---- prep: lse * log2e, D * scale; counters --------------------------------
// Grid (n_mt, B * H), 128 threads: a lane group of min(32, HD / 2) lanes a
// row sums its bf16 pairs of dO o O, then the group's lanes.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_prep_sm90_kernel(Params p) {
  constexpr int kW = HD / 2, kL = kW < 32 ? kW : 32, kRows = 32 / kL;
  const int m = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long sp = static_cast<long long>(p.n_mt) * kKM;
  for (int r0 = warp * kRows; r0 < kKM; r0 += 4 * kRows) {
    const int row = m * kKM + r0 + lane / kL;
    float acc = 0.f;
    if (row < p.S) {
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(
          p.o + b * p.sob + h * p.soh + row * p.sos);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(
          p.dout + b * p.sdb + h * p.sdh + row * p.sds);
#pragma unroll
      for (int c = lane % kL; c < kW; c += kL) {
        const float2 of = __bfloat1622float2(o2[c]);
        const float2 df = __bfloat1622float2(d2[c]);
        acc = fmaf(of.x, df.x, acc);
        acc = fmaf(of.y, df.y, acc);
      }
    }
#pragma unroll
    for (int off = kL / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane % kL == 0) {
      const long long at = bh * sp + row;
      p.ld[at] = row < p.S
                     ? p.lse[static_cast<long long>(bh) * p.S + row] * kLog2e
                     : CUDART_INF_F;
      p.ld[p.B * p.H * sp + at] = row < p.S ? acc * p.q_scale : 0.f;
    }
  }
  // the tiles' counters and the work counter
  const long long n_counts = static_cast<long long>(p.B) * p.H * p.n_mt + 1;
  for (long long i = (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * 128 + threadIdx.x;
       i < n_counts; i += 128ll * gridDim.x * gridDim.y)
    p.counts[i] = 0;
}

// ---- main: S^T, dP^T once a pair; dK, dV; dQ partials ----------------------
// Accumulator fragment of wgmma m64nN (fp32): thread t of the warpgroup
// holds, for r in [0, N/2), the element at row 16 * (t / 32) + (t % 32) / 4
// + 8 * ((r / 2) % 2) and column 8 * (r / 4) + 2 * (t % 4) + r % 2.  A dQ
// partial (m64 n hd) lies in shared memory (and its sum in scratch) in that
// order: float2 (r, r + 1) at index (r / 2) * 128 + t, so that a warp's
// stores are 256 contiguous bytes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          Params p) {
  using L = Cfg<HD>;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = base, s_v = base + L::kOffV;
  auto s_q = [&](int st) { return base + L::kOffQ + st * L::kRowBytes; };
  auto s_do = [&](int st) { return base + L::kOffDo + st * L::kRowBytes; };
  const uint32_t s_ds = base + L::kOffDs;  // hi; lo kDsBytes on
  auto s_dq = [&](int i) { return base + L::kOffDq + i * L::kDqBytes; };
  auto s_ld = [&](int st) { return base + L::kOffLd + st * L::kLdBytes; };
  // [0]: the item (none left past the last); [4 + 2 i], [5 + 2 i]: dQ
  // buffer i's tile (-1: stop) and turn
  auto info = [&](int i) { return base + L::kOffInfo + 4 * i; };
  const uint32_t bar = base + L::kOffBar;
  const uint32_t kv_full = bar, kv_empty = bar + 8;
  auto q_full = [&](int s) { return bar + 8 * (2 + s); };
  auto q_empty = [&](int s) { return bar + 8 * (2 + kS + s); };
  auto dq_full = [&](int i) { return bar + 8 * (2 + 2 * kS + i); };
  auto dq_empty = [&](int i) { return bar + 8 * (4 + 2 * kS + i); };
  auto dq_half = [&](int i) { return bar + 8 * (6 + 2 * kS + i); };

  const int group = p.H / p.Kh;
  const long long sp = static_cast<long long>(p.n_mt) * kKM;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < kS; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(dq_full(i), 128);  // warpgroup 1's threads
      mbar_init(dq_half(i), 128);  // warpgroup 0's
      mbar_init(dq_empty(i), 1);   // its writer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == kLoader) {
      // ---- loads: items from the work counter, in `item_of`'s order ----
      int* const work = p.counts + static_cast<long long>(p.B) * p.H * p.n_mt;
      const int n_items = p.nb * p.B * p.Kh;
      int it_s = 0;
      for (int j = 0;; ++j) {
        const int item = atomicAdd(work, 1);
        if (j > 0) mbar_wait(kv_empty, (j - 1) & 1);
        sts_volatile(info(0), item);
        if (item >= n_items) {
          mbar_arrive(kv_full);
          break;
        }
        const Item it = item_of(p, item);
        mbar_expect_tx(kv_full, 2 * L::kKBytes);
        tma_tile<HD, kKN>(s_k, &tm_k, kv_full, it.n * kKN, it.kvh, it.b);
        tma_tile<HD, kKN>(s_v, &tm_v, kv_full, it.n * kKN, it.kvh, it.b);
        int m = it.m_begin, hq = it.kvh * group;
        for (int i = 0; i < it.n_m * group; ++i, ++it_s) {
          const int st = it_s % kS;
          const float* src =
              p.ld + (static_cast<long long>(it.b) * p.H + hq) * sp +
              m * kKM;
          mbar_wait(q_empty(st), ((it_s / kS) & 1) ^ 1);
          mbar_expect_tx(q_full(st), 2 * L::kRowBytes + L::kLdBytes);
          tma_tile<HD, kKM>(s_q(st), &tm_q, q_full(st), m * kKM, hq, it.b);
          tma_tile<HD, kKM>(s_do(st), &tm_do, q_full(st), m * kKM, hq,
                            it.b);
          bulk_load(s_ld(st), src, kKM * 4, q_full(st));
          bulk_load(s_ld(st) + kKM * 4, src + p.B * p.H * sp, kKM * 4,
                    q_full(st));
          if (++hq == (it.kvh + 1) * group) {
            hq = it.kvh * group;
            ++m;
          }
        }
      }
    } else if (threadIdx.x == kWriter || threadIdx.x == kWriter + 32) {
      // ---- dQ partials into the tiles' sums, each in its turn: one
      // writer a dQ buffer, so that one's bulk add overlaps the other's
      // wait for its turn ----
      const int buf = (threadIdx.x - kWriter) / 32;
      for (int j = 0;; ++j) {
        mbar_wait(dq_full(buf), j & 1);
        const int tile = lds_volatile(info(4 + 2 * buf));
        const int rank = lds_volatile(info(5 + 2 * buf));
        if (tile < 0) break;
        int* const flag = p.counts + tile;
        wait_flag(flag, rank);
        fence_async_global();
        float* const dst = p.acc + static_cast<long long>(tile) * kKM * HD;
        if (rank == 0)
          bulk_store(dst, s_dq(buf), L::kDqBytes);
        else
          bulk_add_f32(dst, s_dq(buf), L::kDqBytes);
        bulk_commit();
        bulk_wait_read();  // the buffer is read: the consumers may refill it
        mbar_arrive(dq_empty(buf));
        bulk_wait_all();
        fence_async_global();
        bump_flag(flag);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys n * 128 + 64 wg .. + 63 ----------
  setmaxnreg_inc<232>();
  const int t = threadIdx.x % 128;
  const int lane = t % 32, warp = t / 32;
  const int col0 = 2 * (lane % 4);
  const bool capped = p.softcap > 0.f;
  float dk[HD / 2], dv[HD / 2];
  int it_s = 0;  // the consumers' tiles: stage and dQ buffer counter
  for (int j = 0;; ++j) {
    mbar_wait(kv_full, j & 1);
    const int item = lds_volatile(info(0));
    if (item >= p.nb * p.B * p.Kh) break;
    // the tile loop keeps the item, its key block and its walk live, and
    // derives the rest anew each tile from values the compiler cannot
    // hoist: registers are scarce at hd 128 (dK, dV take 128 a thread)
    const Item it = item_of(p, item);
    const int n = it.n;
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) dk[r] = dv[r] = 0.f;

    int m = it.m_begin, g = 0;
    for (const int it_end = it_s + it.n_m * group; it_s < it_end; ++it_s) {
      const int st = it_s % kS;
      const int m0 = m * kKM;
      const uint32_t qt = s_q(st), dot = s_do(st);
      const uint32_t ld = s_ld(st);
      // this warpgroup's rows of K, V and dS^T and its keys, from its
      // index read anew, so that the compiler builds the wgmma descriptors
      // here and keeps none of them live across the loop
      int wg_now;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(wg_now) : "r"(wg));
      const uint32_t k_wg = s_k + 64 * wg_now * L::kSw;
      const uint32_t v_wg = s_v + 64 * wg_now * L::kSw;
      const uint32_t ds_wg = s_ds + 64 * wg_now * 128;
      const int key_lo = n * kKN + 64 * wg_now;
      const int key0 = key_lo + 16 * warp + lane / 4;  // and key0 + 8

      // S^T = K Q^T, dP^T = V dO^T: the first k-step overwrites
      float s[kKM / 2], dp[kKM / 2];
      mbar_wait(q_full(st), (it_s / kS) & 1);
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
      wgmma_wait<0>();
      pin(s);
      pin(dp);

      const bool edge = (p.causal && m0 < key_lo + 63) ||
                        (p.window > 0 && m0 + kKM - 1 - key_lo >= p.window) ||
                        key_lo + 63 >= p.T;
      if (capped) {
        if (edge)
          tile_grads<true, true>(s, dp, ld, p, key0, m0 + col0, col0);
        else
          tile_grads<true, false>(s, dp, ld, p, key0, m0 + col0, col0);
      } else {
        if (edge)
          tile_grads<false, true>(s, dp, ld, p, key0, m0 + col0, col0);
        else
          tile_grads<false, false>(s, dp, ld, p, key0, m0 + col0,
                                   col0);
      }
      uint32_t pa[2][kKM / 16][4], da[2][kKM / 16][4];
      to_a<kKM>(s, pa);
      to_a<kKM>(dp, da);
      // dS^T (hi, lo) to this warpgroup's 64 rows, 128B-swizzled (the dQ
      // products of its previous tile, which read them, are done).  The
      // row's swizzle is read anew each tile, so that the compiler keeps no
      // 32 hoisted addresses live across the loop.
      int swz;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(swz) : "r"(lane / 4));
      const uint32_t ds_row =
          s_ds + (64 * wg + 16 * warp + lane / 4) * 128 + col0 * 2;
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kKM / 16; ++kk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sts_u32(ds_row + part * L::kDsBytes + 8 * 128 * (jj % 2) +
                        (((2 * kk + jj / 2) ^ swz) << 4),
                    da[part][kk][jj]);
      fence_async_shared();
      warpgroup_sync(1 + wg);

      // dV += P^T dO (P from registers, dO MN-major); dK += dS^T Q (dS^T
      // K-major, Q MN-major)
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kKM / 16; ++kk)
          wgmma_rs(dv, pa[part][kk], desc_mnmajor<HD>(dot, kKM, kk));
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kKM / 16; ++kk)
          wgmma_ss_bt<0>(dk, desc_kmajor<64>(ds_wg + part * L::kDsBytes,
                                             kKN, kk),
                         desc_mnmajor<HD>(qt, kKM, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      if (lane == 0) mbar_arrive(q_empty(st));

      // the dQ partial over this warpgroup's keys, dS K (dS^T and K both
      // MN-major), in passes of at most 64 columns (32 accumulator
      // registers) to dQ buffer it_s % 2: warpgroup 0 stores its partial,
      // warpgroup 1 adds its own (in that order) and hands the sum to the
      // writer.  A pass's columns are those of the whole m64 x hd partial's
      // fragment, so it lies in the buffer as one m64n(hd) accumulator.
      const int buf = it_s & 1;
      const uint32_t out = s_dq(buf) + 8 * t;  // float2 (r / 2) * 128 + t
      if (wg == 0)
        mbar_wait(dq_empty(buf), ((it_s >> 1) & 1) ^ 1);
#pragma unroll
      for (int pass = 0; pass < HD / L::kDqCols; ++pass) {
        float dq[L::kDqCols / 2];
        wgmma_fence();
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int kk = 0; kk < 64 / 16; ++kk)
            wgmma_ss_bt<1>(
                dq, desc_mnmajor<64>(ds_wg + part * L::kDsBytes, kKN, kk),
                desc_mnmajor<HD>(k_wg + pass * kKN * L::kSw, kKN, kk),
                part > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        const uint32_t at = out + pass * (L::kDqCols / 4) * 1024;
        if (wg == 0) {
#pragma unroll
          for (int r = 0; r < L::kDqCols / 2; r += 2)
            sts_f2(at + (r / 2) * 1024, make_float2(dq[r], dq[r + 1]));
        } else {
          if (pass == 0) mbar_wait(dq_half(buf), (it_s >> 1) & 1);
#pragma unroll
          for (int r = 0; r < L::kDqCols / 2; r += 2) {
            float2 v = lds_f2(at + (r / 2) * 1024);
            v.x += dq[r];
            v.y += dq[r + 1];
            sts_f2(at + (r / 2) * 1024, v);
          }
        }
      }
      if (wg == 0) {
        mbar_arrive(dq_half(buf));
      } else {
        if (t == 0) {
          // query head (b, kvh * group + g): b * H + kvh * group + g
          const int bh = item % (p.B * p.Kh) * group + g;
          sts_volatile(info(4 + 2 * buf), bh * p.n_mt + m);
          sts_volatile(info(5 + 2 * buf), turn(p, m, n));
        }
        fence_async_shared();
        mbar_arrive(dq_full(buf));
      }
      if (++g == group) {
        g = 0;
        ++m;
      }
    }
    // the item's products are done: K and V are free
    if (lane == 0) mbar_arrive(kv_empty);
    // dK and dV of the group, bf16 (the item's values read anew)
    int again;
    asm volatile("mov.b32 %0, %1;\n" : "=r"(again) : "r"(item));
    const Item done = item_of(p, again);
    const int key0 = done.n * kKN + 64 * wg + 16 * warp + lane / 4;
    __nv_bfloat16* const ok = p.dk + done.b * p.skgb + done.kvh * p.skgh;
    __nv_bfloat16* const ov = p.dv + done.b * p.svgb + done.kvh * p.svgh;
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
  // no items left: each writer stops at a tile of -1
  for (int k = it_s; k < it_s + 2; ++k) {
    const int buf = k & 1;
    if (wg == 0) {
      mbar_wait(dq_empty(buf), ((k >> 1) & 1) ^ 1);
      mbar_arrive(dq_half(buf));
    } else {
      mbar_wait(dq_half(buf), (k >> 1) & 1);
      if (t == 0) sts_volatile(info(4 + 2 * buf), -1);
      mbar_arrive(dq_full(buf));
    }
  }
}

// ---- dq: the tiles' fp32 sums to bf16 ---------------------------------------
// Grid (n_mt, B * H), 128 threads: thread t converts the elements it held
// as a fragment (the main kernel's order).
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_sm90_kernel(Params p) {
  const int m = blockIdx.x, bh = blockIdx.y, t = threadIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const long long tile = static_cast<long long>(bh) * p.n_mt + m;
  const bool added = p.counts[tile] > 0;
  const float2* const src =
      reinterpret_cast<const float2*>(p.acc + tile * kKM * HD);
  __nv_bfloat16* const out = p.dq + b * p.sqgb + h * p.sqgh;
#pragma unroll
  for (int q = 0; q < HD / 4; ++q) {
    const int row = m * kKM + 16 * (t / 32) + (t % 32) / 4 + 8 * (q % 2);
    const int col = 8 * (q / 2) + 2 * (t % 4);
    const float2 v = added ? src[q * 128 + t] : make_float2(0.f, 0.f);
    if (row < p.S)
      *reinterpret_cast<__nv_bfloat162*>(out + row * p.sqgs + col) =
          __floats2bfloat162_rn(v.x, v.y);
  }
}

// ---- host ------------------------------------------------------------------
// st: element strides (batch, position, head) of q, k, v, dout
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* st, const Params& p,
                   cudaStream_t stream) {
  using L = Cfg<HD>;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode<HD>(&tq, q, p.S, p.H, p.B, st[1], st[2], st[0], kKM) ||
      !encode<HD>(&tdo, p.dout, p.S, p.H, p.B, st[10], st[11], st[9], kKM) ||
      !encode<HD>(&tk, k, p.T, p.Kh, p.B, st[4], st[5], st[3], kKN) ||
      !encode<HD>(&tv, v, p.T, p.Kh, p.B, st[7], st[8], st[6], kKN))
    return cudaErrorInvalidValue;
  static bool opted[64] = {};
  cudaError_t e = opt_in_smem(flash_bwd_sm90_kernel<HD>, L::kSmem, opted);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const dim3 tiles(p.n_mt, p.B * p.H);
  flash_bwd_prep_sm90_kernel<HD><<<tiles, 128, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_sm90_kernel<HD>
      <<<min(sms, p.nb * p.B * p.Kh), kThreads, L::kSmem, stream>>>(
          tq, tdo, tk, tv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_sm90_kernel<HD><<<tiles, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the main kernel a block at head dim `hd`, in
// bytes (0 for an unsupported hd).
extern "C" int flash_attention_bwd_sm90_smem(int hd) {
  switch (hd) {
    case 16: return Cfg<16>::kSmem;
    case 32: return Cfg<32>::kSmem;
    case 64: return Cfg<64>::kSmem;
    case 128: return Cfg<128>::kSmem;
    default: return 0;
  }
}

// bf16 q, dout, o, dq: (B,S,H,hd); k, v, dk, dv: (B,T,Kh,hd), with element
// strides per (batch, position, head) and unit stride on hd; lse: (B, H, S)
// fp32 contiguous.  `scratch`, 16-byte aligned, holds (2, B, H, Sp) fp32
// lse * log2e and D * q_scale, (B, H, n_mt, 64 hd) fp32 dQ sums, (nb, B,
// H, 256 hd) fp32 dK / dV partials, then int counters: (B, H, n_mt), (nb, B,
// Kh, 2) and the work counter (n_mt = ceil(S / 64), Sp = 64 n_mt, nb =
// ceil(T / 128); `_bwd_scratch` in flash_attention/ops.py allocates it).  TMA reads
// q, k, v and dout: 16-byte aligned base pointers and strides that are
// multiples of 8 elements (the wrapper checks); o, dq, dk, dv need even
// strides.  Launches three kernels on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported input or a
// tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
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
      static_cast<long long>(B) * H > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  const int n_mt = (S + kKM - 1) / kKM, nb = (T + kKN - 1) / kKN;
  const long long sp = static_cast<long long>(n_mt) * kKM;
  const long long rows = static_cast<long long>(B) * H * sp;
  if (static_cast<long long>(nb) * B * Kh > (1ll << 30) ||
      rows * hd > (1ll << 40))
    return cudaErrorInvalidValue;
  float* const ld = static_cast<float*>(scratch);
  float* const acc = ld + 2 * rows;
  int* const counts = reinterpret_cast<int*>(acc + rows * hd);
  const long long st[12] = {sqb, sqs, sqh, skb, skt, skh,
                            svb, svt, svh, sdb, sds, sdh};
  const Params p{static_cast<const __nv_bfloat16*>(o),
                 static_cast<const __nv_bfloat16*>(dout),
                 static_cast<const float*>(lse),
                 ld, acc, counts,
                 static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 B, S, T, H, Kh, n_mt, nb,
                 sob, sos, soh, sdb, sds, sdh,
                 sqgb, sqgs, sqgh, skgb, skgs, skgh, svgb, svgs, svgh,
                 causal, window, softcap, q_scale,
                 q_scale * kLog2e, softcap * kLog2e,
                 softcap > 0.f ? q_scale / softcap : 0.f};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, st, p, s);
    case 32: return launch<32>(q, k, v, st, p, s);
    case 64: return launch<64>(q, k, v, st, p, s);
    case 128: return launch<128>(q, k, v, st, p, s);
    default: return cudaErrorInvalidValue;
  }
}
