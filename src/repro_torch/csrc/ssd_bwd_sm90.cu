// Mamba-2 SSD backward, the bf16 chunk gradients on Hopper's tensor cores
// (sm_90a: wgmma, TMA and bulk copies on an mbarrier).
//
// Replaces, for bf16 inputs, the chunk-gradient part of the reference's
// backward src/repro/kernels/ssd/ops.py:57 `_vjp_bwd` (the VJP of its chunk
// loop): dx, ddt, dA, dB, dC and dD, given the state entering each chunk
// (S_in, the forward's) and the gradient of the state leaving it (dS_out,
// the backward's reverse scan in ssd_sm90.cu).  Per chunk and head, with
// L[t,s] = exp(cum_t - cum_s) on s <= t, CB = C B^T, M = CB o L, dM[t,s] =
// (dy_t . x_s) dt_s, dCB = dM o L, w_s = exp(cum_last - cum_s):
//   dxd_s = sum_t M[t,s] dy_t + w_s dS_out B_s   dx_s = dt_s dxd_s + D dy_s
//   dB_s  = sum_t dCB[t,s] C_t + w_s dt_s x_s dS_out
//   dC_t  = sum_s dCB[t,s] B_s + exp(cum_t) dy_t S_in
//   dcum_t = sum_s (dM o M)[t,s] - sum_t' (dM o M)[t',t] + dy_t . y_inter_t
//            - w_t dt_t x_t . (dS_out B_t), and at the chunk's end
//            + sum_s w_s dt_s x_s . (dS_out B_s) + exp(cum_last) <S_in, dS_out>
//   da = the reverse cumsum of dcum, ddt = A da + x . dxd, dA = sum dt da.
//
// One launch, ssd_grad_sm90_kernel, between the reverse scan and the group
// sums (ssd_sm90.cu), one block per (b, chunk, hb heads of one group of B
// and C; hb = `bwd_heads`, 16 or the largest power of two below that
// divides H / G).  The block loads the chunk's B and C once, then walks its
// heads: each head's x and dy (TMA, 64-row boxes; cp.async where P or the
// strides allow no box) and S_in and dS_out (two bulk copies) land on one
// mbarrier while the previous head is computed (x and dy in two buffers,
// the states in a staging area that becomes bf16 hi + lo tiles between
// heads).  Warpgroup
// w owns the 64 rows s of block w (s-major, as the flash backward's
// key-major pass) and takes the lower triangle's (s-block, t-block) tiles
// of its rows once a head: x dy^T and C B^T in one wgmma stage (C B^T is
// made again each head: its 48 KB of shared memory hold the dCB sums
// below), then, in straight-line code with one exp an element and the mask
// chosen once a tile, M^T, dCB^T and the row and column sums of dM o M.
// M^T is the A operand of dx_s += M^T dy from registers (the accumulator
// layout is the A layout), so dx stays in its owner's accumulators.
//
// dB and dC depend on the head only through dCB, since B and C are the
// group's: sum_h dCB_h^T C = (sum_h dCB_h)^T C.  So the block adds each
// head's dCB^T into an fp32 sum in shared memory (each thread its own
// fragment, in head order) and makes dB = (sum dCB^T) C and dC = (sum dCB)
// B once, at its end: dCB never goes through a product a head, and never
// through a transposed copy but once.  The S_in and dS_out terms of dB and
// dC (per head: w_s dt_s x_s dS_out, exp(cum_t) dy_t S_in) are summed over
// the heads in the accumulators.  dB and dC leave as (B, T, H / hb, N)
// fp32 partials, where the kernel this one replaced wrote (B, T, H, N).
// Warpgroup 1 finishes each head's chunk while the next head is computed:
// dcum, its reverse cumsum da, ddt = A da + x . dxd, and the chunk's dA
// and dD partials.
//
// Products: bf16 wgmma m64n64k16 with fp32 sums.  x, dy, B and C are bf16
// values; every fp32 operand (M, dCB, S_in, dS_out) enters as a bf16 hi
// part and a lo part, two products, so each keeps ~16 bits (one part keeps
// 8; `bf16_parts` = 1 is that planted fault: the lo parts of M and of the
// dCB sum set to 0).  A head costs 24 m64n64k64 products: x dy^T and C B^T
// 6 (3 tiles); M^T dy 6 (hi + lo); S_in / dS_out terms 12; the block's end
// adds dB and dC's 12.
// Any P of 16 / 32 / 64 and N <= 64 (padded in shared memory with zeros to
// 64), a chunk <= 128 (one or two 64-row blocks; rows past T are zeros).
// No float atomics: every sum has one order, so two calls are
// bit-identical.
//
// Bound on the H100 at zamba2-1.2b (B 4, T 2048, H 64, P 64, N 64, chunk
// 128): bytes.  The backward must read x, dy, B, C, dt and write dx, dB,
// dC, ddt (~0.21 GB with the states the scans pass, 0.0626 ms); this
// kernel also reads S_in and dS_out (67 MB each, fp32) and writes the
// partials (8.4 MB each at hb 16, were 134 MB).  Its products, 4,096 (b,
// chunk, head) x 24 x 0.52 MFLOP = 52 GFLOP, take 0.053 ms at 989
// TFLOP/s; one block an SM (225 KB of shared memory) with two warpgroups
// keeps a wgmma in flight while the other warpgroup does its elementwise
// work.  On the H100 (700 W) it reads ~0.27 ms at this shape, ~5x its
// products' time: the elementwise work (an exp, the sums of dM o M and the
// hi / lo splits a tile element), the states' conversion between heads and
// the S_in / dS_out stages take most of a head's ~15,600 cycles, with two
// warpgroups an SM to hide their latency (tools/ssd_readings.py).
#include "common.cuh"
#include "sm90.cuh"
#include "ssd.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;
using repro::to_f32;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kMaxHeads = 16;
constexpr float kLog2e = 1.4426950408889634f;
// Shared memory from a 1024-aligned base.  bf16 tiles have 64 columns in
// 128-byte rows, 128B-swizzled (sw()): B, C (128 rows); x, dy (128 rows,
// two buffers each); S_in hi, lo, dS_out hi, lo ([p][n], 64 rows); then
// the next head's S_in and dS_out as they are in memory (fp32); the heads'
// sum of dCB^T, three fp32 64 x 64 tiles in fragment order; dt (four
// heads' ring) and cum; the per-position sums of two heads; per-head
// scalars.
constexpr uint32_t kTile = 128 * 128;
constexpr uint32_t kHalf = 64 * 128;
constexpr uint32_t kStateBytes = 64 * 64 * 4;  // a (P, N) fp32 state at most
constexpr uint32_t kOffB = 0;
constexpr uint32_t kOffC = kTile;
constexpr uint32_t kOffX = 2 * kTile;
constexpr uint32_t kOffDy = 4 * kTile;
constexpr uint32_t kOffS = 6 * kTile;
constexpr uint32_t kOffStage = kOffS + 4 * kHalf;
constexpr uint32_t kOffSdcb = kOffStage + 2 * kStateBytes;
constexpr uint32_t kOffDt = kOffSdcb + 3 * kStateBytes;  // [4][128]
constexpr uint32_t kOffCum = kOffDt + 4 * 128 * 4;
constexpr uint32_t kScrFloats = 12 * 128;  // cq [8][128]; rq, yi, rr, xdx
constexpr uint32_t kOffScr = kOffCum + 128 * 4;
constexpr uint32_t kOffSum = kOffScr + 2 * kScrFloats * 4;
// [head][warp][3]; cl, A, D [head]; red [8]; the loads' mbarrier
constexpr uint32_t kOffBar = kOffSum + (kMaxHeads * (8 * 3 + 3) + 8) * 4;
constexpr uint32_t kSmemUsed = kOffBar + 8;
constexpr int kSmem = 1024 + kSmemUsed;

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int dtype) {
  return dtype == repro::kBF16 ? to_f32(static_cast<const bf16*>(p)[i])
                               : static_cast<const float*>(p)[i];
}

// byte offset of bf16 element (r, col) in a 128B-swizzled tile of 128-byte
// rows: 16-byte chunk col / 8 of row r at chunk (col / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t sw(int r, int col) {
  return r * 128 + ((((col >> 3) ^ r) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void sts_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
// two bf16 at `addr` as floats
__device__ __forceinline__ float2 lds_bf2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
// Pins A fragments until this point (as sm90::pin does accumulators): the
// compiler may not reuse their registers while a wgmma reads them.
__device__ __forceinline__ void pin_a(uint32_t (&a)[2][4][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[p][k][j])::"memory");
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [0, Lp) of a bf16 (rows x W) slice at `src`, row stride `st`, into
// the tile at `dst`, zero past `rows` and past W to 64 columns: 16-byte
// cp.async where the rows are 16-byte vectors, else element by element.
__device__ void load_rows(uint32_t dst, const bf16* src, long long st,
                          int rows, int Lp, int W) {
  if (W % 8 == 0 && st % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = threadIdx.x; i < Lp * 8; i += kThreads) {
      const int r = i >> 3, ch = i & 7;
      const bool ok = r < rows && ch * 8 < W;
      cp_async16(dst + r * 128 + (((ch ^ r) & 7) << 4),
                 ok ? src + r * st + ch * 8 : src, ok ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < Lp * 64; i += kThreads) {
    const int r = i >> 6, col = i & 63;
    const bf16 v = r < rows && col < W ? src[r * st + col] : __float2bfloat16(0.f);
    sts_u16(dst + sw(r, col), __bfloat16_as_ushort(v));
  }
}

// S_in and dS_out, fp32 (P, N) row-major at st (S_in, then dS_out at
// kStateBytes), into bf16 hi and lo tiles [p][n] at dst (S hi, S lo, dS
// hi, dS lo), zero past P and N: this thread's pairs (p, n), (p, n + 1)
// with p = j / 32, n = 2 (j % 32), j = threadIdx.x + 256 k.  Returns its
// share of <S_in, dS_out>.
__device__ __forceinline__ float convert_states(uint32_t dst,
                                                const float* st, int P,
                                                int N) {
  float sds = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = threadIdx.x + kThreads * k, p = j >> 5, n = 2 * (j & 31);
    float2 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* src = st + u * (kStateBytes / 4) + p * N + n;
      v[u] = make_float2(0.f, 0.f);
      if (p < P && n < N) {
        if ((N & 1) == 0) {
          v[u] = *reinterpret_cast<const float2*>(src);
        } else {
          v[u].x = src[0];
          if (n + 1 < N) v[u].y = src[1];
        }
      }
    }
    sds = fmaf(v[0].x, v[1].x, fmaf(v[0].y, v[1].y, sds));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t hi, lo;
      split_bf16(v[u].x, v[u].y, hi, lo);
      sts_u32(dst + 2 * u * kHalf + sw(p, n), hi);
      sts_u32(dst + (2 * u + 1) * kHalf + sw(p, n), lo);
    }
  }
  return sds;
}

// inclusive cumsum of dts[r] * A over r < Lp, by one warp
__device__ void chunk_cumsum(const float* dts, float A, float* cum, int Lp) {
  const int lane = threadIdx.x & 31;
  const int E = (Lp + 31) / 32, lo = lane * E, hi = min(lo + E, Lp);
  float run = 0.f;
  for (int r = lo; r < hi; ++r) run += dts[r] * A;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float acc = incl - run;
  for (int r = lo; r < hi; ++r) {
    acc += dts[r] * A;
    cum[r] = acc;
  }
}

// ---- products (one warpgroup; m64n64, K = 64 in four k-steps) -------------
// acc (+)= A B^T, both K-major 64-row tiles
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint32_t ta,
                                       uint32_t tb, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(acc, desc_kmajor<64>(ta, 64, kk), desc_kmajor<64>(tb, 64, kk),
             accumulate || kk > 0);
}
// acc (+)= A B, A K-major (TA 0) or MN-major (TA 1), B MN-major ([k][n])
template <int TA>
__device__ __forceinline__ void mma_ss_bt(float (&acc)[32], uint32_t ta,
                                          uint32_t tb, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_bt<TA>(acc,
                    TA ? desc_mnmajor<64>(ta, 64, kk)
                       : desc_kmajor<64>(ta, 64, kk),
                    desc_mnmajor<64>(tb, 64, kk), accumulate || kk > 0);
}
// acc += A B, A the hi and lo fragments in registers, B MN-major
__device__ __forceinline__ void mma_rs(float (&acc)[32],
                                       const uint32_t (&a)[2][4][4],
                                       uint32_t tb) {
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[part][kk], desc_mnmajor<64>(tb, 64, kk));
}

// Accumulator fragment of m64n64 (fp32, 32 registers): thread tw of the
// warpgroup holds element r at row 16 (tw / 32) + (tw % 32) / 4 + 8 i,
// column 8 c + 2 (tw % 4) + j, with r = 4 c + 2 i + j.

// One (s-block, t-block) tile: in, m = C B^T and dm = x dy^T (rows s0 +
// row, columns t0 + col); out, m = M^T and dm = dCB^T.  Adds the row sums
// of dM o M to rq (rows i = 0, 1), the column sums to cq (16 columns c, j:
// 2 c + j), the diagonal of x dy^T to dd.  kDiag: s0 == t0, masked on t <
// s; chosen once a tile, straight-line code.
template <bool kDiag>
__device__ __forceinline__ void tile_grads(float (&m)[32], float (&dm)[32],
                                           const float* cum, const float* dtv,
                                           int s0, int t0, float (&rq)[2],
                                           float (&cq)[16], float& dd) {
  const int tw = threadIdx.x & 127, lane = tw & 31, q = lane & 3;
  const int ra = 16 * (tw >> 5) + (lane >> 2);
  const float cs[2] = {cum[s0 + ra], cum[s0 + ra + 8]};
  const float ds[2] = {dtv[s0 + ra], dtv[s0 + ra + 8]};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 ct = *reinterpret_cast<const float2*>(cum + t0 + 8 * c + 2 * q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * c + e, i = e >> 1, j = e & 1;
      float L = ex2(((j ? ct.y : ct.x) - cs[i]) * kLog2e);
      if (kDiag) {
        const int row = ra + 8 * i, col = 8 * c + 2 * q + j;
        L = col >= row ? L : 0.f;
        dd += col == row ? dm[r] : 0.f;
      }
      const float mm = m[r] * L, dmm = dm[r] * ds[i], qq = dmm * mm;
      rq[i] += qq;
      cq[2 * c + j] += qq;
      m[r] = mm;
      dm[r] = dmm * L;
    }
  }
}

// The column sums cq over the warp's 16 rows (the 8 lanes of a column),
// halving the values each step; lane (g, q) ends with columns 8 g + 2 q + {0,
// 1} and stores them at dst.
template <int W>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool hi = lane & (2 * W);  // lane bit 4, 3 or 2
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = hi ? v[k] : v[k + W], keep = hi ? v[k + W] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * W);
  }
}
__device__ __forceinline__ void col_sums(float (&v)[16], float* dst) {
  const int lane = threadIdx.x & 31;
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  *reinterpret_cast<float2*>(dst + 8 * (lane >> 2) + 2 * (lane & 3)) =
      make_float2(v[0], v[1]);
}

// dCB^T (hi, lo fragments) to a [s][t] tile pair at buf (hi, then lo)
__device__ __forceinline__ void store_dcb(uint32_t buf,
                                          const uint32_t (&da)[2][4][4]) {
  const int tw = threadIdx.x & 127, lane = tw & 31, g = lane >> 2;
  const uint32_t row = buf + (16 * (tw >> 5) + g) * 128 + 4 * (lane & 3);
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        sts_u32(row + part * kHalf + 8 * 128 * (jj % 2) +
                    (((2 * kk + jj / 2) ^ g) << 4),
                da[part][kk][jj]);
}

// ---- main: one block per (b, chunk, hb heads) -----------------------------
// x and dy come in by TMA (tm_x, tm_dy: boxes of 64 rows of 64 columns)
// where `tma` is set, else by cp.async; S_in and dS_out by bulk copies.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_grad_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_dy,
                         const SsdArgs a, const int tma) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gp = smem_raw + (base - raw);
  const float* const stage = reinterpret_cast<const float*>(gp + kOffStage);
  float* const dts = reinterpret_cast<float*>(gp + kOffDt);  // [4][128]
  float* const cum = reinterpret_cast<float*>(gp + kOffCum);
  float* const scratch = reinterpret_cast<float*>(gp + kOffScr);
  float* const sums = reinterpret_cast<float*>(gp + kOffSum);  // [i][warp][3]
  float* const cls = sums + kMaxHeads * 8 * 3;
  float* const Ahs = cls + kMaxHeads;
  float* const Dhs = Ahs + kMaxHeads;
  float* const red = Dhs + kMaxHeads;  // [2][4]
  // the sum over the block's heads of dCB^T: warpgroup 0's tiles (s0, t0)
  // and (s0, t1), warpgroup 1's (s1, t1), fp32, each thread's fragment
  const uint32_t sdcb = base + kOffSdcb + (threadIdx.x & 127) * 8;

  const int hb = a.bwd_heads, nhg = a.H / hb, hg = blockIdx.x % nhg;
  const int c = (blockIdx.x / nhg) % a.nC, b = blockIdx.x / nhg / a.nC;
  const int h0 = hg * hb, grp = h0 / (a.H / a.G), t0 = c * a.Lc;
  const int rows = min(a.Lc, a.T - t0), nb = (a.Lc + 63) / 64, Lp = 64 * nb;
  const bool two = nb == 2;
  const int P = a.P, N = a.N;
  // the warpgroup from lane 0, so that the compiler sees it warp-uniform
  // (wgmma in a branch it cannot prove uniform is serialized)
  const int tid = threadIdx.x, tw = tid & 127;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = tw >> 5, lane = tid & 31, q = lane & 3;
  const int ra = 16 * warp + (lane >> 2);  // fragment rows ra, ra + 8
  const long long syt = static_cast<long long>(a.H) * P;
  const uint32_t Bt = base + kOffB, Ct = base + kOffC;
  const uint32_t Sh = base + kOffS, Sl = Sh + kHalf;
  const uint32_t dSh = Sh + 2 * kHalf, dSl = Sh + 3 * kHalf;

  const auto state_at = [&](int i) {  // (b, h0 + i, c)'s offset in states
    return ((static_cast<long long>(b) * a.H + h0 + i) * a.nC + c) * P * N;
  };
  // Head h0 + i's x and dy into buffer i % 2 and its S_in and dS_out into
  // the staging area, completing phase i of the mbarrier (one thread issues
  // the TMA and bulk copies; without TMA every thread issues cp.async)
  const uint32_t ld_bar = base + kOffBar;
  const auto load_head = [&](int i) {
    const int h = h0 + i, buf = i & 1;
    if (tid == 0) {
      mbar_expect_tx(ld_bar, (tma ? 2u * nb * kHalf : 0u) + 8u * P * N);
      for (int k = 0; tma && k < nb; ++k) {
        tma_tile<64, 64>(base + kOffX + buf * kTile + k * kHalf, &tm_x,
                         ld_bar, t0 + 64 * k, h, b);
        tma_tile<64, 64>(base + kOffDy + buf * kTile + k * kHalf, &tm_dy,
                         ld_bar, t0 + 64 * k, h, b);
      }
      bulk_load(base + kOffStage, a.states + state_at(i), 4 * P * N, ld_bar);
      bulk_load(base + kOffStage + kStateBytes, a.dstates + state_at(i),
                4 * P * N, ld_bar);
    }
    if (!tma) {
      load_rows(base + kOffX + buf * kTile,
                static_cast<const bf16*>(a.x) + b * a.sxb + t0 * a.sxt +
                    h * a.sxh,
                a.sxt, rows, Lp, P);
      load_rows(base + kOffDy + buf * kTile,
                static_cast<const bf16*>(a.dy) +
                    (static_cast<long long>(b) * a.T + t0) * syt + h * P,
                syt, rows, Lp, P);
      cp_async_commit();
    }
  };
  // head i's loads have landed (and, after the barrier that follows, every
  // thread's)
  const auto wait_head = [&](int i) {
    mbar_wait(ld_bar, i & 1);
    cp_async_wait();
    fence_async_shared();
  };
  const auto dt_of = [&](int i) -> float {  // this thread's row of dt
    return tid < rows
               ? load_any(a.dt,
                          b * a.sdb + static_cast<long long>(t0 + tid) * a.sdt +
                              static_cast<long long>(h0 + i) * a.sdh,
                          a.dt_dtype)
               : 0.f;
  };

  // Head i's chunk after its products, by warpgroup 1 (thread r, position
  // r) during head i + 1: dcum, its end term at the last row, da = its
  // reverse cumsum (in the warp, then the later warps' totals), ddt = A da
  // + x . dxd; the chunk's dA partial (sum dt da) and dD partial, in a
  // fixed order.
  const auto finish = [&](int i) {
    const float* const scr = scratch + (i & 1) * kScrFloats;
    const float *rq = scr + 8 * 128, *yi = rq + 128, *rr = yi + 128;
    const float* xdx = rr + 128;
    const int r = tw, h = h0 + i;
    float v = 0.f, dtr = 0.f;
    if (r < rows) {
      float cs = 0.f;
      for (int w = 0; w < 4; ++w) cs += scr[w * 128 + r];
      if (r >= 64)
        for (int w = 4; w < 8; ++w) cs += scr[w * 128 + r];
      v = cs - rq[r] + yi[r] - rr[r];
      if (r == rows - 1) {
        float rs = 0.f, sd = 0.f;
        for (int w = 0; w < 8; ++w) {
          rs += sums[(i * 8 + w) * 3];
          sd += sums[(i * 8 + w) * 3 + 1];
        }
        v += rs + expf(cls[i]) * sd;
      }
      dtr = dts[(i & 3) * 128 + r];
    }
    float sfx = v;  // the sum over this and the later lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, sfx, off);
      if (lane + off < 32) sfx += o;
    }
    if (lane == 0) red[warp] = sfx;
    warpgroup_sync(4);
    float da = sfx;
    for (int w = warp + 1; w < 4; ++w) da += red[w];
    if (r < rows)
      a.ddt[(static_cast<long long>(b) * a.T + t0 + r) * a.H + h] =
          Ahs[i] * da + xdx[r];
    const float dap = warp_sum(dtr * da);
    if (lane == 0) red[4 + warp] = dap;
    warpgroup_sync(4);
    if (tw == 0) {
      float dd = 0.f;
      for (int w = 0; w < 8; ++w) dd += sums[(i * 8 + w) * 3 + 2];
      const long long k = static_cast<long long>(h) * a.B * a.nC +
                          static_cast<long long>(b) * a.nC + c;
      a.dA_part[k] = red[4] + red[5] + red[6] + red[7];
      a.dD_part[k] = dd;
    }
  };

  if (tid == 0) {
    mbar_init(ld_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_rows(Bt,
            static_cast<const bf16*>(a.Bm) + b * a.sbb + t0 * a.sbt +
                grp * a.sbg,
            a.sbt, rows, Lp, N);
  load_rows(Ct,
            static_cast<const bf16*>(a.Cm) + b * a.scb + t0 * a.sct +
                grp * a.scg,
            a.sct, rows, Lp, N);
  load_head(0);
  if (tid < hb) {
    Ahs[tid] = load_any(a.A, h0 + tid, a.a_dtype);
    Dhs[tid] = a.has_d ? load_any(a.D, h0 + tid, a.d_dtype) : 0.f;
  }
  if (tid < Lp) dts[tid] = dt_of(0);
  float dt_next = hb > 1 ? dt_of(1) : 0.f;
  cp_async_commit();
  wait_head(0);
  __syncthreads();

  // the S_in / dS_out terms of dB (this warpgroup's s-block) and dC (its
  // t-block), over the heads; the dCB^T sums start at 0
  float db[32], dc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) db[r] = dc[r] = 0.f;
  for (int slot = 0; slot < 3; ++slot)
#pragma unroll
    for (int r = 0; r < 32; r += 2)
      sts_f2(sdcb + slot * kStateBytes + (r / 2) * 1024, make_float2(0.f, 0.f));

  for (int i = 0; i < hb; ++i) {
    const int h = h0 + i, buf = i & 1;
    // ---- between heads: head i's tiles are in; its states to bf16 hi +
    // lo, its cum ----
    if (i > 0) {
      wait_head(i);
      __syncthreads();
    }
    const float sds = warp_sum(convert_states(Sh, stage, P, N));
    if (lane == 0) sums[(i * 8 + wg * 4 + warp) * 3 + 1] = sds;
    if (tid >= 128 && tid < 160)
      chunk_cumsum(dts + (i & 3) * 128, Ahs[i], cum, Lp);
    if (i + 1 < hb && tid < Lp) dts[((i + 1) & 3) * 128 + tid] = dt_next;
    fence_async_shared();
    __syncthreads();
    if (i + 1 < hb) {  // head i + 1's tiles land while head i is computed
      dt_next = i + 2 < hb ? dt_of(i + 2) : 0.f;
      load_head(i + 1);
    }

    // ---- head i: warpgroup wg owns rows s of block wg ----
    const uint32_t Xt = base + kOffX + buf * kTile;
    const uint32_t DYt = base + kOffDy + buf * kTile;
    const float* const dtv = dts + (i & 3) * 128;
    float* const scr = scratch + (i & 1) * kScrFloats;
    float *const rq = scr + 8 * 128, *const yi = rq + 128;
    float *const rr = yi + 128, *const xdx = rr + 128;
    const float cl = cum[Lp - 1];
    if (tid == 0) cls[i] = cl;
    float rrw = 0.f, ddw = 0.f;
    if (wg == 1 && i > 0) finish(i - 1);
    if (wg == 0 || two) {
      const int s0 = 64 * wg;
      float dx[32], rqa[2] = {0.f, 0.f}, dd = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) dx[r] = 0.f;
      // Tiles (s-block wg, t-block tb): warpgroup 0 (s0, t1) then (s0, t0),
      // warpgroup 1 (s1, t1).  x dy^T and C B^T in one wgmma stage; then
      // M^T (hi / lo A fragments) and dCB^T, added to the heads' sum; then
      // dx += M^T dy.  Every wgmma stage (fence .. wait) is straight-line
      // code: a branch inside one makes the compiler serialize every wgmma.
      for (int k = 0; k < (wg == 0 ? nb : 1); ++k) {
        const int tb = wg == 1 || (two && k == 0) ? 1 : 0;
        float m[32], dm[32], cqv[16];
        wgmma_fence();
        mma_ss(dm, Xt + wg * kHalf, DYt + tb * kHalf, false);
        mma_ss(m, Bt + wg * kHalf, Ct + tb * kHalf, false);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dm);
        pin(m);
#pragma unroll
        for (int j = 0; j < 16; ++j) cqv[j] = 0.f;
        if (tb == wg)
          tile_grads<true>(m, dm, cum, dtv, s0, 64 * tb, rqa, cqv, dd);
        else
          tile_grads<false>(m, dm, cum, dtv, s0, 64 * tb, rqa, cqv, dd);
        col_sums(cqv, scr + (wg * 4 + warp) * 128 + 64 * tb);
        const uint32_t slot = sdcb + (wg + tb) * kStateBytes;
#pragma unroll
        for (int r = 0; r < 32; r += 2) {
          const float2 v = lds_f2(slot + (r / 2) * 1024);
          sts_f2(slot + (r / 2) * 1024, make_float2(v.x + dm[r], v.y + dm[r + 1]));
        }
        uint32_t ma[2][4][4];
        to_a<64>(m, ma);
        if (a.bf16_parts == 1) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) ma[1][kk][j] = 0u;
        }
        wgmma_fence();
        mma_rs(dx, ma, DYt + tb * kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dx);
        pin_a(ma);
      }
      const float rq0 = quad_sum(rqa[0]), rq1 = quad_sum(rqa[1]);
      if (q == 0) {
        rq[s0 + ra] = rq0;
        rq[s0 + ra + 8] = rq1;
      }
      ddw = warp_sum(dd);

      // S_in and dS_out terms of rows s0 (dx, dB) and t-block wg (dC)
      const float cs[2] = {cum[s0 + ra], cum[s0 + ra + 8]};
      const float ds[2] = {dtv[s0 + ra], dtv[s0 + ra + 8]};
      const float w[2] = {expf(cl - cs[0]), expf(cl - cs[1])};
      const float ec[2] = {expf(cs[0]), expf(cs[1])};
      float t[32];
      // dS_out B_s: r_s = w_s dt_s x_s . (dS_out B_s); dxd_s += w_s dS_out B_s
      wgmma_fence();
      mma_ss(t, Bt + s0 * 128, dSh, false);
      mma_ss(t, Bt + s0 * 128, dSl, true);
      wgmma_commit();
      wgmma_wait<0>();
      pin(t);
      float rp[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int i2 = (r >> 1) & 1, col = 8 * (r >> 2) + 2 * q;
        const float2 x2 = lds_bf2(Xt + sw(s0 + ra + 8 * i2, col));
        rp[i2] = fmaf(x2.x, t[r], fmaf(x2.y, t[r + 1], rp[i2]));
        dx[r] = fmaf(w[i2], t[r], dx[r]);
        dx[r + 1] = fmaf(w[i2], t[r + 1], dx[r + 1]);
      }
      const float rs0 = w[0] * ds[0] * quad_sum(rp[0]);
      const float rs1 = w[1] * ds[1] * quad_sum(rp[1]);
      if (q == 0) {
        rr[s0 + ra] = rs0;
        rr[s0 + ra + 8] = rs1;
      }
      rrw = warp_sum(q == 0 ? rs0 + rs1 : 0.f);
      // x_s dS_out: dB_s += w_s dt_s x_s dS_out
      wgmma_fence();
      mma_ss_bt<0>(t, Xt + s0 * 128, dSh, false);
      mma_ss_bt<0>(t, Xt + s0 * 128, dSl, true);
      wgmma_commit();
      wgmma_wait<0>();
      pin(t);
#pragma unroll
      for (int r = 0; r < 32; ++r)
        db[r] = fmaf(w[(r >> 1) & 1] * ds[(r >> 1) & 1], t[r], db[r]);
      // dy_t S_in (t = s0 + row): dC_t += exp(cum_t) dy_t S_in, and
      // dy_t . y_inter_t = exp(cum_t) C_t . (dy_t S_in)
      wgmma_fence();
      mma_ss_bt<0>(t, DYt + s0 * 128, Sh, false);
      mma_ss_bt<0>(t, DYt + s0 * 128, Sl, true);
      wgmma_commit();
      wgmma_wait<0>();
      pin(t);
      float yp[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int i2 = (r >> 1) & 1, col = 8 * (r >> 2) + 2 * q;
        const float2 c2 = lds_bf2(Ct + sw(s0 + ra + 8 * i2, col));
        yp[i2] = fmaf(c2.x, t[r], fmaf(c2.y, t[r + 1], yp[i2]));
        dc[r] = fmaf(ec[i2], t[r], dc[r]);
        dc[r + 1] = fmaf(ec[i2], t[r + 1], dc[r + 1]);
      }
      const float y0 = ec[0] * quad_sum(yp[0]), y1 = ec[1] * quad_sum(yp[1]);

      // dx = dt dxd + D dy; x . dxd for ddt
      bf16* const dxo = static_cast<bf16*>(a.dx) +
                        (static_cast<long long>(b) * a.T + t0) * syt + h * P;
      const float Dh = Dhs[i];
      float xp[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int i2 = (r >> 1) & 1, col = 8 * (r >> 2) + 2 * q;
        const int s = s0 + ra + 8 * i2;
        const float2 x2 = lds_bf2(Xt + sw(s, col));
        xp[i2] = fmaf(x2.x, dx[r], fmaf(x2.y, dx[r + 1], xp[i2]));
        if (s < rows && col < P) {
          const float2 y2 = lds_bf2(DYt + sw(s, col));
          *reinterpret_cast<__nv_bfloat162*>(dxo + s * syt + col) =
              __floats2bfloat162_rn(fmaf(ds[i2], dx[r], Dh * y2.x),
                                    fmaf(ds[i2], dx[r + 1], Dh * y2.y));
        }
      }
      const float x0 = quad_sum(xp[0]), x1 = quad_sum(xp[1]);
      if (q == 0) {
        yi[s0 + ra] = y0;
        yi[s0 + ra + 8] = y1;
        xdx[s0 + ra] = x0;
        xdx[s0 + ra + 8] = x1;
      }
    }
    if (lane == 0) {
      sums[(i * 8 + wg * 4 + warp) * 3] = rrw;
      sums[(i * 8 + wg * 4 + warp) * 3 + 2] = ddw;
    }
  }
  __syncthreads();
  if (wg == 1) finish(hb - 1);

  // dB_s += (sum_h dCB_h^T) C and dC_t += (sum_h dCB_h) B: the dCB^T sums
  // as hi / lo A fragments, times C; and as [s][t] tiles (over the x and dy
  // buffers, free now) for the transposed product with B
  const uint32_t tiles = base + kOffX;  // slot j's hi, lo at 2 j kHalf
  for (int k = 0; k < (wg == 0 ? nb : (two ? 1 : 0)); ++k) {
    const int tb = wg == 1 ? 1 : k, slot = wg + tb;
    float v[32];
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const float2 f = lds_f2(sdcb + slot * kStateBytes + (r / 2) * 1024);
      v[r] = f.x;
      v[r + 1] = f.y;
    }
    uint32_t ua[2][4][4];
    to_a<64>(v, ua);
    if (a.bf16_parts == 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) ua[1][kk][j] = 0u;
    }
    store_dcb(tiles + 2 * slot * kHalf, ua);
    wgmma_fence();
    mma_rs(db, ua, Ct + tb * kHalf);
    wgmma_commit();
    wgmma_wait<0>();
    pin(db);
    pin_a(ua);
  }
  fence_async_shared();
  __syncthreads();
  if (wg == 0) {  // t-block 0: s-block 0's tile
    wgmma_fence();
    mma_ss_bt<1>(dc, tiles, Bt, true);
    mma_ss_bt<1>(dc, tiles + kHalf, Bt, true);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dc);
  } else if (two) {  // t-block 1: both s-blocks' tiles
    wgmma_fence();
    mma_ss_bt<1>(dc, tiles + 2 * kHalf, Bt, true);
    mma_ss_bt<1>(dc, tiles + 3 * kHalf, Bt, true);
    mma_ss_bt<1>(dc, tiles + 4 * kHalf, Bt + kHalf, true);
    mma_ss_bt<1>(dc, tiles + 5 * kHalf, Bt + kHalf, true);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dc);
  }

  // dB of the s-block and dC of the t-block this warpgroup owns, summed
  // over the block's heads: (B, T, H / hb, N) partials
  if (wg == 0 || two) {
    const long long st = static_cast<long long>(nhg) * N;
    const long long off = (static_cast<long long>(b) * a.T + t0) * st + hg * N;
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int s = 64 * wg + ra + 8 * ((r >> 1) & 1);
      const int n = 8 * (r >> 2) + 2 * q;
      if (s < rows && n < N) {
        a.dBh[off + s * st + n] = db[r];
        a.dCh[off + s * st + n] = dc[r];
        if (n + 1 < N) {
          a.dBh[off + s * st + n + 1] = db[r + 1];
          a.dCh[off + s * st + n + 1] = dc[r + 1];
        }
      }
    }
  }
}

}  // namespace

// The bf16 chunk gradients, after the reverse scan (ssd_sm90.cu's
// group_sum_kernel sums them next): needs bf16 x, B, C, dy; P <= 64, N <=
// 64, Lc <= 128; bwd_heads (<= 16) dividing H / G; dBh / dCh of (B, T, H /
// bwd_heads, N).
cudaError_t ssd_bf16_chunk_grads(const SsdArgs& a, cudaStream_t stream) {
  if (a.x_dtype != repro::kBF16 || a.bwd_heads < 1 ||
      a.bwd_heads > kMaxHeads || (a.H / a.G) % a.bwd_heads || a.P > 64 ||
      a.P % 16 || a.N > 64 || a.Lc > 128 ||
      (a.bf16_parts != 1 && a.bf16_parts != 2))
    return cudaErrorInvalidValue;
  static bool opted[64] = {};
  cudaError_t e = sm90::opt_in_smem(ssd_grad_sm90_kernel, kSmem, opted);
  if (e != cudaSuccess) return e;
  const long long blocks =
      static_cast<long long>(a.B) * a.nC * (a.H / a.bwd_heads);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  // TMA for x and dy where a 64-column box is one head's row (P 64), the
  // rows and the base are 16-byte aligned and every chunk is whole 64-row
  // boxes (rows past T read as zeros; past a chunk's end they would not)
  CUtensorMap tx = {}, tdy = {};
  const long long syt = static_cast<long long>(a.H) * a.P;
  const bool tma =
      a.P == 64 && a.Lc % 64 == 0 && a.sxt % 8 == 0 && a.sxh % 8 == 0 &&
      a.sxb % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.dy) % 16 == 0 &&
      sm90::encode<64>(&tx, a.x, a.T, a.H, a.B, a.sxt, a.sxh, a.sxb, 64) &&
      sm90::encode<64>(&tdy, a.dy, a.T, a.H, a.B, syt, a.P, a.T * syt, 64);
  ssd_grad_sm90_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                         stream>>>(tx, tdy, a, tma ? 1 : 0);
  return cudaGetLastError();
}
