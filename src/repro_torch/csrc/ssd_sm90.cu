// Mamba-2 SSD (state-space dual) chunk scan for Hopper (sm_90a): a
// chunk-parallel forward on tensor cores and a hand-written backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py `ssd_fwd`
// (pallas_call at :71, body `_ssd_kernel` at :30), and the backward that
// the reference takes by differentiating its chunk loop
// (src/repro/kernels/ssd/ops.py `_vjp_bwd`), for bf16 and fp32 inputs.
// Per (batch b, head h) and chunk of Lc positions, with cum the
// inclusive cumsum of dt*A over the chunk, L[t,s] = exp(cum_t - cum_s) on
// s <= t (masked before exp, so nothing overflows) and xd = dt x:
//   y_t   = sum_{s<=t} (C_t . B_s) L[t,s] xd_s + exp(cum_t) C_t . S_in + D x_t
//   S_out = exp(cum_last) S_in + sum_s exp(cum_last - cum_s) xd_s B_s^T
//
// Forward, two launches:
//   1. chunk_scan_kernel, one block per (b, h) walking its chunks: each
//      chunk's own state sum_s exp(cum_last - cum_s) dt_s x_s B_s^T, a
//      (P x Lc)(Lc x N) product on the tensor cores, and the short
//      sequential pass S_in[c+1] = exp(cum_last) S_in[c] + that, carried in
//      registers in fp32; it writes the state entering every chunk and,
//      where asked (`final`), the state leaving the last one: the
//      reference's final S (a ragged last chunk is padded with dt = 0, a
//      decay of exp(0) = 1, so it is the state at the true T);
//   2. the inter term exp(cum_t) C S_in^T, then per 16 x 16 tile of the
//      lower triangle C B^T, masked and decayed into M, times x; plus D x:
//      bf16 in chunk_out_kernel, one block per (b, h, chunk); fp32 in
//      chunk_out_f32_kernel, one block per (b, chunk) and 16 heads, which
//      makes C B^T once for all of them.
// Backward, three launches (four when no forward states are given: phase 1
// first):
//   1. the same scan on dy and C with weights exp(cum_t), run from the last
//      chunk back: dS_out, the gradient of the state leaving each chunk;
//   2. the chunk gradients given S_in and dS_out: bf16 on
//      ssd_bwd_sm90.cu's wgmma kernel (one block per (b, chunk, 16 heads of
//      a group), dB and dC made once a block from the heads' sum of dCB,
//      partials (B, T, H / 16, N)); fp32 here, on chunk_grad_kernel, one
//      block per (b, h, chunk): a row pass (16 rows t: dC_t and the
//      exponents' gradient through y_t) and a column pass (16 columns s:
//      dx_s, dB_s and the gradient through s), each recomputing its tiles
//      of C B^T and dy x^T in fp32 FMAs; then dcum, its reverse cumsum
//      within the chunk (ddt, dA) and dD, with per-chunk and per-head
//      partials in fp32;
//   3. group_sum_kernel: dB and dC summed over a group's partials, dA and
//      dD over batches and chunks, in a fixed order: deterministic, no
//      atomics.
//
// Products of bf16 inputs here (the forward and the scans; the backward's
// chunk gradients are ssd_bwd_sm90.cu's): bf16 mma.sync.m16n8k16 with fp32
// sums.  x, B, C and dy are bf16 values already and reach the tensor cores
// through ldmatrix; an fp32 operand (the decayed tile M, the states, the
// weighted x of phase 1) is split into a bf16 hi part and a bf16 lo part,
// two products, so every product keeps its fp32 operand to ~2^-16.
// A 16 x 16 tile made in registers is the next product's A operand in place
// (its C fragment layout is the A layout), as a flash kernel does with P.
// Work is even across warps: a warp takes the 16-row blocks rb and nb - 1 -
// rb of the lower triangle.
//
// Products of fp32 inputs in the forward (phases 1-3, and phase 1 of the
// backward): TF32 mma.sync.m16n8k8 with three products, hi*hi + hi*lo +
// lo*hi (tf32.cuh, as the fp32 flash kernels), in the bf16 kernels'
// fragment layout, split at each use by `split_rz` (a mask and an add, no
// conversion: split with cvt.rna, the kernels were bound by the
// conversions, which issue at a quarter of the fp32 rate).  Operands are read
// from fp32 tiles whose rows are padded by 4 floats, and a k-major operand
// (x, B, the weighted x) in the order logical k q -> row 2q, q + 4 -> 2q +
// 1, which is also the order of a C fragment's columns: so a 16 x 16 tile
// in registers is an A operand in place, and every fragment read hits 32
// distinct banks.  Long sums (the
// 128 rows of a chunk's own state, the tiles of y) go in parts of 16 rows,
// each in its own accumulator, added with round to nearest: the tensor
// cores' fp32 sums truncate.  `tf32_products` = 1 keeps hi*hi only, a
// planted fault that the checks must reject.  The fp32 backward's chunk
// gradients take fp32 FMAs in the same fragment layout (tile_mm's kMma
// false), through a per-warp scratch tile.  Any P of 16/32/64, N <= 64 and
// Lc <= 128; a chunk whose length is not a multiple of 16 is padded inside
// the kernel (zero rows, dt = 0).
//
// Bound on the H100 at zamba2-1.2b (B 4, T 2048, H 64, P 64, N 64, Lc 128):
// bf16, bytes.  The forward must move x and y (67 MB each); the chunk-
// parallel grid adds the states, written by phase 1 and read by phase 2
// (67 MB fp32 each way).  fp32: operations, 17.2 GFLOP at 495 / 3 TFLOP/s
// (three TF32 products a product), above the 134 MB of x and y each.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ssd.cuh"
#include "tf32.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLc = 128;   // chunk length
constexpr int kMaxN = 64;     // state size
constexpr int kNT = kMaxN / 8;  // n8 tiles across N
constexpr int kWs = 20;       // row stride of a warp's 16 x 16 scratch tile

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int dtype) {
  return dtype == repro::kBF16
             ? to_f32(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// row stride (elements) of an x / dy (width P) or B / C (width Np) tile
template <typename T>
__host__ __device__ constexpr int padded(int w) {
  return w + (sizeof(T) == 2 ? 8 : 4);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16x2 hi (a in the low half) and the remainders' bf16x2 lo
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8m .. 8m+7 giving the
// rows of matrix m; .trans hands each lane the transposed fragment
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Operands of tile_mm: a tile in shared memory read as (row, col).  bf16
// tiles go to the tensor cores through ldmatrix; their rows are 16-byte
// aligned and padded by 8 elements, so its eight rows a phase fall on
// distinct banks.  fp32 tiles are split into bf16 hi + lo.
template <typename T>
struct RowMajor {  // (r, c) at p[r * ld + c]
  const T* p;
  int ld;
  __device__ float operator()(int r, int c) const { return to_f32(p[r * ld + c]); }
};
template <typename T>
struct ColMajor {  // (r, c) at p[c * ld + r]
  const T* p;
  int ld;
  __device__ float operator()(int r, int c) const { return to_f32(p[c * ld + r]); }
};
template <class Op>
constexpr bool kBf16Tile = std::is_same_v<Op, RowMajor<__nv_bfloat16>> ||
                           std::is_same_v<Op, ColMajor<__nv_bfloat16>>;

// mma.sync's A fragment of rows 0..15, columns k0..k0+15 of a bf16 tile
template <class Op>
__device__ __forceinline__ void a_frag(const Op& A, int k0, uint32_t (&h)[4]) {
  static_assert(kBf16Tile<Op>, "A operands are bf16 tiles or registers");
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same_v<Op, RowMajor<__nv_bfloat16>>) {
    ldsm4(h, A.p + (lane & 15) * A.ld + k0 + (lane >> 4) * 8);
  } else {
    const int m = lane >> 3;  // stored [k][i]
    ldsm4_t(h, A.p + (k0 + (lane & 7) + (m >> 1) * 8) * A.ld + (m & 1) * 8);
  }
}

// mma.sync's B fragments of rows k0..k0+15 and the two column tiles n0 and
// n0 + 8: h[0..1] the first, h[2..3] the second
template <class Op>
__device__ __forceinline__ void b_frag2(const Op& B, int k0, int n0,
                                        uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, ka = k0 + 2 * (lane & 3);
  if constexpr (std::is_same_v<Op, RowMajor<__nv_bfloat16>>) {  // [k][n]
    ldsm4_t(h, B.p + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * B.ld + n0 +
                   (lane >> 4) * 8);
  } else if constexpr (std::is_same_v<Op, ColMajor<__nv_bfloat16>>) {  // [n][k]
    ldsm4(h, B.p + (n0 + (lane & 7) + (lane >> 4) * 8) * B.ld + k0 +
                 ((lane >> 3) & 1) * 8);
  } else if constexpr (std::is_same_v<Op, ColMajor<float>>) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v = *reinterpret_cast<const float2*>(
          B.p + (n0 + g + (u >> 1) * 8) * B.ld + ka + (u & 1) * 8);
      split2(v.x, v.y, h[u], l[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + g + (u >> 1) * 8, k = ka + (u & 1) * 8;
      split2(B(k, n), B(k + 1, n), h[u], l[u]);
    }
  }
}

// acc[j], acc[j+1] += the products of one A fragment and one b_frag2 pair
template <bool kSplitA, bool kSplitB, int NT>
__device__ __forceinline__ void mma2(float (&acc)[NT][4], int j,
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[4],
                                     const uint32_t (&bl)[4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mma16816(acc[j + u], ah, bh[2 * u], bh[2 * u + 1]);
    if constexpr (kSplitA) mma16816(acc[j + u], al, bh[2 * u], bh[2 * u + 1]);
    if constexpr (kSplitB) mma16816(acc[j + u], ah, bl[2 * u], bl[2 * u + 1]);
  }
}

// acc[j] += A[16 x K] B[K x (8j .. 8j+7)] for j < nt (nt even).  Fragments
// are mma.sync's C layout: lane (g, q) = (lane / 4, lane % 4) holds rows g
// and g + 8, columns 2q and 2q + 1 (acc[j][0..3] = (g,2q) (g,2q+1)
// (g+8,2q) (g+8,2q+1)).  A(i, k) and B(k, j) are operands (above) or, on
// the FMA path, callables returning fp32.  kMma: bf16 mma.sync with fp32
// sums, A a bf16 tile; a B that kSplitB marks as fp32 is rounded to bf16
// (hi) and its remainder (lo) taken as a second product.  Else fp32 FMAs in
// the same layout.  K % 16 == 0.
template <bool kMma, bool kSplitB, int NT, class FA, class FB>
__device__ __forceinline__ void tile_mm(float (&acc)[NT][4], int nt, int K,
                                        const FA& A, const FB& B) {
  static_assert(NT % 2 == 0, "column tiles go in pairs");
  static_assert(!(kSplitB && kBf16Tile<FB>), "a bf16 tile has no lo part");
  if constexpr (kMma) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t ah[4];
      a_frag(A, k0, ah);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j < nt) {
          uint32_t bh[4], bl[4] = {0u, 0u, 0u, 0u};
          b_frag2(B, k0, 8 * j, bh, bl);
          mma2<false, kSplitB>(acc, j, ah, ah, bh, bl);
        }
      }
    }
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    for (int k = 0; k < K; ++k) {
      const float a0 = A(g, k), a1 = A(g + 8, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const float b0 = B(k, 8 * j + 2 * q), b1 = B(k, 8 * j + 2 * q + 1);
          acc[j][0] = fmaf(a0, b0, acc[j][0]);
          acc[j][1] = fmaf(a0, b1, acc[j][1]);
          acc[j][2] = fmaf(a1, b0, acc[j][2]);
          acc[j][3] = fmaf(a1, b1, acc[j][3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// the row (0..15) and column (0..8*NT-1) of fragment entry (j, e)
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e & 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// the sum over the four lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a 16 x 16 tile (two n8 fragments) into the warp's scratch
__device__ __forceinline__ void tile_to_smem(const float (&t)[2][4],
                                             float* ws) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ws[frag_row(e) * kWs + frag_col(j, e)] = t[j][e];
}

// acc += t B, with t a 16 x 16 fp32 tile in registers (C layout) as the A
// operand.  On the tensor cores the C layout of two column tiles is the A
// layout, so t is split into bf16 hi + lo in place; the FMA path goes
// through the warp's scratch tile `ws`.
template <bool kMma, int NT, class FB>
__device__ __forceinline__ void tile_mm_t(float (&acc)[NT][4], int nt,
                                          const float (&t)[2][4], float* ws,
                                          const FB& B) {
  if constexpr (kMma) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      split2(t[u >> 1][(u & 1) * 2], t[u >> 1][(u & 1) * 2 + 1], ah[u], al[u]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        uint32_t bh[4], bl[4] = {0u, 0u, 0u, 0u};
        b_frag2(B, 0, 8 * j, bh, bl);
        mma2<true, false>(acc, j, ah, al, bh, bl);
      }
    }
  } else {
    tile_to_smem(t, ws);
    __syncwarp();
    tile_mm<false, false>(acc, nt, 16, RowMajor<float>{ws, kWs}, B);
    __syncwarp();
  }
}

// the sum of v over the block, in a fixed order; every thread gets it
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red's earlier readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
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

// reverse inclusive cumsum da[r] = sum_{t >= r} v[t] over r < Lp, by warp 0
__device__ void chunk_rcumsum(const float* v, float* da, int Lp) {
  const int lane = threadIdx.x;
  const int E = (Lp + 31) / 32, lo = lane * E, hi = min(lo + E, Lp);
  float run = 0.f;
  for (int r = lo; r < hi; ++r) run += v[r];
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  float acc = incl - run;  // the sum over the later lanes
  for (int r = hi - 1; r >= lo; --r) {
    acc += v[r];
    da[r] = acc;
  }
}

// Where a block's chunk lies: (b, h, c), its group, first position, rows,
// and bhc = (b * H + h) * nC + c, its index in the (B,H,nC) state arrays.
// The head runs fastest in blockIdx: blocks in flight together read
// neighbouring heads of the same positions (whole rows of x, dy and y) and
// the same rows of B and C.
struct Chunk {
  int b, h, c, grp, t0, rows, Lp;
  long long bhc;
  __device__ explicit Chunk(const SsdArgs& a) {
    h = static_cast<int>(blockIdx.x % a.H);
    c = static_cast<int>((blockIdx.x / a.H) % a.nC);
    b = static_cast<int>(blockIdx.x / a.H / a.nC);
    bhc = (static_cast<long long>(b) * a.H + h) * a.nC + c;
    grp = h / (a.H / a.G);
    t0 = c * a.Lc;
    rows = min(a.Lc, a.T - t0);
    Lp = round16(a.Lc);
  }
};

// 16 bytes global -> shared without a register stage; `bytes` 0 writes
// zeros (cp.async's zero fill)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// every cp.async this thread issued has landed (a __syncthreads follows)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, Lp) of a (B,T,*,W) tensor's head/group slice into smem [Lp][ld]
// as T, zero past `rows` and past W up to Wp.  Where the rows are 16-byte
// vectors, cp.async: every tile of a block is in flight at once, and
// cp_async_wait_all() ends the copy.  Else one element at a time.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long st, int rows,
                          int Lp, int W, int Wp) {
  constexpr int kV = 16 / sizeof(T);
  if (W % kV == 0 && st % kV == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vw = W / kV;
    for (int i = threadIdx.x; i < Lp * vw; i += kThreads) {
      const int r = i / vw, k = (i % vw) * kV;
      cp_async16(dst + r * ld + k, src + (r < rows ? r * st + k : 0),
                 r < rows ? 16 : 0);
    }
    const int pad = Wp - W;
    for (int i = threadIdx.x; i < Lp * pad; i += kThreads)
      dst[(i / pad) * ld + W + i % pad] = from_f32<T>(0.f);
    return;
  }
  for (int i = threadIdx.x; i < Lp * Wp; i += kThreads) {
    const int r = i / Wp, k = i % Wp;
    dst[r * ld + k] = r < rows && k < W ? src[r * st + k] : from_f32<T>(0.f);
  }
}

// a (P, N) fp32 state into smem [P][ld], zero past N up to Np (cp.async
// where N % 4 == 0, as load_tile)
__device__ void load_state(float* dst, int ld, const float* src, int P, int N,
                           int Np) {
  if (N % 4 == 0) {
    const int vw = Np / 4, nv = N / 4;
    for (int i = threadIdx.x; i < P * vw; i += kThreads) {
      const int p = i / vw, k = i % vw;
      cp_async16(dst + p * ld + 4 * k, src + (k < nv ? p * N + 4 * k : 0),
                 k < nv ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < P * Np; i += kThreads) {
    const int p = i / Np, k = i % Np;
    dst[p * ld + k] = k < N ? src[p * N + k] : 0.f;
  }
}

// two adjacent outputs (columns 2q, 2q + 1 of a fragment row) in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// fp32 tiles on the tensor cores (TF32 with kProd products a product).
// acc[j] (+)= A B for j < nt: A's 16 rows at a[r * lda + k] and B's columns
// 8j .. 8j+7 at b[n * ldb + k] (both k-contiguous), over K (K % 8 == 0),
// summed in the tensor cores.  lda and ldb are 4 mod 32 floats, so each
// fragment read hits 32 distinct banks.
template <int kProd, int NT>
__device__ __forceinline__ void tf32_mm_nk(float (&acc)[NT][4], int nt, int K,
                                           const float* a, int lda,
                                           const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32::split_rz(a[(g + (i & 1) * 8) * lda + k0 + q + (i >> 1) * 4], ah[i],
                  al[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float* br = b + (8 * j + g) * ldb + k0 + q;
        tf32::mma3<kProd, true>(acc[j], ah, al, br[0], br[4]);
      }
    }
  }
}

// acc[j] += t X for j < nt, with t a 16 x 16 fp32 tile in registers (C
// layout) and X's 16 rows at x[k * ldx + n].  The C layout holds columns
// (2q, 2q + 1) where the A operand wants (q, q + 4): X's rows are read in
// the same order, logical k q -> row 2q, q + 4 -> 2q + 1 (ldx is 4 mod 32
// floats: rows 2q lie 8q banks apart).  The product is summed in its own
// accumulator and added with round to nearest.
template <int kProd, int NT>
__device__ __forceinline__ void tf32_acc_tile(float (&acc)[NT][4], int nt,
                                              const float (&t)[2][4],
                                              const float* x, int ldx) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    tf32::split_rz(t[u][0], ah[u][0], al[u][0]);
    tf32::split_rz(t[u][2], ah[u][1], al[u][1]);
    tf32::split_rz(t[u][1], ah[u][2], al[u][2]);
    tf32::split_rz(t[u][3], ah[u][3], al[u][3]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* xr = x + (8 * u + 2 * q) * ldx + 8 * j + g;
        tf32::mma3<kProd, true>(part, ah[u], al[u], xr[0], xr[ldx]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

// Phases 1-2 of the forward (bwd 0) or of the backward (bwd 1), one block
// per (b, h) walking its chunks: each chunk's own part
//   loc[p][n] = sum_s coef_s U_s[p] V_s[n]
// with U = x, V = B, coef_s = dt_s exp(cum_last - cum_s) (forward), or
// U = dy, V = C, coef_s = exp(cum_s) (backward), and the sequential pass
//   out[c] = run;  run = exp(cum_last[c]) run + loc[c]
// from the first chunk on into `states` (the state entering each chunk) or
// from the last one back into `dstates` (the gradient of the state leaving
// it); a forward also writes the state leaving the last chunk into `final`
// where that is given.  A warp owns 16 rows p and 32 columns n of loc and
// of run, which stays in its registers from chunk to chunk in fp32.  bf16:
// coef_s U_s in bf16 hi + lo tiles; fp32: TF32 with kProd products, the
// chunk's 128 rows s in parts of 16, each in its own accumulator.
template <typename T, int P, int kProd>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_scan_kernel(const SsdArgs a, const int bwd) {
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, grp = h / (a.H / a.G);
  const int Lp = round16(a.Lc), N = a.N, Np = round16(N);
  const int ldu = padded<T>(P), ldv = padded<T>(Np);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + Lp;
  float* coef = cum + Lp;
  T* Us = reinterpret_cast<T*>(coef + Lp);
  T* Vs = Us + Lp * ldu;
  T* Ws = Vs + Lp * ldv;  // bf16: the lo parts of coef_s U_s

  const T* U0;
  long long sut;
  if (bwd) {
    U0 = static_cast<const T*>(a.dy) + (static_cast<long long>(b) * a.T * a.H + h) * P;
    sut = static_cast<long long>(a.H) * P;
  } else {
    U0 = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
    sut = a.sxt;
  }
  const T* V0 = bwd ? static_cast<const T*>(a.Cm) + b * a.scb + grp * a.scg
                    : static_cast<const T*>(a.Bm) + b * a.sbb + grp * a.sbg;
  const long long svt = bwd ? a.sct : a.sbt;
  const float Ah = load_any(a.A, h, a.a_dtype);
  float* out = (bwd ? a.dstates : a.states) +
               static_cast<long long>(b * a.H + h) * a.nC * P * N;

  const int warp = threadIdx.x >> 5;
  const int groups = (Np / 8 + 3) / 4;  // of up to four n8 tiles
  const bool owner = warp < (P / 16) * groups;
  const int r0 = 16 * (warp / groups), c0 = 32 * (warp % groups);
  const int nt = min(4, Np / 8 - 4 * (warp % groups));
  float run[4][4];
  zero(run);
  for (int i = 0; i < a.nC; ++i) {
    const int c = bwd ? a.nC - 1 - i : i;
    const int t0 = c * a.Lc, rows = min(a.Lc, a.T - t0);
    __syncthreads();  // the last chunk's readers of the tiles are done
    load_tile(Us, ldu, U0 + t0 * sut, sut, rows, Lp, P, P);
    load_tile(Vs, ldv, V0 + t0 * svt, svt, rows, Lp, N, Np);
    const long long dt0 = b * a.sdb + t0 * a.sdt + h * a.sdh;
    for (int r = threadIdx.x; r < Lp; r += kThreads)
      dts[r] = r < rows ? load_any(a.dt, dt0 + r * a.sdt, a.dt_dtype) : 0.f;
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x < 32) chunk_cumsum(dts, Ah, cum, Lp);
    __syncthreads();
    const float cl = cum[Lp - 1];
    for (int r = threadIdx.x; r < Lp; r += kThreads)
      coef[r] = bwd ? expf(cum[r]) : dts[r] * expf(cl - cum[r]);
    __syncthreads();
    if constexpr (kMma) {
      // coef_s U_s in bf16 hi (over Us) + lo (Ws): both exact tile operands
      for (int j = threadIdx.x; j < Lp * P; j += kThreads) {
        const int k = (j / P) * ldu + j % P;
        const float v = coef[j / P] * to_f32(Us[k]);
        const __nv_bfloat16 hi = __float2bfloat16(v);
        Us[k] = hi;
        Ws[k] = __float2bfloat16(v - __bfloat162float(hi));
      }
      __syncthreads();
    }
    if (!owner) continue;
    float acc[4][4];
    zero(acc);
    if constexpr (kMma) {
      const RowMajor<T> V{Vs + c0, ldv};
      for (int k0 = 0; k0 < Lp; k0 += 16) {
        uint32_t ah[4], al[4];
        a_frag(ColMajor<T>{Us + r0, ldu}, k0, ah);
        a_frag(ColMajor<T>{Ws + r0, ldu}, k0, al);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (j < nt) {
            uint32_t bh[4], bl[4];
            b_frag2(V, k0, 8 * j, bh, bl);
            mma2<true, false>(acc, j, ah, al, bh, bl);  // (hi + lo) B
          }
        }
      }
    } else {
      // A(p, s) = coef_s U_s[p] and B(s, n) = V_s[n], both read at rows
      // s = k0 + 2q (logical k q) and k0 + 2q + 1 (q + 4)
      const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
      for (int k0 = 0; k0 < Lp; k0 += 16) {
        float part[4][4];
        zero(part);
#pragma unroll
        for (int kk = k0; kk < k0 + 16; kk += 8) {
          const int s0 = kk + 2 * q;
          const float* u0 = Us + s0 * ldu + r0 + g;
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = i >> 1;  // 0: row s0, 1: row s0 + 1
            tf32::split_rz(coef[s0 + k] * u0[k * ldu + (i & 1) * 8], ah[i], al[i]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nt) {
              const float* vr = Vs + s0 * ldv + c0 + 8 * j + g;
              tf32::mma3<kProd, true>(part[j], ah, al, vr[0], vr[ldv]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
      }
    }
    const float dec = expf(cl);
    float* o = out + static_cast<long long>(c) * P * N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int n = c0 + frag_col(j, e);
        float* q = o + (r0 + frag_row(e)) * N + n;
        if (j < nt && n < N) {
          if (n + 1 < N && N % 2 == 0) {
            store2(q, run[j][e], run[j][e + 1]);
          } else {
            q[0] = run[j][e];
            if (n + 1 < N) q[1] = run[j][e + 1];
          }
        }
        run[j][e] = dec * run[j][e] + acc[j][e];
        run[j][e + 1] = dec * run[j][e + 1] + acc[j][e + 1];
      }
  }
  if (bwd || !a.final || !owner) return;
  float* f = a.final + static_cast<long long>(b * a.H + h) * P * N;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = c0 + frag_col(j, e);
      if (j < nt && n < N) f[(r0 + frag_row(e)) * N + n] = run[j][e];
    }
}

// floats of a state tile [P][Np + 4]
__host__ __device__ constexpr int state_ld(int Np) { return Np + 4; }

// The 16-row blocks of a chunk a warp takes: `pair` and nb - 1 - pair, so
// that the lower triangle's work (row block rb has rb + 1 tiles) is even
// across warps.  f(rb) for each.
template <class F>
__device__ __forceinline__ void for_pair(int pair, int nb, const F& f) {
  if (pair >= (nb + 1) / 2) return;
  f(pair);
  if (nb - 1 - pair != pair) f(nb - 1 - pair);
}

// Phase 3 of the bf16 forward, one block per (b, h, chunk).  A warp takes a
// pair of 16-row blocks and, for P >= 32, one half of the P columns; bf16
// tiles through ldmatrix, S_in and M in bf16 hi + lo.
template <int P>
__global__ void __launch_bounds__(kThreads, 2) chunk_out_kernel(const SsdArgs a) {
  using T = __nv_bfloat16;
  constexpr int kHalves = P >= 32 ? 2 : 1, PH = P / kHalves, PTH = PH / 8;
  const Chunk ch(a);
  const int Lp = ch.Lp, N = a.N, Np = round16(N);
  const int ldp = padded<T>(P), ldn = padded<T>(Np), lds = state_ld(Np);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + Lp;
  float* ecum = cum + Lp;
  float* Ss = ecum + Lp;                     // P x lds
  T* Xs = reinterpret_cast<T*>(Ss + P * lds);
  T* Bs = Xs + Lp * ldp;
  T* Cs = Bs + Lp * ldn;

  load_tile(Xs, ldp,
            static_cast<const T*>(a.x) + ch.b * a.sxb + ch.t0 * a.sxt +
                ch.h * a.sxh,
            a.sxt, ch.rows, Lp, P, P);
  load_tile(Bs, ldn,
            static_cast<const T*>(a.Bm) + ch.b * a.sbb + ch.t0 * a.sbt +
                ch.grp * a.sbg,
            a.sbt, ch.rows, Lp, N, Np);
  load_tile(Cs, ldn,
            static_cast<const T*>(a.Cm) + ch.b * a.scb + ch.t0 * a.sct +
                ch.grp * a.scg,
            a.sct, ch.rows, Lp, N, Np);
  load_state(Ss, lds, a.states + ch.bhc * P * N, P, N, Np);
  const long long dt0 = ch.b * a.sdb + ch.t0 * a.sdt + ch.h * a.sdh;
  for (int r = threadIdx.x; r < Lp; r += kThreads)
    dts[r] = r < ch.rows ? load_any(a.dt, dt0 + r * a.sdt, a.dt_dtype) : 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, load_any(a.A, ch.h, a.a_dtype), cum, Lp);
  __syncthreads();
  for (int r = threadIdx.x; r < Lp; r += kThreads) ecum[r] = expf(cum[r]);
  __syncthreads();

  const float Dh = a.has_d ? load_any(a.D, ch.h, a.d_dtype) : 0.f;
  const int warp = threadIdx.x >> 5, c0 = (warp % kHalves) * PH;
  T* y = static_cast<T*>(a.y) +
         ((static_cast<long long>(ch.b) * a.T + ch.t0) * a.H + ch.h) * P;
  const long long syt = static_cast<long long>(a.H) * P;
  for_pair(warp / kHalves, Lp / 16, [&](int rb) {
    const int r0 = 16 * rb;
    const RowMajor<T> C{Cs + r0 * ldn, ldn};
    float acc[PTH][4];
    zero(acc);
    // inter: exp(cum_t) C_t . S_in
    tile_mm<true, true>(acc, PTH, Np, C, ColMajor<float>{Ss + c0 * lds, lds});
#pragma unroll
    for (int j = 0; j < PTH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= ecum[r0 + frag_row(e)];
    // intra: M = (C B^T) o L o dt_s on s <= t, times x
    for (int sb = 0; sb <= rb; ++sb) {
      const int s0 = 16 * sb;
      float t[2][4];
      zero(t);
      tile_mm<true, false>(t, 2, Np, C, ColMajor<T>{Bs + s0 * ldn, ldn});
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + frag_row(e), s = s0 + frag_col(j, e);
          t[j][e] = s <= r ? t[j][e] * expf(cum[r] - cum[s]) * dts[s] : 0.f;
        }
      tile_mm_t<true>(acc, PTH, t, nullptr, RowMajor<T>{Xs + s0 * ldp + c0, ldp});
    }
#pragma unroll
    for (int j = 0; j < PTH; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = r0 + frag_row(e), p = c0 + frag_col(j, e);
        if (r < ch.rows)
          store2(y + r * syt + p, acc[j][e] + Dh * to_f32(Xs[r * ldp + p]),
                 acc[j][e + 1] + Dh * to_f32(Xs[r * ldp + p + 1]));
      }
  });
}

// Phase 3 of the fp32 forward, one block per (b, chunk, hb heads of one
// group of B and C).  C B^T does not depend on the head: each warp takes
// its pair of 16-row blocks (for_pair) and, for P >= 32, one half of the P
// columns, makes the pair's tiles of C B^T once (TF32 with kProd products)
// and keeps them in registers (at most 9 tiles of 16 x 16) while the block
// walks its heads.  A head's x and S_in tiles come in with cp.async, two
// buffers, so the next head's land while this one's are multiplied; its
// tiles of M = (C B^T) o L o dt_s are made from the registers, each 16-
// column tile's product with x summed in its own accumulator.  fp32 tiles
// take 4 bytes an element, so the bf16 kernel's one block per (b, h, chunk)
// would reload B and C for every head and hold an SM alone with nothing to
// overlap its loads; here they are read once for hb heads.  What bounds it
// on the H100: a block's prologue (the loads and C B^T) costs several
// heads' time, and at 255 registers (the tiles of C B^T take 72) one block
// of 8 warps an SM leaves mma.sync's latency exposed.  Making each tile's
// decay once a head in shared memory, or both row blocks' inter term in
// one pass, read no faster.
template <int P, int kProd>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_out_f32_kernel(const SsdArgs a, const int hb) {
  constexpr int kHalves = P >= 32 ? 2 : 1, PH = P / kHalves, PTH = PH / 8;
  constexpr int kTiles = kMaxLc / 16 + 1;  // a pair's tiles: nb + 1
  const int nhg = a.H / hb, hg = blockIdx.x % nhg;
  const int c = (blockIdx.x / nhg) % a.nC, b = blockIdx.x / nhg / a.nC;
  const int h0 = hg * hb, grp = h0 / (a.H / a.G), t0 = c * a.Lc;
  const int rows = min(a.Lc, a.T - t0), Lp = round16(a.Lc), N = a.N;
  const int Np = round16(N), ldp = padded<float>(P), ldn = padded<float>(Np);
  const int lds = state_ld(Np);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);  // hb x Lp
  float* cum = dts + hb * Lp;                   // hb x Lp
  float* Cs = cum + hb * Lp;                    // Lp x ldn
  float* Bs = Cs + Lp * ldn;                    // Lp x ldn
  float* Xs = Bs + Lp * ldn;                    // 2 x Lp x ldp
  float* Ss = Xs + 2 * Lp * ldp;                // 2 x P x lds

  const auto load_head = [&](int i, int buf) {  // x and S_in of head h0 + i
    const int h = h0 + i;
    load_tile(Xs + buf * Lp * ldp, ldp,
              static_cast<const float*>(a.x) + b * a.sxb + t0 * a.sxt +
                  h * a.sxh,
              a.sxt, rows, Lp, P, P);
    load_state(Ss + buf * P * lds, lds,
               a.states + ((static_cast<long long>(b) * a.H + h) * a.nC + c) *
                              P * N,
               P, N, Np);
  };
  load_tile(Cs, ldn,
            static_cast<const float*>(a.Cm) + b * a.scb + t0 * a.sct +
                grp * a.scg,
            a.sct, rows, Lp, N, Np);
  load_tile(Bs, ldn,
            static_cast<const float*>(a.Bm) + b * a.sbb + t0 * a.sbt +
                grp * a.sbg,
            a.sbt, rows, Lp, N, Np);
  load_head(0, 0);
  for (int i = threadIdx.x; i < hb * Lp; i += kThreads) {
    const int k = i / Lp, r = i % Lp;
    dts[i] = r < rows ? load_any(a.dt, b * a.sdb + (t0 + r) * a.sdt +
                                           (h0 + k) * a.sdh,
                                 a.dt_dtype)
                      : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int k = warp; k < hb; k += kWarps)
    chunk_cumsum(dts + k * Lp, load_any(a.A, h0 + k, a.a_dtype),
                 cum + k * Lp, Lp);

  // the pair's tiles of C B^T: row block ra's sb = 0..ra in cb[0..na), then
  // row block rz's in cb[na..na+nz)
  const int nb = Lp / 16, pair = warp / kHalves, c0 = (warp % kHalves) * PH;
  const bool active = pair < (nb + 1) / 2;
  const int ra = pair, rz = nb - 1 - pair, na = ra + 1;
  const int nz = rz != ra ? rz + 1 : 0;
  float cb[kTiles][2][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    zero(cb[i]);
    if (active && i < na + nz)
      tf32_mm_nk<kProd>(cb[i], 2, Np, Cs + 16 * (i < na ? ra : rz) * ldn,
                        ldn, Bs + 16 * (i < na ? i : i - na) * ldn, ldn);
  }
  __syncthreads();  // the cumsums are in

  const long long syt = static_cast<long long>(a.H) * P;
  for (int i = 0; i < hb; ++i) {
    const int buf = i & 1, h = h0 + i;
    if (i + 1 < hb) load_head(i + 1, buf ^ 1);  // lands during this head
    const float* X = Xs + buf * Lp * ldp;
    const float* S = Ss + buf * P * lds;
    const float* cm = cum + i * Lp;
    const float* dd = dts + i * Lp;
    const float Dh = a.has_d ? load_any(a.D, h, a.d_dtype) : 0.f;
    float* y = static_cast<float*>(a.y) +
               ((static_cast<long long>(b) * a.T + t0) * a.H + h) * P;
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      if (!active || (z == 1 && nz == 0)) continue;
      const int r0 = 16 * (z == 0 ? ra : rz);
      float acc[PTH][4];
      zero(acc);
      // inter: exp(cum_t) C_t . S_in
      tf32_mm_nk<kProd>(acc, PTH, Np, Cs + r0 * ldn, ldn, S + c0 * lds, lds);
#pragma unroll
      for (int j = 0; j < PTH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= expf(cm[r0 + frag_row(e)]);
      // intra: M = (C B^T) o L o dt_s on s <= t, times x
#pragma unroll
      for (int k = 0; k < kTiles; ++k) {
        if (z == 0 ? k >= na : (k < na || k >= na + nz)) continue;
        const int s0 = 16 * (z == 0 ? k : k - na);
        float t[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + frag_row(e), s = s0 + frag_col(u, e);
            t[u][e] = s <= r ? cb[k][u][e] * expf(cm[r] - cm[s]) * dd[s] : 0.f;
          }
        tf32_acc_tile<kProd>(acc, PTH, t, X + s0 * ldp + c0, ldp);
      }
#pragma unroll
      for (int j = 0; j < PTH; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = r0 + frag_row(e), p = c0 + frag_col(j, e);
          if (r < rows)
            store2(y + r * syt + p, acc[j][e] + Dh * X[r * ldp + p],
                   acc[j][e + 1] + Dh * X[r * ldp + p + 1]);
        }
    }
    cp_async_wait_all();
    __syncthreads();  // the next head's tiles are in; this head's are free
  }
}

// Phase 3 of the fp32 backward, one block per (b, h, chunk), on fp32 FMAs
// (the bf16 backward's is ssd_bwd_sm90.cu).  Each warp takes a pair of
// 16-row blocks (for_pair) in a row pass and a pair of 16-column blocks in
// a column pass; the two warps of a pair split the work by columns (row
// pass) or by output (column pass).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_grad_kernel(const SsdArgs a) {
  using T = float;
  constexpr int PT = P / 8;
  const Chunk ch(a);
  const int Lp = ch.Lp, N = a.N, Np = round16(N), NT = Np / 8;
  const int ldp = padded<T>(P), ldn = padded<T>(Np), lds = state_ld(Np);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + Lp;
  float* wv = cum + Lp;       // exp(cum_last - cum_s)
  float* dcr = wv + Lp;       // dcum from the row pass, two halves: 2 x Lp
  float* dcc = dcr + 2 * Lp;  // dcum from the column pass
  float* xdx = dcc + Lp;      // x_s . dxd_s (ddt's direct term)
  float* rs = xdx + Lp;       // xd_s . dxd_s's state term
  float* red = rs + Lp;       // kWarps
  float* Ss = red + 32;                // S_in, P x lds
  float* dSs = Ss + P * lds;           // dS_out, P x lds
  float* Ws = dSs + P * lds;           // kWarps x 16 x kWs
  T* Xs = Ws + kWarps * 16 * kWs;
  T* DYs = Xs + Lp * ldp;
  T* Bs = DYs + Lp * ldp;
  T* Cs = Bs + Lp * ldn;

  const long long yoff =
      ((static_cast<long long>(ch.b) * a.T + ch.t0) * a.H + ch.h) * P;
  const long long syt = static_cast<long long>(a.H) * P;
  load_tile(Xs, ldp,
            static_cast<const T*>(a.x) + ch.b * a.sxb + ch.t0 * a.sxt +
                ch.h * a.sxh,
            a.sxt, ch.rows, Lp, P, P);
  load_tile(DYs, ldp, static_cast<const T*>(a.dy) + yoff, syt, ch.rows, Lp, P,
            P);
  load_tile(Bs, ldn,
            static_cast<const T*>(a.Bm) + ch.b * a.sbb + ch.t0 * a.sbt +
                ch.grp * a.sbg,
            a.sbt, ch.rows, Lp, N, Np);
  load_tile(Cs, ldn,
            static_cast<const T*>(a.Cm) + ch.b * a.scb + ch.t0 * a.sct +
                ch.grp * a.scg,
            a.sct, ch.rows, Lp, N, Np);
  load_state(Ss, lds, a.states + ch.bhc * P * N, P, N, Np);
  load_state(dSs, lds, a.dstates + ch.bhc * P * N, P, N, Np);
  const long long dt0 = ch.b * a.sdb + ch.t0 * a.sdt + ch.h * a.sdh;
  for (int r = threadIdx.x; r < Lp; r += kThreads) {
    dts[r] = r < ch.rows ? load_any(a.dt, dt0 + r * a.sdt, a.dt_dtype) : 0.f;
    dcr[Lp + r] = 0.f;  // the second half's share, where it has none
  }
  const float Ah = load_any(a.A, ch.h, a.a_dtype);
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, Ah, cum, Lp);
  __syncthreads();
  const float cl = cum[Lp - 1];
  for (int r = threadIdx.x; r < Lp; r += kThreads) wv[r] = expf(cl - cum[r]);
  __syncthreads();

  const float Dh = a.has_d ? load_any(a.D, ch.h, a.d_dtype) : 0.f;
  const int warp = threadIdx.x >> 5, half = warp & 1, pair = warp >> 1;
  const int nb = Lp / 16;
  float* ws = Ws + warp * 16 * kWs;
  const long long hoff =
      ((static_cast<long long>(ch.b) * a.T + ch.t0) * a.H + ch.h) * a.N;
  const long long sht = static_cast<long long>(a.H) * a.N;

  // Row pass: 16 rows t.  dC_t = exp(cum_t) dy_t S_in + sum_s dCB[t,s] B_s,
  // with dM = dy xd^T = (dy x^T) o dt_s and dCB = dM o L; dcum_t gets
  // dy_t . y_inter_t and sum_s dM[t,s] M[t,s], M = (C B^T) o L.  The two
  // warps of a pair take half of the N columns each where NT % 4 == 0 (the
  // first also takes dM M), else the first takes them all.
  const int nsplit = NT % 4 == 0 ? 2 : 1, nth = NT / nsplit, n0 = half * 8 * nth;
  if (half < nsplit) for_pair(pair, nb, [&](int rb) {
    const int r0 = 16 * rb;
    const RowMajor<T> DY{DYs + r0 * ldp, ldp};
    float acc[kNT][4];
    zero(acc);
    tile_mm<false, true>(acc, nth, P, DY, RowMajor<float>{Ss + n0, lds});
    float part[2] = {0.f, 0.f};  // this lane's share of dcum at rows g, g+8
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j < nth) {
          const int r = r0 + frag_row(e);
          acc[j][e] *= expf(cum[r]);
          part[e >> 1] += acc[j][e] * to_f32(Cs[r * ldn + n0 + frag_col(j, e)]);
        }
      }
    for (int sb = 0; sb <= rb; ++sb) {
      const int s0 = 16 * sb;
      float cb[2][4], dx[2][4];
      zero(cb);
      zero(dx);
      if (half == 0)
        tile_mm<false, false>(cb, 2, Np, RowMajor<T>{Cs + r0 * ldn, ldn},
                                    ColMajor<T>{Bs + s0 * ldn, ldn});
      tile_mm<false, false>(dx, 2, P, DY, ColMajor<T>{Xs + s0 * ldp, ldp});
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + frag_row(e), s = s0 + frag_col(j, e);
          const float L = s <= r ? expf(cum[r] - cum[s]) : 0.f;
          dx[j][e] *= dts[s] * L;                // dCB = dM o L
          part[e >> 1] += dx[j][e] * cb[j][e];  // dM M (0 in the second half)
        }
      tile_mm_t<false>(acc, nth, dx, ws, RowMajor<T>{Bs + s0 * ldn + n0, ldn});
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + frag_row(e), n = n0 + frag_col(j, e);
        if (j < nth && r < ch.rows && n < N) a.dCh[hoff + r * sht + n] = acc[j][e];
      }
    const float p0 = quad_sum(part[0]), p1 = quad_sum(part[1]);
    if ((threadIdx.x & 3) == 0) {
      dcr[half * Lp + r0 + frag_row(0)] = p0;
      dcr[half * Lp + r0 + frag_row(2)] = p1;
    }
  });

  // Column pass: 16 columns s, with tiles made transposed ([s, t]) so that
  // they serve as A operands.  The first warp of a pair: the gradient of
  // xd = dt x, dxd_s = sum_t M[t,s] dy_t + exp(cum_last - cum_s) dS_out B_s,
  // so dx and ddt's direct term; dcum_s loses sum_t dM M and the state term.
  // The second: dB_s = sum_t dCB[t,s] C_t + exp(cum_last - cum_s) dt_s x_s
  // dS_out.
  T* dxo = static_cast<T*>(a.dx) + yoff;
  for_pair(pair, nb, [&](int sb) {
    const int s0 = 16 * sb;
    const RowMajor<T> X{Xs + s0 * ldp, ldp};
    float acc[kNT > PT ? kNT : PT][4];
    zero(acc);
    float part[2] = {0.f, 0.f}, rpart[2] = {0.f, 0.f};
    if (half == 0) {
      tile_mm<false, true>(acc, PT, Np, RowMajor<T>{Bs + s0 * ldn, ldn},
                                 ColMajor<float>{dSs, lds});
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + frag_row(e);
          acc[j][e] *= wv[s];
          rpart[e >> 1] += acc[j][e] * dts[s] * X(frag_row(e), frag_col(j, e));
        }
    } else {
      tile_mm<false, true>(acc, NT, P, X, RowMajor<float>{dSs, lds});
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] *= wv[s0 + frag_row(e)] * dts[s0 + frag_row(e)];
    }
    for (int tb = sb; tb < nb; ++tb) {
      const int t0 = 16 * tb;
      float cb[2][4], dx[2][4];
      zero(cb);
      zero(dx);
      if (half == 0)
        tile_mm<false, false>(cb, 2, Np, RowMajor<T>{Bs + s0 * ldn, ldn},
                                    ColMajor<T>{Cs + t0 * ldn, ldn});
      tile_mm<false, false>(dx, 2, P, X, ColMajor<T>{DYs + t0 * ldp, ldp});
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + frag_row(e), t = t0 + frag_col(j, e);
          const float L = s <= t ? expf(cum[t] - cum[s]) : 0.f;
          dx[j][e] *= dts[s] * L;                // dCB^T
          part[e >> 1] -= dx[j][e] * cb[j][e];  // dM M
          cb[j][e] *= L;                         // M^T
        }
      if (half == 0)
        tile_mm_t<false>(acc, PT, cb, ws, RowMajor<T>{DYs + t0 * ldp, ldp});
      else
        tile_mm_t<false>(acc, NT, dx, ws, RowMajor<T>{Cs + t0 * ldn, ldn});
    }
    if (half == 0) {
      float xpart[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + frag_row(e), p = frag_col(j, e);
          xpart[e >> 1] += X(frag_row(e), p) * acc[j][e];
          if (s < ch.rows && (e & 1) == 0)
            store2(dxo + s * syt + p,
                   dts[s] * acc[j][e] + Dh * to_f32(DYs[s * ldp + p]),
                   dts[s] * acc[j][e + 1] + Dh * to_f32(DYs[s * ldp + p + 1]));
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x1 = quad_sum(xpart[i]), r1 = quad_sum(rpart[i]);
        const float p1 = quad_sum(part[i]);
        if ((threadIdx.x & 3) == 0) {
          const int s = s0 + frag_row(2 * i);
          xdx[s] = x1;
          rs[s] = r1;
          dcc[s] = p1 - r1;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + frag_row(e), n = frag_col(j, e);
          if (j < NT && s < ch.rows && n < N) a.dBh[hoff + s * sht + n] = acc[j][e];
        }
    }
  });
  __syncthreads();

  // dcum, its reverse cumsum da, then ddt = A da + x . dxd, dA = sum dt da
  float rsum = 0.f, dd = 0.f, sds = 0.f;  // sds: <S_in, dS_out>
  for (int r = threadIdx.x; r < Lp; r += kThreads) rsum += rs[r];
  for (int i = threadIdx.x; i < P * Np; i += kThreads)
    sds = fmaf(Ss[(i / Np) * lds + i % Np], dSs[(i / Np) * lds + i % Np], sds);
  for (int i = threadIdx.x; i < Lp * P; i += kThreads)
    dd = fmaf(to_f32(DYs[(i / P) * ldp + i % P]), to_f32(Xs[(i / P) * ldp + i % P]), dd);
  rsum = block_sum(rsum, red);
  sds = block_sum(sds, red);
  dd = block_sum(dd, red);
  for (int r = threadIdx.x; r < Lp; r += kThreads)
    dcr[r] += dcr[Lp + r] + dcc[r] + (r == Lp - 1 ? rsum + expf(cl) * sds : 0.f);
  __syncthreads();
  if (threadIdx.x < 32) chunk_rcumsum(dcr, dcc, Lp);  // da into dcc
  __syncthreads();
  float da = 0.f;
  float* ddt = a.ddt + (static_cast<long long>(ch.b) * a.T + ch.t0) * a.H + ch.h;
  for (int r = threadIdx.x; r < Lp; r += kThreads) {
    da = fmaf(dts[r], dcc[r], da);
    if (r < ch.rows) ddt[static_cast<long long>(r) * a.H] = Ah * dcc[r] + xdx[r];
  }
  da = block_sum(da, red);
  if (threadIdx.x == 0) {
    const long long k = static_cast<long long>(ch.h) * a.B * a.nC +
                        static_cast<long long>(ch.b) * a.nC + ch.c;
    a.dA_part[k] = da;
    a.dD_part[k] = dd;
  }
}

// Phase 4 of the backward: dB and dC summed over the partials of a group
// (one a head in fp32, one a block of `bwd_heads` heads in bf16), dA and
// dD over batches and chunks, each in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads) group_sum_kernel(const SsdArgs a) {
  const long long E = static_cast<long long>(a.B) * a.T * a.G * a.N;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int parts = a.H / a.bwd_heads, rep = parts / a.G;
  if (i < E) {
    const int n = static_cast<int>(i % a.N);
    const long long bt = i / a.N / a.G;
    const int grp = static_cast<int>((i / a.N) % a.G);
    const long long base =
        (bt * parts + static_cast<long long>(grp) * rep) * a.N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += a.dBh[base + r * a.N];
      sc += a.dCh[base + r * a.N];
    }
    static_cast<T*>(a.dB)[i] = from_f32<T>(sb);
    static_cast<T*>(a.dC)[i] = from_f32<T>(sc);
  } else if (i < E + a.H) {
    const int h = static_cast<int>(i - E), m = a.B * a.nC;
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < m; ++k) {
      sa += a.dA_part[static_cast<long long>(h) * m + k];
      sd += a.dD_part[static_cast<long long>(h) * m + k];
    }
    a.dA[h] = sa;
    if (a.has_d) a.dD[h] = sd;
  }
}

// bytes of dynamic shared memory of each kernel
// (bf16: x's hi and lo tiles, B; fp32: x, B)
template <typename T>
size_t scan_smem(const SsdArgs& a, int P) {
  const int Lp = round16(a.Lc), Np = round16(a.N), nu = sizeof(T) == 2 ? 2 : 1;
  return 3 * Lp * sizeof(float) +
         static_cast<size_t>(Lp) * (nu * padded<T>(P) + padded<T>(Np)) * sizeof(T);
}
size_t out_smem(const SsdArgs& a, int P) {
  using T = __nv_bfloat16;
  const int Lp = round16(a.Lc), Np = round16(a.N);
  return (3 * Lp + P * state_ld(Np)) * sizeof(float) +
         static_cast<size_t>(Lp) * (padded<T>(P) + 2 * padded<T>(Np)) * sizeof(T);
}
// heads of one group a block of chunk_out_f32_kernel: 16, or the largest
// power of two below that divides a group's.  A block makes C B^T once and
// then walks its heads, so at zamba2's layer shape (256 blocks) 16 heads a
// block read faster than 8, and 8 than 4.
int f32_heads(const SsdArgs& a) {
  int hb = 16;
  while ((a.H / a.G) % hb) hb /= 2;
  return hb;
}
size_t out_f32_smem(const SsdArgs& a, int P, int hb) {
  const int Lp = round16(a.Lc), Np = round16(a.N);
  return (2 * hb * Lp + 2 * Lp * padded<float>(Np) +
          2 * Lp * padded<float>(P) + 2 * P * state_ld(Np)) *
         sizeof(float);
}
size_t grad_smem(const SsdArgs& a, int P) {
  using T = float;
  const int Lp = round16(a.Lc), Np = round16(a.N);
  return (8 * Lp + 32 + 2 * P * state_ld(Np) + kWarps * 16 * kWs) *
             sizeof(float) +
         2 * static_cast<size_t>(Lp) * (padded<T>(P) + padded<T>(Np)) * sizeof(T);
}

// dynamic shared memory up to `smem` and the largest carveout, then the
// launch
template <typename... Args>
cudaError_t launch(void (*kernel)(Args...), unsigned grid, size_t smem,
                   cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// phases 1-2, forward (states) or backward (dstates)
template <typename T, int P, int kProd>
cudaError_t run_scan(const SsdArgs& a, int bwd, cudaStream_t s) {
  return launch(chunk_scan_kernel<T, P, kProd>,
                static_cast<unsigned>(a.B) * a.H, scan_smem<T>(a, P), s, a,
                bwd);
}

template <typename T, int P, int kProd>
cudaError_t run_fwd(const SsdArgs& a, cudaStream_t s) {
  cudaError_t e = run_scan<T, P, kProd>(a, 0, s);
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same_v<T, float>) {
    const int hb = f32_heads(a);
    return launch(chunk_out_f32_kernel<P, kProd>,
                  static_cast<unsigned>(a.B) * a.nC * (a.H / hb),
                  out_f32_smem(a, P, hb), s, a, hb);
  } else {
    return launch(chunk_out_kernel<P>, static_cast<unsigned>(a.B) * a.H * a.nC,
                  out_smem(a, P), s, a);
  }
}

// the state scans, the chunk gradients (bf16 on ssd_bwd_sm90.cu's wgmma
// kernel, fp32 on chunk_grad_kernel's FMAs), then the group sums
template <typename T, int P>
cudaError_t run_bwd(const SsdArgs& a, cudaStream_t s) {
  cudaError_t e;
  if (a.recompute && (e = run_scan<T, P, 3>(a, 0, s)) != cudaSuccess) return e;
  if ((e = run_scan<T, P, 3>(a, 1, s)) != cudaSuccess) return e;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    e = ssd_bf16_chunk_grads(a, s);
  } else {
    e = a.bwd_heads == 1
            ? launch(chunk_grad_kernel<P>,
                     static_cast<unsigned>(a.B) * a.H * a.nC,
                     grad_smem(a, P), s, a)
            : cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const long long n = static_cast<long long>(a.B) * a.T * a.G * a.N + a.H;
  group_sum_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// f(std::integral_constant<int, P>) at P = a.P: one instantiation a head dim
template <class F>
cudaError_t with_p(int p, const F& f) {
  switch (p) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

bool valid(const SsdArgs* a) {
  return a && a->B > 0 && a->T > 0 && a->H > 0 && a->G > 0 && a->H % a->G == 0 &&
         a->N > 0 && a->N <= kMaxN && a->Lc > 0 && a->Lc <= kMaxLc &&
         a->nC == (a->T + a->Lc - 1) / a->Lc && (!a->has_d || a->D);
}

}  // namespace

// The chunk-parallel forward (phases 1-3) of bf16 or fp32 inputs (B and C
// alike): y, the state entering each chunk in `states` (kept for the
// backward) and, where `final` is given, the state leaving the last chunk.
// fp32 takes `tf32_products` (3; 1 is the planted fault) a product.
// Launches on `stream`, allocates nothing; returns cudaGetLastError()
// (cudaErrorInvalidValue for an input it does not take).
extern "C" int ssd_chunked_fwd(const SsdArgs* a, void* stream) {
  if (!valid(a)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_p(a->P, [&](auto p) -> cudaError_t {
    constexpr int P = decltype(p)::value;
    if (a->x_dtype == repro::kBF16) return run_fwd<__nv_bfloat16, P, 3>(*a, s);
    if (a->x_dtype != repro::kF32) return cudaErrorInvalidValue;
    if (a->tf32_products == 3) return run_fwd<float, P, 3>(*a, s);
    if (a->tf32_products == 1) return run_fwd<float, P, 1>(*a, s);
    return cudaErrorInvalidValue;
  });
}

// The backward: dx, ddt, dA, dB, dC and dD (dD when has_d) from dy, with
// the forward's `states`, or phases 1-2 run first when `recompute`.
// fp32 or bf16 x (B, C and dy alike).  Same contract as ssd_chunked_fwd.
extern "C" int ssd_chunked_bwd(const SsdArgs* a, void* stream) {
  if (!valid(a)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_p(a->P, [&](auto p) -> cudaError_t {
    constexpr int P = decltype(p)::value;
    if (a->x_dtype == repro::kF32) return run_bwd<float, P>(*a, s);
    if (a->x_dtype == repro::kBF16) return run_bwd<__nv_bfloat16, P>(*a, s);
    return cudaErrorInvalidValue;
  });
}
