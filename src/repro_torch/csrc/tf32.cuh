// TF32 tensor-core products with fp32 accuracy (3xTF32), shared by the fp32
// routes of flash_attention.cu and ssd_sm90.cu.
//
// One TF32 product keeps 11 bits of each operand and misses fp32
// tolerances.  Every fp32 operand x is split into hi + lo, two TF32 values,
// and each product is taken as hi*hi + hi*lo + lo*hi (the lo*lo term is
// below fp32 rounding).  `P` = 1 keeps only hi*hi; it exists as a planted
// fault that the checks must reject.  mma.sync m16n8k8 with fp32
// accumulators.  The tensor cores' fp32 sums truncate, so a caller sums a
// long reduction in short parts, each in its own accumulator, and adds the
// parts with round to nearest.
//
// Three splits.  `split` rounds hi and lo to nearest (cvt.rna), ~21 bits.
// `split_rz` takes hi as x's top 10 mantissa bits (a mask, exact) and lo =
// x - hi (exact in fp32) as it is: the tensor cores read a TF32 operand's
// top 10 mantissa bits, so lo is rounded toward zero there, ~20 bits.  It
// costs a logic op and an add where `split` costs two conversions and an
// add; conversions issue at a quarter of the fp32 rate, and a kernel that
// splits an operand at every use is bound by them.  Its lo has x's sign,
// so that truncation shrinks every operand: a bias that a long sum
// accumulates.  `split_rn` rounds hi to nearest with an integer add before
// the mask (cvt.rna's rounding) and leaves lo as `split_rz` does: lo then
// takes either sign and the truncation errors cancel, for one more
// integer op.
#pragma once

#include <cstdint>

namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each rounded to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo, hi x's top 10 mantissa bits, lo the rest
__device__ __forceinline__ void split_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x = hi + lo, hi x rounded to the nearest TF32 (ties away, as cvt.rna) by
// an integer add and a mask, lo = x - hi (exact) as it is
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in `P` TF32 products: the small terms first, then hi * hi.
// a is split already; b0, b1 are the lane's two B values (rows t and t + 4
// of the k-step, column g), split by `split` or, with kRz, `split_rz`.
template <int P, bool kRz = false>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  static_assert(P == 1 || P == 3, "one or three TF32 products");
  uint32_t bh0, bl0, bh1, bl1;
  if constexpr (kRz) {
    split_rz(b0, bh0, bl0);
    split_rz(b1, bh1, bl1);
  } else {
    split(b0, bh0, bl0);
    split(b1, bh1, bl1);
  }
  if constexpr (P == 3) {
    mma(d, al, bh0, bh1);
    mma(d, ah, bl0, bl1);
  }
  mma(d, ah, bh0, bh1);
}

// d += a * b in `P` TF32 products, both operands split already (b: the
// lane's two B values' hi and lo).
template <int P>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bl0, uint32_t bh1,
                                     uint32_t bl1) {
  static_assert(P == 1 || P == 3, "one or three TF32 products");
  if constexpr (P == 3) {
    mma(d, al, bh0, bh1);
    mma(d, ah, bl0, bl1);
  }
  mma(d, ah, bh0, bh1);
}

}  // namespace tf32
