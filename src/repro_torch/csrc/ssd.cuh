// The C interface of the Mamba-2 SSD kernels (ssd_sm90.cu: the forward of
// both dtypes, the backward's state scans and the fp32 chunk gradients;
// ssd_bwd_sm90.cu: the bf16 chunk gradients), shared by both sources.
#pragma once

#include <cuda_runtime.h>

// The C interface's arguments, one struct (kernels/ssd/ops.py `_Args`
// mirrors it field for field).
struct SsdArgs {
  const void* x;      // (B,T,H,P) strided, x_dtype
  const void* dt;     // (B,T,H) strided, dt_dtype
  const void* A;      // (H,)
  const void* Bm;     // (B,T,G,N) strided, x_dtype
  const void* Cm;     // (B,T,G,N) strided, x_dtype
  const void* D;      // (H,) or null
  const void* dy;     // (B,T,H,P) contiguous, x_dtype (backward)
  void* y;            // (B,T,H,P) contiguous, x_dtype (forward)
  float* states;      // (B,H,nC,P,N): the state entering each chunk
  float* final;       // (B,H,P,N) or null: the state leaving the last chunk
  float* dstates;     // (B,H,nC,P,N): the gradient of the state leaving it
  void* dx;           // (B,T,H,P) contiguous, x_dtype
  float* ddt;         // (B,T,H) contiguous
  float* dBh;         // (B,T,H/bwd_heads,N): partials of dB over head blocks
  float* dCh;         // (B,T,H/bwd_heads,N): partials of dC
  void* dB;           // (B,T,G,N) contiguous, x_dtype
  void* dC;           // (B,T,G,N) contiguous, x_dtype
  float* dA_part;     // (H, B*nC): per-chunk partials of dA
  float* dD_part;     // (H, B*nC): per-chunk partials of dD
  float* dA;          // (H,)
  float* dD;          // (H,)
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg;
  int B, T, H, P, G, N, Lc, nC, has_d, recompute;
  int x_dtype, dt_dtype, a_dtype, d_dtype;
  int tf32_products;  // fp32 forward: 3, or 1 (a planted fault)
  int bwd_heads;      // backward: heads a partial of dB / dC (fp32 1; bf16
                      // the heads of one group a block)
  int bf16_parts;     // bf16 backward: 2, or 1 (a planted fault: M and dCB
                      // in one bf16 part)
};

// The bf16 backward's chunk gradients (ssd_bwd_sm90.cu): one launch on
// `stream`, after the state scans and before the group sums.
cudaError_t ssd_bf16_chunk_grads(const SsdArgs& a, cudaStream_t stream);
