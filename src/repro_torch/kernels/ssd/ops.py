"""Mamba-2 SSD op: a CUDA tensor goes to the hand-written chunk-scan
kernel (`csrc/ssd.cu`), a CPU tensor to the plain version (`ref.py`).

The kernel reads the model's layout directly: x (B,T,H,P), dt (B,T,H),
Bm/Cm (B,T,G,N) through their strides (so the B and C halves of one packed
projection need no copy), head h reads group h // (H // G) by index (no
repeat of B and C over the heads), and the ragged last chunk is masked on
the true T (no padding copy).  It returns y only, with the D skip fused:
the stateless training entry of the reference's `ops.ssd`.

`ssd` is a `torch.autograd.Function`.  Its backward recomputes the plain
chunk scan in torch and differentiates it, as the reference's custom VJP
does with `ref.ssd_chunked` (`repro/kernels/ssd/ops.py` `_vjp_bwd`).
There is no fallback: a CUDA input that the kernel does not take, a failed
build or a failed launch raises.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

launches = 0

CHUNK = 128
HEAD_DIMS = (16, 32, 64)      # P: one kernel instantiation each
MAX_STATE = 64                # N
MAX_CHUNK = 128               # Lc
_CODES = {torch.float32: build.F32, torch.bfloat16: build.BF16}


def ssd(x, dt, A, Bm, Cm, D=None, chunk: int = CHUNK):
    """Same contract as `ref.ssd_chunked` without a state: y only."""
    return _Ssd.apply(x, dt, A, Bm, Cm, D, chunk)


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)[0]
        return ssd_cuda(x, dt, A, Bm, Cm, D, chunk)

    @staticmethod
    def backward(ctx, ct):
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors,
                                      ctx.needs_input_grad)]
            y = ref.ssd_chunked(*ins, chunk=ctx.chunk)[0]
            want = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(y, want, ct))
        return (*(next(got) if t is not None and t.requires_grad else None
                  for t in ins), None)


@functools.cache
def _kernel():
    fn = build.library().cdll.ssd_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [i] * 8 + [ll] * 12 + [i] * 4 + [p]
    fn.restype = i
    return fn


def ssd_cuda(x, dt, A, Bm, Cm, D=None, chunk: int = CHUNK):
    """The kernel's launch: y (B,T,H,P) in x's dtype, contiguous."""
    global launches
    ts = [x, dt, A, Bm, Cm] + ([] if D is None else [D])
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("ssd kernel: every input must be on one CUDA device")
    if (x.dtype not in _CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype
            or any(t.dtype not in _CODES for t in ts)):
        raise TypeError(
            f"ssd kernel: x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}, dt "
            f"{dt.dtype}, A {A.dtype}, D {None if D is None else D.dtype}: "
            "x, Bm, Cm must share one of float32/bfloat16 and dt, A, D be "
            "float32 or bfloat16")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd kernel: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Lc = min(chunk, T)
    if (tuple(dt.shape) != (Bsz, T, H) or tuple(Bm.shape[:2]) != (Bsz, T)
            or tuple(A.shape) != (H,)
            or (D is not None and tuple(D.shape) != (H,))):
        raise ValueError(
            f"ssd kernel: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, D "
            f"{None if D is None else tuple(D.shape)} do not line up")
    if (P not in HEAD_DIMS or not 0 < N <= MAX_STATE or G == 0 or H % G
            or not 0 < Lc <= MAX_CHUNK):
        raise ValueError(
            f"ssd kernel: P {P} not in {HEAD_DIMS}, N {N} > {MAX_STATE}, "
            f"H {H} % G {G}, or chunk {Lc} not in 1..{MAX_CHUNK}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)) or not (
            A.is_contiguous() and (D is None or D.is_contiguous())):
        raise ValueError("ssd kernel: x, Bm, Cm need a unit stride on their "
                         "last dim, A and D must be contiguous")
    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), 0 if D is None else D.data_ptr(), y.data_ptr(),
        Bsz, T, H, P, G, N, Lc, int(D is not None),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        _CODES[x.dtype], _CODES[dt.dtype], _CODES[A.dtype],
        _CODES[D.dtype] if D is not None else build.F32,
        build.stream_ptr(x.device))
    build.check(rc, "ssd_fwd")
    launches += 1
    return y
