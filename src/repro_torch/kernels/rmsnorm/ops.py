"""RMSNorm op: a CUDA tensor goes to the hand-written kernel
(`csrc/rmsnorm.cu`), a CPU tensor to the plain version (`ref.py`).

`rmsnorm` is a `torch.autograd.Function`: the forward is the kernel (or
the plain version on the CPU), the backward differentiates the plain
version in torch, as the reference's custom VJP does
(`repro/kernels/rmsnorm/ops.py`, `_bwd`).  There is no fallback: a CUDA
input that the kernel does not take, a failed build or a failed launch
raises.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import ref

launches = 0

_CODES = {torch.float32: build.F32, torch.bfloat16: build.BF16}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            unit_offset: bool = False) -> torch.Tensor:
    """Row-wise RMSNorm over the last dim; output in x's dtype."""
    return _RmsNorm.apply(x, w, eps, unit_offset)


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, unit_offset):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.unit_offset = eps, unit_offset
        if x.device.type == "cpu":
            return ref.rmsnorm(x, w, eps=eps, unit_offset=unit_offset)
        return rmsnorm_cuda(x, w, eps, unit_offset)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            ww = w.detach().requires_grad_()
            y = ref.rmsnorm(xx, ww, eps=ctx.eps, unit_offset=ctx.unit_offset)
            dx, dw = torch.autograd.grad(y, (xx, ww), ct)
        return dx, dw, None, None


@functools.cache
def _kernel():
    fn = build.library().cdll.rmsnorm_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, i, p]
    fn.restype = i
    return fn


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float,
                 unit_offset: bool) -> torch.Tensor:
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel: x on {x.device}, w on {w.device}; "
                         "both must be on one CUDA device")
    if x.dtype not in _CODES or w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rmsnorm kernel: x {x.dtype}, w {w.dtype}; x must be "
                        "float32/bfloat16 and w float32 or x's dtype")
    d = x.shape[-1]
    if w.shape != (d,) or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"rmsnorm kernel: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be contiguous with w (D,)")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    rc = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, eps,
                   int(unit_offset), _CODES[x.dtype], _CODES[w.dtype],
                   build.stream_ptr(x.device))
    build.check(rc, "rmsnorm_fwd")
    launches += 1
    return y
