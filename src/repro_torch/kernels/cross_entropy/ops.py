"""Cross-entropy op: a CUDA tensor goes to the hand-written kernels
(`csrc/cross_entropy.cu`: `xent_fwd`, `xent_bwd`), a CPU tensor to the
plain version (`ref.py`).

`xent(logits, targets)` is one `torch.autograd.Function`: its forward
returns the per-row loss and saves (logits, targets, lse); its backward
writes dlogits into a new buffer in the logits' dtype.  There is no
fallback: a CUDA input the kernels do not take, a failed build or a failed
launch raises.  `fwd_launches` / `bwd_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cross_entropy import ref

fwd_launches = 0
bwd_launches = 0

_CODES = {torch.float32: build.F32, torch.bfloat16: build.BF16}
_TARGETS = {torch.int32: 0, torch.int64: 1}


def xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (R, V) fp32/bf16, targets (R,) int -> per-row loss (R,) fp32,
    differentiable in the logits."""
    return _Xent.apply(logits, targets)


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        if logits.device.type == "cpu":
            loss, lse = ref.xent(logits, targets)
        else:
            loss, lse = xent_fwd_cuda(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if logits.device.type == "cpu":
            return ref.dlogits(logits, targets, lse, g), None
        return xent_bwd_cuda(logits, targets, lse, g), None


@functools.cache
def _kernels():
    lib = build.library().cdll
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.xent_fwd.argtypes = [p, p, p, p, ll, ll, i, i, p]
    lib.xent_bwd.argtypes = [p, p, p, p, p, ll, ll, i, i, p]
    lib.xent_fwd.restype = lib.xent_bwd.restype = i
    return lib.xent_fwd, lib.xent_bwd


def _check(logits, targets, what):
    if logits.device.type != "cuda" or targets.device != logits.device:
        raise ValueError(f"{what}: logits on {logits.device}, targets on "
                         f"{targets.device}; both must be on one CUDA device")
    if logits.dtype not in _CODES or targets.dtype not in _TARGETS:
        raise TypeError(f"{what}: logits {logits.dtype} (float32/bfloat16), "
                        f"targets {targets.dtype} (int32/int64)")
    if (logits.dim() != 2 or targets.shape != logits.shape[:1]
            or not logits.is_contiguous() or not targets.is_contiguous()
            or logits.numel() == 0):
        raise ValueError(f"{what}: logits {tuple(logits.shape)} must be a "
                         f"non-empty contiguous (R, V), targets "
                         f"{tuple(targets.shape)} a contiguous (R,)")


def xent_fwd_cuda(logits, targets):
    """(loss (R,), lse (R,)) fp32 from one launch of `xent_fwd`."""
    global fwd_launches
    _check(logits, targets, "xent_fwd kernel")
    R, V = logits.shape
    loss = torch.empty(R, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    rc = _kernels()[0](logits.data_ptr(), targets.data_ptr(),
                       loss.data_ptr(), lse.data_ptr(), R, V,
                       _CODES[logits.dtype], _TARGETS[targets.dtype],
                       build.stream_ptr(logits.device))
    build.check(rc, "xent_fwd")
    fwd_launches += 1
    return loss, lse


def xent_bwd_cuda(logits, targets, lse, g):
    """dlogits (R, V) in the logits' dtype from one launch of `xent_bwd`."""
    global bwd_launches
    _check(logits, targets, "xent_bwd kernel")
    R = logits.shape[0]
    for name, a in (("lse", lse), ("g", g)):
        if (a.device != logits.device or a.dtype != torch.float32
                or a.shape != (R,) or not a.is_contiguous()):
            raise ValueError(f"xent_bwd kernel: {name} must be a contiguous "
                             f"fp32 ({R},) on {logits.device}")
    dx = torch.empty_like(logits)
    rc = _kernels()[1](logits.data_ptr(), targets.data_ptr(), lse.data_ptr(),
                       g.data_ptr(), dx.data_ptr(), R, logits.shape[1],
                       _CODES[logits.dtype], _TARGETS[targets.dtype],
                       build.stream_ptr(logits.device))
    build.check(rc, "xent_bwd")
    bwd_launches += 1
    return dx
