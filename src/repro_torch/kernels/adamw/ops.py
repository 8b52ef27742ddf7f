"""AdamW op: a CUDA tensor goes to the hand-written kernel
(`csrc/adamw.cu`: `adamw_flat`), a CPU tensor to the plain version
(`ref.py`).  Both update p, m and v IN PLACE (the reference returns new
arrays and donates the old ones; in place saves the same memory without
a donation mechanism).

lr, t (the 1-based step) and the clip scale are device scalars, so the
update never syncs with the host.  There is no fallback: a CUDA input the
kernel does not take, a failed build or a failed launch raises.
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adamw import ref

launches = 0


def adamw_update(p, g, m, v, *, lr, t, scale, b1, b2, eps, wd) -> None:
    """One AdamW step on flat fp32 tensors, in place.  lr/scale: fp32
    scalar tensors; t: int32 scalar tensor, all on p's device."""
    if p.device.type == "cpu":
        for dst, src in zip((p, m, v), ref.adamw_update(
                p, g, m, v, lr=lr, t=t, scale=scale, b1=b1, b2=b2, eps=eps,
                wd=wd)):
            dst.copy_(src)
        return
    adamw_cuda(p, g, m, v, lr=lr, t=t, scale=scale, b1=b1, b2=b2, eps=eps,
               wd=wd)


@functools.cache
def _kernel():
    fn = build.library().cdll.adamw_flat
    p, f = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = ([p] * 4 + [ctypes.c_longlong] + [p] * 3 + [f] * 6
                   + [ctypes.c_int, p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def adamw_cuda(p, g, m, v, *, lr, t, scale, b1, b2, eps, wd) -> None:
    global launches
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"adamw kernel: p on {dev}; needs a CUDA tensor")
    for name, a in (("p", p), ("g", g), ("m", m), ("v", v)):
        if (a.device != dev or a.dtype != torch.float32
                or a.shape != p.shape or not a.is_contiguous()):
            raise ValueError(f"adamw kernel: {name} {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}; p/g/m/v must "
                             "be contiguous fp32 of one shape on one device")
    for name, a, dt in (("lr", lr, torch.float32), ("t", t, torch.int32),
                        ("scale", scale, torch.float32)):
        if a.device != dev or a.dtype != dt or a.numel() != 1:
            raise ValueError(f"adamw kernel: {name} must be a {dt} scalar "
                             f"on {dev}, got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    if p.numel() == 0:
        return
    rc = _kernel()(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                   p.numel(), lr.data_ptr(), t.data_ptr(), scale.data_ptr(),
                   b1, 1 - b1, b2, 1 - b2, eps, wd,
                   _sms(dev.index if dev.index is not None
                        else torch.cuda.current_device()),
                   build.stream_ptr(dev))
    build.check(rc, "adamw_flat")
    launches += 1
