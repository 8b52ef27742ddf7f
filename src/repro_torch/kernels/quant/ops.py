"""Quantize / dequantize ops of the wire codec (port of
`repro.kernels.quant.ops`): a CUDA tensor goes to the hand-written kernels
(`csrc/quant.cu`: `quant_fwd`, `dequant_fwd`), a CPU tensor to the plain
version (`ref.py`).  The two are equal bit for bit.

`roundtrip` is the entry the collectives and the error-feedback hop use:
encode the flat buffer to the wire codec and decode it back, which equals
sending the quantized payload (dequantization commutes with the all-gather
and with a reduce that sums each contribution quantized once).  The op is
not differentiable: it runs only inside the collectives' hand-written
forward and backward and the optimizer.

RTN is one launch.  SR is two and needs no host step: a seed pass writes
per-block partial sums of the buffer's f32 bits, and the quant kernel forms
the seed (their wraparound u32 sum, | 1) itself; it can write the seed it
used to a device scalar, which the checks hold against `ref.buffer_seed`.

There is no fallback: a CUDA input the kernels do not take, a failed build
or a failed launch raises.  `quant_launches` / `dequant_launches` count
calls that launch (an SR call's two launches count once).

`encode_kv` / `decode_kv` are the serving KV cache's codec (the paged arena
and the dense cache store wire values + per-128-chunk scales): on a CUDA
tensor they are one RTN quant launch and one dequant launch over the
(rows, QCHUNK) view of the head vectors, zero-padded to whole QCHUNK
groups when head_dim is not a multiple of QCHUNK.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant import ref

QCHUNK = ref.QCHUNK

quant_launches = 0
dequant_launches = 0

_DTYPES = {torch.float32: build.F32, torch.bfloat16: build.BF16}
_CODECS = {"fp8": 0, "int8": 1}
# inputs index the hash as u32 and the plain version as int64 products
MAX_ELEMS = (1 << 31) - 1


def roundtrip(x: torch.Tensor, codec: str | None,
              stochastic: bool = False,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """x through the wire codec and back, in x's shape and dtype (x itself
    when codec is None), written into `out` when given (contiguous, x's
    shape and dtype; it may be x itself)."""
    if codec is None:
        return x
    if x.device.type == "cpu":
        y = ref.roundtrip(x, codec, stochastic)
        return y if out is None else out.copy_(y)
    q, s = quantize_cuda(x, codec, stochastic)
    return dequantize_cuda(q, s, x.numel(), x.shape, x.dtype, out=out)


# ---------------------------------------------------------------------------
# KV-cache codec (port of the reference's `encode_kv` / `decode_kv`)
# ---------------------------------------------------------------------------
kv_chunks = ref.kv_chunks


def kv_wire_dtype(codec: str) -> torch.dtype:
    return ref.WIRE_DTYPE[codec]


def encode_kv(x: torch.Tensor, codec: str):
    """x: (..., hd) -> (wire values (..., hd), f32 scales (..., nc)), RTN.
    Equal bit for bit on both routes: the quant kernel on a CUDA tensor,
    `ref.encode_kv` on a CPU one."""
    if x.device.type == "cpu":
        return ref.encode_kv(x, codec)
    hd, nc = x.shape[-1], kv_chunks(x.shape[-1])
    x2 = ref.kv_pad(x).contiguous()
    q, s = quantize_cuda(x2, codec, stochastic=False)
    q = q.reshape(*x.shape[:-1], nc * QCHUNK)
    return q[..., :hd] if nc * QCHUNK != hd else q, \
        s.reshape(*x.shape[:-1], nc)


def decode_kv(q: torch.Tensor, scales: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `encode_kv` back to `dtype`: the dequant kernel on a CUDA
    tensor, `ref.decode_kv` on a CPU one."""
    if q.device.type == "cpu":
        return ref.decode_kv(q, scales, dtype)
    hd, nc = q.shape[-1], kv_chunks(q.shape[-1])
    # fp8 is padded through a byte view (0x00 is +0.0 in e4m3)
    raw = q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q
    q2 = ref.kv_pad(raw).contiguous().view(q.dtype)
    out = dequantize_cuda(q2.reshape(-1, QCHUNK), scales.reshape(-1, 1),
                          q2.numel(), q2.shape, dtype)
    return out[..., :hd] if nc * QCHUNK != hd else out


@functools.cache
def _fns():
    lib = build.library().cdll
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.quant_sr_plan.argtypes = [i, i, p, p]
    lib.quant_fwd.argtypes = [p, i, ll, i, i, f, f, p, p, p, i, p, i, p]
    lib.dequant_fwd.argtypes = [p, p, i, ll, p, i, i, p]
    for fn in (lib.quant_sr_plan, lib.quant_fwd, lib.dequant_fwd):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.cache
def _sr_plan(index: int, dtype: torch.dtype) -> tuple[int, int]:
    """(most blocks, elements one pass of its grid covers) of the SR seed
    pass on device `index`: fixed by the device's SM count."""
    blocks, elems = ctypes.c_int(), ctypes.c_longlong()
    build.check(_fns().quant_sr_plan(
        _DTYPES[dtype], _sms(index), ctypes.byref(blocks),
        ctypes.byref(elems)), "quant_sr_plan")
    return blocks.value, elems.value


def sr_seed_pass(dtype: torch.dtype,
                 device: torch.device | str = "cuda") -> int:
    """Elements of x that one pass of the SR seed kernel's grid covers (its
    loop's edge)."""
    return _sr_plan(_index(torch.device(device)), dtype)[1]


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: input on {x.device}; needs a CUDA tensor")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{what}: input {x.dtype} contiguous="
                         f"{x.is_contiguous()}; the kernel takes contiguous "
                         "float32 or bfloat16")
    if x.numel() > MAX_ELEMS:
        raise ValueError(f"{what}: {x.numel()} elements; at most "
                         f"{MAX_ELEMS}")


def quantize_cuda(x: torch.Tensor, codec: str, stochastic: bool,
                  seed_out: torch.Tensor | None = None):
    """The quant kernel: (q (m, QCHUNK), scales (m, 1) f32) of x.  Under SR,
    `seed_out` (one int32 on x's device), when given, receives the u32 bits
    of the seed the launch used (| 1)."""
    global quant_launches
    _check_input(x, "quant kernel")
    if codec not in _CODECS:
        raise ValueError(f"unknown codec {codec!r}; one of {ref.CODECS}")
    if seed_out is not None and (
            not stochastic or seed_out.device != x.device
            or seed_out.dtype != torch.int32 or seed_out.numel() != 1):
        raise ValueError("quant kernel: seed_out is one int32 on x's device,"
                         " for SR")
    n = x.numel()
    m = math.ceil(n / QCHUNK)
    q = torch.empty((m, QCHUNK), dtype=ref.WIRE_DTYPE[codec],
                    device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        if seed_out is not None:
            seed_out.fill_(1)
        return q, s
    index = _index(x.device)
    partials, blocks = None, 0
    if stochastic:
        blocks = _sr_plan(index, x.dtype)[0]
        partials = torch.empty(blocks, dtype=torch.int32, device=x.device)
    qmax = ref.QMAX[codec]
    build.check(_fns().quant_fwd(
        x.data_ptr(), _DTYPES[x.dtype], n, _CODECS[codec], int(stochastic),
        qmax, 1.0 / qmax, q.data_ptr(), s.data_ptr(),
        None if partials is None else partials.data_ptr(), blocks,
        None if seed_out is None else seed_out.data_ptr(), _sms(index),
        build.stream_ptr(x.device)), "quant_fwd")
    quant_launches += 1
    return q, s


def dequantize_cuda(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
                    dtype, out: torch.Tensor | None = None) -> torch.Tensor:
    """The dequant kernel: the first n decoded values in `shape`, `dtype`,
    written into `out` when given."""
    global dequant_launches
    codec = {v: k for k, v in ref.WIRE_DTYPE.items()}.get(q.dtype)
    m = math.ceil(n / QCHUNK)
    if (codec is None or q.device.type != "cuda" or tuple(q.shape) !=
            (m, QCHUNK) or not q.is_contiguous()):
        raise ValueError(f"dequant kernel: q {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}; needs contiguous ({m}, {QCHUNK}) e4m3 "
                         "or int8 on a CUDA device")
    if (scales.device != q.device or scales.dtype != torch.float32
            or scales.numel() != m or not scales.is_contiguous()):
        raise ValueError(f"dequant kernel: scales {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}; needs "
                         f"{m} contiguous float32 on {q.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"dequant kernel: output {dtype}; float32 or "
                         "bfloat16")
    if out is None:
        out = torch.empty(n, dtype=dtype, device=q.device)
    elif (out.device != q.device or out.dtype != dtype or out.numel() != n
          or not out.is_contiguous()):
        raise ValueError(f"dequant kernel: out {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}; needs {n} "
                         f"contiguous {dtype} on {q.device}")
    if n:
        build.check(_fns().dequant_fwd(
            q.data_ptr(), scales.data_ptr(), _CODECS[codec], n,
            out.data_ptr(), _DTYPES[dtype], _sms(_index(q.device)),
            build.stream_ptr(q.device)), "dequant_fwd")
        dequant_launches += 1
    return out.reshape(shape)
