"""Flash-attention op: a CUDA tensor goes to a hand-written kernel, a CPU
tensor to the plain version (`ref.py`).  On the card the kernel goes by
dtype: bf16 to `csrc/flash_attention_sm90.cu` (wgmma and TMA), fp32 to
`csrc/flash_attention.cu` (TF32 mma.sync).  One TF32 product would not hold
fp32 tolerances; the fp32 kernel splits every operand into TF32 hi + lo and
takes three products (hi*hi + hi*lo + lo*hi), about 21 significant bits.

Layout q (B,S,H,hd), k/v (B,T,Kh,hd); GQA maps q head h to kv head
h // (H // Kh) inside the kernel, and keys are masked on the true length T,
so no repeat, transpose or padding copy is made.

`flash_attention` goes through a `torch.autograd.Function` where a
gradient is needed, and straight to the forward elsewhere.  On the card its
forward also writes each row's log-sum-exp (fp32, (B, H, S)), which only a
gradient needs, and its backward goes by dtype too (the
reference's lax `_vjp_bwd`).  bf16 goes to `csrc/flash_attention_bwd_sm90.cu`
(wgmma and TMA; P and dS as bf16 hi + lo), one pass over (query tile, key
block) pairs that computes S and dP once a pair: a prep launch writes D =
rowsum(dO o O), a key-major main launch sums dK and dV over a kv head's
group in registers and adds each pair's dQ partial into an fp32 sum per
query tile, in the fixed order `bwd_schedule` gives (a counter per tile
holds the turns), and a last launch casts the sums to dq.  fp32 goes to
`flash_attention.cu`'s backward (TF32 mma.sync, three products): a dQ
kernel that also writes D, then dK and dV as two key-major launches.  In
both every float is summed in a fixed order, with no float atomics, so two
calls are bit-identical.  On the CPU the backward recomputes the plain
version one query chunk of `Q_CHUNK` rows at a time and differentiates
that, so the (S, T) score matrix is never live whole, as the reference's
`attention_chunked` remat does.  There is no fallback: a CUDA input the
kernels do not take, a failed build or a failed launch raises.
`launches` / `launches_f32` count the bf16 / fp32 forward's calls,
`bwd_launches` / `bwd_launches_f32` the backward's (one a call, whatever
the launches inside).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

launches = 0
launches_f32 = 0
bwd_launches = 0
bwd_launches_f32 = 0

HEAD_DIMS = (16, 32, 64, 128)
Q_CHUNK = 512
# the bf16 backward's tiles: query rows a dQ tile, keys a work item
BWD_ROWS, BWD_KEYS = 64, 128


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    q_scale=None):
    """q: (B,S,H,hd); k/v: (B,T,Kh,hd), H % Kh == 0. Returns (B,S,H,hd).
    Where no gradient is needed the forward runs without the autograd
    Function, whose host cost is that of a small kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, window, softcap, q_scale)
    return _forward(q, k, v, causal, window, softcap, q_scale)


def _forward(q, k, v, causal, window, softcap, q_scale):
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_scale=q_scale)
    return flash_attention_cuda(q, k, v, causal, window, softcap, q_scale)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_scale):
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      q_scale=q_scale)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return ref.attention(q, k, v, **ctx.kw)
        o, lse = flash_attention_cuda(q, k, v, causal, window, softcap,
                                      q_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        if do.device.type != "cpu":
            grads = flash_attention_bwd_cuda(*ctx.saved_tensors, do,
                                             **ctx.kw)
            return *grads, None, None, None, None
        q, k, v = ctx.saved_tensors
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        with torch.enable_grad():
            kk = k.detach().requires_grad_()
            vv = v.detach().requires_grad_()
            for s0 in range(0, q.shape[1], Q_CHUNK):
                qc = q[:, s0:s0 + Q_CHUNK].detach().requires_grad_()
                out = ref.attention(qc, kk, vv, q_offset=s0, **ctx.kw)
                gq, gk, gv = torch.autograd.grad(
                    out, (qc, kk, vv), do[:, s0:s0 + Q_CHUNK])
                dq[:, s0:s0 + Q_CHUNK] = gq
                dk += gk
                dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


@functools.cache
def _kernel(name):
    """The launcher `name`: a forward takes q, k, v, o, 6 sizes, 12 strides,
    the masks and scale, (fp32) the products, lse and the stream; a
    backward q, k, v, o, dout, lse, scratch (bf16: `_bwd_scratch`; fp32:
    D), dq, dk, dv, 6 sizes, 24 strides, the masks and scale, (fp32) the
    products and the stream."""
    fn = getattr(build.library().cdll, name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    bwd = "_bwd" in name
    fn.argtypes = ([p] * (10 if bwd else 4) + [i] * 6 + [ll] * (24 if bwd
                                                                 else 12)
                   + [i, i, ctypes.c_float, ctypes.c_float]
                   + ([] if name.endswith("sm90") else [i])
                   + ([] if bwd else [p]) + [p])
    fn.restype = i
    return fn


def bwd_schedule(S, T, causal=True, window=None):
    """For each BWD_ROWS-row query tile, the BWD_KEYS-key blocks whose dQ
    partials the bf16 backward adds into it, in the order it adds them.
    Computed as the kernel walks: key block n visits the tiles from its
    first key under causality to its last key + window - 1 under a window
    (`item_of`), and takes the turn of the highest block that reaches the
    tile less n (`turn`).  A turn no block takes reads None."""
    nb, n_mt = -(-T // BWD_KEYS), -(-S // BWD_ROWS)
    turns = [{} for _ in range(n_mt)]
    for n in range(nb):
        begin = n * (BWD_KEYS // BWD_ROWS) if causal else 0
        end = min(S, min(T, (n + 1) * BWD_KEYS) - 1 + window) if window \
            else S
        for m in range(begin, -(-end // BWD_ROWS)):
            first = min(nb - 1, m * BWD_ROWS // BWD_KEYS) if causal \
                else nb - 1
            turns[m][first - n] = n
    return [tuple(d.get(i) for i in range(max(d, default=-1) + 1))
            for d in turns]


def _bwd_scratch(B, S, H, hd, device):
    """The bf16 backward's scratch, as `flash_attention_bwd_sm90` reads it:
    (2, B, H, Sp) fp32 lse * log2e and D * q_scale, (B, H, n_mt, 64 hd)
    fp32 dQ sums, then (B, H, n_mt) int32 dQ tiles' counters and the work
    counter (n_mt = ceil(S / 64), Sp = 64 n_mt).  Returns it and the
    counters' (B, H, n_mt) view."""
    tiles = B * H * -(-S // BWD_ROWS)
    n = tiles * BWD_ROWS * (2 + hd)
    scratch = torch.empty(n + tiles + 4, dtype=torch.float32, device=device)
    counts = scratch[n:n + tiles].view(torch.int32).view(B, H, -1)
    return scratch, counts


def _tma_strides(t):
    """t's strides over (batch, position, head) for a TMA map: a dim of
    size 1 gets a stride of hd (never read, but the map needs a multiple of
    16 bytes)."""
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _check(q, k, v, window, softcap):
    """Raises on what the kernels do not take; returns q, k, v's strides
    over (batch, position, head) as the launchers take them."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if (q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"flash kernel: dtypes {q.dtype}/{k.dtype}/{v.dtype};"
                        " all must be float32 or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or H % Kh or hd not in HEAD_DIMS
            or S == 0 or T == 0):
        raise ValueError(f"flash kernel: q {tuple(q.shape)} / kv "
                         f"{tuple(k.shape)}: need equal batch and hd, "
                         f"H % Kh == 0, hd in {HEAD_DIMS}, S, T > 0")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel: head_dim must have unit stride")
    if window is not None and window < 1:
        raise ValueError(f"flash kernel: window {window} must be >= 1")
    if softcap is not None and softcap < 0:
        raise ValueError(f"flash kernel: softcap {softcap} must be > 0")
    if q.dtype != torch.bfloat16:
        return [st for t in (q, k, v) for st in t.stride()[:3]]
    if not _tma_readable(q, k, v):
        raise ValueError(
            "flash kernel: bf16 q/k/v are read by TMA, which needs "
            "16-byte aligned base pointers and strides that are multiples "
            f"of 8 elements; got strides {[t.stride() for t in (q, k, v)]}"
            f" and offsets {[t.storage_offset() for t in (q, k, v)]}")
    return [st for t in (q, k, v) for st in _tma_strides(t)]


def _tma_readable(*ts):
    return not any(t.data_ptr() % 16 or any(st % 8 for st in _tma_strides(t))
                   for t in ts)


def _scale(q_scale, hd):
    return float(q_scale if q_scale is not None else 1.0 / math.sqrt(hd))


def flash_attention_cuda(q, k, v, causal, window, softcap, q_scale,
                         tf32_products=3, with_lse=False):
    """The forward kernels' launch.  `tf32_products` (fp32 only): 3 for the
    kernel (hi*hi + hi*lo + lo*hi), 1 for hi*hi alone, a planted fault that
    the checks must reject.  With `with_lse` it also returns each row's
    log-sum-exp, (B, H, S) fp32, which the backward needs."""
    global launches, launches_f32
    strides = _check(q, k, v, window, softcap)
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    # empty_like: a third of torch.empty's host cost
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    name = "flash_attention_fwd_sm90" if bf16 else "flash_attention_fwd"
    rc = _kernel(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, T, H, Kh, hd, *strides, *o.stride()[:3],
        int(causal), int(window or 0), float(softcap or 0.0),
        _scale(q_scale, hd), *(() if bf16 else (tf32_products,)),
        None if lse is None else lse.data_ptr(), build.stream_ptr(q.device))
    build.check(rc, name)
    if bf16:
        launches += 1
    else:
        launches_f32 += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=None,
                             softcap=None, q_scale=None, tf32_products=3,
                             with_counts=False):
    """The backward kernels' launch: (dq, dk, dv) in the inputs' dtype from
    the forward's inputs, its output `o` and row log-sum-exp `lse` ((B, H,
    S) fp32) and the cotangent `do`.  `tf32_products` as for the forward
    (fp32 only; 1 is the planted fault).  With `with_counts` (bf16 only) it
    also returns the dQ partials each query tile took, (B, H, ceil(S / 64))
    int32, which `bwd_schedule` predicts."""
    global bwd_launches, bwd_launches_f32
    strides = _check(q, k, v, window, softcap)
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    if (do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype
            or o.dtype != q.dtype or do.device != q.device
            or o.device != q.device or o.stride(-1) != 1
            or o.data_ptr() % 16):
        raise ValueError(f"flash backward: do {tuple(do.shape)} {do.dtype}, "
                         f"o {tuple(o.shape)} {o.dtype} (strides "
                         f"{o.stride()}) against q {tuple(q.shape)} "
                         f"{q.dtype}; o's rows are read whole, 16-byte "
                         "aligned")
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype}; need contiguous fp32 (B, H, S)")
    bf16 = q.dtype == torch.bfloat16
    if with_counts and not bf16:
        raise ValueError("flash backward: counts come from the bf16 kernel")
    # the cotangent is read with a unit stride on hd, in bf16 by TMA, whose
    # map takes no stride of 0: autograd hands an expanded one (all strides
    # 0 after a .sum()) to a copy
    if do.stride(-1) != 1 or bf16 and not (
            _tma_readable(do) and all(_tma_strides(do))):
        do = do.contiguous()
    o_strides = list(o.stride()[:3])
    do_strides = _tma_strides(do) if bf16 else list(do.stride()[:3])
    if bf16:
        scratch, counts = _bwd_scratch(B, S, H, hd, q.device)
    else:
        scratch = torch.empty_like(lse)  # D
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    name = "flash_attention_bwd_sm90" if bf16 else "flash_attention_bwd"
    rc = _kernel(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, T, H, Kh, hd, *strides,
        *o_strides, *do_strides,
        *(st for t in (dq, dk, dv) for st in t.stride()[:3]),
        int(causal), int(window or 0), float(softcap or 0.0),
        _scale(q_scale, hd), *(() if bf16 else (tf32_products,)),
        build.stream_ptr(q.device))
    build.check(rc, name)
    if bf16:
        bwd_launches += 1
    else:
        bwd_launches_f32 += 1
    return (dq, dk, dv, counts) if with_counts else (dq, dk, dv)
