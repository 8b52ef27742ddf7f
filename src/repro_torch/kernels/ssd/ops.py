"""Mamba-2 SSD op: a CUDA tensor goes to the hand-written kernels, a CPU
tensor to the plain version (`ref.py`).

The forward is the chunk-parallel forward of `csrc/ssd_sm90.cu` for both
dtypes (each chunk's own state, a short pass that carries the states,
then every chunk's output): bf16 on bf16 tensor-core products, fp32 on
TF32 ones with three products a product, which hold fp32 tolerances.  It
reads the model's layout directly: x (B,T,H,P), dt (B,T,H), Bm/Cm
(B,T,G,N) through their strides (so the B and C halves of one packed
projection need no copy), head h reads group h // (H // G) by index (no
repeat of B and C over the heads), and the ragged last chunk is masked on
the true T (no padding copy).  It gives y with the D skip fused and the
state entering each chunk, and on request the state leaving the last one.

Two entries.  `ssd` is the stateless training entry of the reference's
`ops.ssd`, y only, a `torch.autograd.Function`: on the card its backward
is the hand-written backward of `csrc/ssd_sm90.cu` (a reverse pass over
the chunks for the state's gradient, then every chunk in parallel, then the
sums over heads, batches and chunks), given the forward's saved states.  On
the CPU it recomputes the plain chunk scan and differentiates it, as the
reference's custom VJP does with `ref.ssd_chunked`
(`repro/kernels/ssd/ops.py` `_vjp_bwd`).  `ssd_with_state` is the serving
prefill's entry, (y, the final state S), the contract of
`ref.ssd_chunked(..., state=None)`, without a gradient.  There is no
fallback: a CUDA input that the kernels do not take, a failed build or a
failed launch raises.  `launches` counts forward calls through the kernels
(either dtype), `launches_f32` those of fp32 inputs, `bwd_launches`
backward calls (either dtype), `bwd_launches_f32` those of fp32 inputs;
each call is a fixed number of kernel launches (two for the forward, three
for the backward, four with the states recomputed).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

launches = 0
launches_f32 = 0
bwd_launches = 0
bwd_launches_f32 = 0

CHUNK = 128
HEAD_DIMS = (16, 32, 64)      # P: one kernel instantiation each
MAX_STATE = 64                # N
MAX_CHUNK = 128               # Lc
_CODES = {torch.float32: build.F32, torch.bfloat16: build.BF16}


def ssd(x, dt, A, Bm, Cm, D=None, chunk: int = CHUNK):
    """Same contract as `ref.ssd_chunked` without a state: y only."""
    return _Ssd.apply(x, dt, A, Bm, Cm, D, chunk)


def ssd_with_state(x, dt, A, Bm, Cm, D=None, chunk: int = CHUNK):
    """`ref.ssd_chunked(..., state=None)`'s contract, for inference: (y
    (B,T,H,P) in x's dtype, the state leaving the sequence S (B,H,P,N)
    fp32).  No gradient flows through it on the card."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    y, _, final = _forward(x, dt, A, Bm, Cm, D, chunk, final=True)
    return y, final


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.chunk = chunk
        if x.device.type == "cpu":
            ctx.save_for_backward(x, dt, A, Bm, Cm, D)
            return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)[0]
        y, states, _ = _forward(x, dt, A, Bm, Cm, D, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        return y

    @staticmethod
    def backward(ctx, ct):
        saved = ctx.saved_tensors     # unpacked once (checkpoint allows one)
        x, dt, A, Bm, Cm, D = saved[:6]
        if x.device.type == "cpu":
            with torch.enable_grad():
                ins = [None if t is None else t.detach().requires_grad_(need)
                       for t, need in zip((x, dt, A, Bm, Cm, D),
                                          ctx.needs_input_grad)]
                y = ref.ssd_chunked(*ins, chunk=ctx.chunk)[0]
                want = [t for t in ins if t is not None and t.requires_grad]
                got = iter(torch.autograd.grad(y, want, ct))
            return (*(next(got) if t is not None and t.requires_grad
                      else None for t in ins), None)
        grads = ssd_bwd_cuda(x, dt, A, Bm, Cm, D, ct, ctx.chunk,
                             states=saved[6])
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


class _Args(ctypes.Structure):
    """`SsdArgs` of csrc/ssd_sm90.cu, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "x", "dt", "A", "Bm", "Cm", "D", "dy", "y", "states", "final",
            "dstates", "dx", "ddt", "dBh", "dCh", "dB", "dC", "dA_part",
            "dD_part", "dA", "dD")]
        + [(n, ctypes.c_longlong) for n in (
            "sxb", "sxt", "sxh", "sdb", "sdt", "sdh", "sbb", "sbt", "sbg",
            "scb", "sct", "scg")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "H", "P", "G", "N", "Lc", "nC", "has_d", "recompute",
            "x_dtype", "dt_dtype", "a_dtype", "d_dtype", "tf32_products")])


@functools.cache
def _chunked(name):
    fn = getattr(build.library().cdll, name)
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, Bm, Cm, D, chunk):
    """Raises on what the kernels do not take.  -> (B, T, H, P, G, N, Lc)."""
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
    return Bsz, T, H, P, G, N, Lc


def _args(x, dt, A, Bm, Cm, D, Lc, recompute=0, tf32_products=3, **bufs):
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    ptrs = {k: 0 if v is None else v.data_ptr()
            for k, v in dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D,
                             **bufs).items()}
    return _Args(
        **ptrs, sxb=x.stride(0), sxt=x.stride(1), sxh=x.stride(2),
        sdb=dt.stride(0), sdt=dt.stride(1), sdh=dt.stride(2),
        sbb=Bm.stride(0), sbt=Bm.stride(1), sbg=Bm.stride(2),
        scb=Cm.stride(0), sct=Cm.stride(1), scg=Cm.stride(2),
        B=Bsz, T=T, H=H, P=P, G=G, N=N, Lc=Lc, nC=-(-T // Lc),
        has_d=int(D is not None), recompute=recompute,
        x_dtype=_CODES[x.dtype], dt_dtype=_CODES[dt.dtype],
        a_dtype=_CODES[A.dtype],
        d_dtype=_CODES[D.dtype] if D is not None else build.F32,
        tf32_products=tf32_products)


def _call(name, args, device):
    build.check(_chunked(name)(ctypes.byref(args), build.stream_ptr(device)),
                name)


def _forward(x, dt, A, Bm, Cm, D, chunk, final=False, tf32_products=3):
    """-> (y (B,T,H,P) in x's dtype, contiguous; the state entering each
    chunk (B,H,nC,P,N) fp32; with `final`, the state leaving the last chunk
    (B,H,P,N) fp32, else None).  `tf32_products`: fp32's TF32 products a
    product, 3, or 1 as a planted fault."""
    global launches, launches_f32
    Bsz, T, H, P, G, N, Lc = _check(x, dt, A, Bm, Cm, D, chunk)
    if tf32_products not in (1, 3):
        raise ValueError(f"ssd kernel: tf32_products {tf32_products}")
    dev, f32 = x.device, torch.float32
    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=dev)
    states = torch.empty((Bsz, H, -(-T // Lc), P, N), dtype=f32, device=dev)
    last = torch.zeros((Bsz, H, P, N), dtype=f32, device=dev) if final \
        else None
    if y.numel() == 0:
        return y, states, last
    _call("ssd_chunked_fwd", _args(x, dt, A, Bm, Cm, D, Lc, y=y,
                                   states=states, final=last,
                                   tf32_products=tf32_products), dev)
    launches += 1
    launches_f32 += x.dtype == torch.float32
    return y, states, last


def ssd_cuda(x, dt, A, Bm, Cm, D=None, chunk: int = CHUNK,
             tf32_products: int = 3):
    """The forward kernels' launch: y (B,T,H,P) in x's dtype, contiguous.
    `tf32_products` = 1 (fp32 only) is the planted one-product fault."""
    return _forward(x, dt, A, Bm, Cm, D, chunk,
                    tf32_products=tf32_products)[0]


def ssd_bwd_cuda(x, dt, A, Bm, Cm, D, dy, chunk: int = CHUNK, states=None):
    """The backward kernels' launch: (dx, ddt, dA, dB, dC, dD) of `ssd` at
    output gradient dy, in the inputs' dtypes (dD None without D).
    `states`: the forward's state entering each chunk (B,H,nC,P,N) fp32,
    as `_Ssd.forward` saves it for either dtype; without it phases 1-2 are
    run again first."""
    global bwd_launches, bwd_launches_f32
    Bsz, T, H, P, G, N, Lc = _check(x, dt, A, Bm, Cm, D, chunk)
    if tuple(dy.shape) != (Bsz, T, H, P) or dy.device != x.device:
        raise ValueError(f"ssd backward: dy {tuple(dy.shape)} on "
                         f"{dy.device} for x {tuple(x.shape)}")
    nC = -(-T // Lc)
    if states is not None and (tuple(states.shape) != (Bsz, H, nC, P, N)
                               or states.dtype != torch.float32
                               or not states.is_contiguous()):
        raise ValueError(f"ssd backward: states {tuple(states.shape)} "
                         f"{states.dtype}, want ({Bsz}, {H}, {nC}, {P}, {N})"
                         " float32 contiguous")
    if x.numel() == 0:
        raise ValueError("ssd backward: empty input")
    dev, f32 = x.device, torch.float32

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    recompute = states is None
    bufs = dict(
        dy=dy.to(x.dtype).contiguous(),
        states=empty(Bsz, H, nC, P, N) if recompute else states,
        dstates=empty(Bsz, H, nC, P, N),
        dx=empty(Bsz, T, H, P, dtype=x.dtype), ddt=empty(Bsz, T, H),
        dBh=empty(Bsz, T, H, N), dCh=empty(Bsz, T, H, N),
        dB=empty(Bsz, T, G, N, dtype=x.dtype),
        dC=empty(Bsz, T, G, N, dtype=x.dtype), dA_part=empty(H, Bsz * nC),
        dD_part=empty(H, Bsz * nC), dA=empty(H),
        dD=None if D is None else empty(H))
    args = _args(x, dt, A, Bm, Cm, D, Lc, recompute=int(recompute), **bufs)
    _call("ssd_chunked_bwd", args, dev)
    bwd_launches += 1
    bwd_launches_f32 += x.dtype == torch.float32
    return (bufs["dx"], bufs["ddt"].to(dt.dtype), bufs["dA"].to(A.dtype),
            bufs["dB"], bufs["dC"],
            None if D is None else bufs["dD"].to(D.dtype))
