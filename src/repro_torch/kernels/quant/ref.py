"""Plain PyTorch per-chunk quantization codec for the wire (port of
`repro.kernels.quant.ref`), bit for bit the reference's.

Codec: the flat buffer is chunked into QCHUNK = 128-element groups; each
chunk carries one f32 absmax-derived scale plus one byte per element (fp8
e4m3 or int8).  Encode is round-to-nearest for params (forward all-gather:
deterministic, identical on every rank) and stochastic for grads
(reduce-scatter: unbiased).  Stochastic rounding adds, for fp8, a 20-bit
dither below e4m3's 3 kept mantissa bits of the f32 bit pattern and
truncates; for int8 it is floor(y + u).  The dither is an integer hash of
(seed + flat index over the padded (m, QCHUNK) view); the seed is the
wraparound u32 sum of the buffer's own f32 bits, | 1.

u32 arithmetic runs in int64 with `& 0xFFFFFFFF` after every multiply and
add (the wraparound is part of the hash's definition); every product stays
below 2**63 for buffers under 2**31 elements.
"""

from __future__ import annotations

import torch

QCHUNK = 128          # elements per scale group (= flat-shard storage LANE)
SCALE_BYTES = 4       # one f32 scale per chunk rides along on the wire
QMAX = {"fp8": 448.0, "int8": 127.0}
WIRE_DTYPE = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}
CODECS = tuple(QMAX)

M32 = 0xFFFFFFFF
_KNUTH = 2654435761
_MIX = 0x45D9F3B


def hash_u32(idx: torch.Tensor, seed) -> torch.Tensor:
    """Knuth multiplicative + xor-shift avalanche on u32 values held in
    int64 tensors (`idx` < 2**31, `seed` < 2**32)."""
    h = (seed + idx * _KNUTH) & M32
    h = h ^ (h >> 16)
    h = (h * _MIX) & M32
    return h ^ (h >> 16)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """The f32 bit patterns of x (cast to f32) as u32 values in int64."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & M32


def _from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> the f32 numbers with those bit patterns."""
    signed = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def buffer_seed(x2: torch.Tensor) -> torch.Tensor:
    """Wraparound u32 sum of the buffer's f32 bits, | 1 (an int64 scalar
    holding the u32): data-dependent, so no generator state threads through
    the collectives."""
    s = x2.to(torch.float32).view(torch.int32).sum(dtype=torch.int64)
    return (s & M32) | 1


def sr_fp8(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Stochastic-round f32 (pre-clipped to +-448) to e4m3: add a 20-bit
    uniform dither below the 3 kept mantissa bits, truncate, cast."""
    bits = f32_bits(y)
    sign = bits & 0x80000000
    mag = bits & 0x7FFFFFFF
    mag = (mag + (h >> 12)) & 0xFFF00000
    z = _from_bits(sign | mag)
    return z.clamp(-448.0, 448.0).to(torch.float8_e4m3fn)


def sr_int8(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.floor(y + u).clamp(-127.0, 127.0).to(torch.int8)


def chunk(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Flatten + zero-pad to the (n_chunks, QCHUNK) f32 view the codec
    quantizes over.  Returns (view, original element count)."""
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    pad = (-n) % QCHUNK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, QCHUNK), n


def chunk_scales(x2: torch.Tensor, codec: str) -> torch.Tensor:
    """Per-chunk f32 scale: absmax * f32(1/QMAX), a multiply by the
    reciprocal as the reference computes it; 1.0 for all-zero chunks."""
    absmax = x2.abs().amax(dim=1, keepdim=True)
    inv = torch.tensor(1.0 / QMAX[codec], dtype=torch.float32,
                       device=x2.device)
    return torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))


def encode_chunks(x2: torch.Tensor, scale: torch.Tensor, codec: str,
                  stochastic: bool, seed=None) -> torch.Tensor:
    """Quantize a pre-chunked (m, QCHUNK) f32 view against `scale`."""
    qmax = QMAX[codec]
    y = (x2 / scale).clamp(-qmax, qmax)
    if stochastic:
        if seed is None:
            seed = buffer_seed(x2)
        idx = torch.arange(x2.numel(), dtype=torch.int64,
                           device=x2.device).reshape(x2.shape)
        h = hash_u32(idx, seed)
        return sr_fp8(y, h) if codec == "fp8" else sr_int8(y, h)
    if codec == "fp8":
        return y.to(torch.float8_e4m3fn)
    return torch.round(y).clamp(-127.0, 127.0).to(torch.int8)


def quantize(x: torch.Tensor, codec: str = "fp8", stochastic: bool = False):
    """-> (q, scales): wire values (n_chunks, QCHUNK) in e4m3/int8
    (zero-padded past x.numel()) and f32 scales (n_chunks, 1)."""
    x2, _ = chunk(x)
    scale = chunk_scales(x2, codec)
    return encode_chunks(x2, scale, codec, stochastic), scale


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
               dtype) -> torch.Tensor:
    """Inverse of `quantize`: wire values + scales back to the original
    shape and dtype."""
    x = q.to(torch.float32) * scales
    return x.reshape(-1)[:n].reshape(shape).to(dtype)


def roundtrip(x: torch.Tensor, codec: str | None = "fp8",
              stochastic: bool = False) -> torch.Tensor:
    """quantize -> dequantize in one call: what a receiver decodes after
    `x` travels in `codec`."""
    if codec is None:
        return x
    q, s = quantize(x, codec, stochastic)
    return dequantize(q, s, x.numel(), x.shape, x.dtype)


# ---------------------------------------------------------------------------
# KV-cache codec: the serving cache / paged-arena storage format.  Each
# (..., head_dim) vector is zero-padded to whole QCHUNK groups and
# quantized with the wire codec's chunk_scales / encode_chunks (RTN: a
# cache read back must be reproducible); the scales ride alongside as
# (..., kv_chunks(head_dim)) f32.
# ---------------------------------------------------------------------------
def kv_chunks(head_dim: int) -> int:
    """Scale groups per head vector: ceil(head_dim / QCHUNK)."""
    return -(-head_dim // QCHUNK)


def kv_pad(x: torch.Tensor) -> torch.Tensor:
    """x (..., hd) zero-padded to (..., kv_chunks(hd) * QCHUNK)."""
    pad = kv_chunks(x.shape[-1]) * QCHUNK - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def encode_kv(x: torch.Tensor, codec: str):
    """x: (..., hd) -> (wire values (..., hd), f32 scales (..., nc))."""
    hd = x.shape[-1]
    nc = kv_chunks(hd)
    x2 = kv_pad(x.to(torch.float32)).reshape(-1, QCHUNK)
    scale = chunk_scales(x2, codec)
    q = encode_chunks(x2, scale, codec, stochastic=False)
    q = q.reshape(*x.shape[:-1], nc * QCHUNK)[..., :hd]
    return q, scale.reshape(*x.shape[:-1], nc)


def decode_kv(q: torch.Tensor, scales: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `encode_kv` back to `dtype` (same trailing hd)."""
    hd = q.shape[-1]
    s = torch.repeat_interleave(scales, QCHUNK, dim=-1)[..., :hd]
    return (q.to(torch.float32) * s).to(dtype)
