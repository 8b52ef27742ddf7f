"""Layer primitives of the serving and training paths (port of
`repro.models.layers`).

Each unit comes as metas / init / apply over plain dicts of tensors, with
the reference's parameter layouts: ``wq`` (d, hq*hd), ``wk``/``wv`` stored
transposed as (kvp*hd, d), ``wo`` (hq*hd, d); the head layout (padded q and
kv head counts, the head mask) comes from `ArchConfig.gqa_layout`.  The
port runs at tp=1, so the reference's sequence-parallel gathers and
scatters are identities and are left out.  Every apply is differentiable:
rmsnorm and attention through their kernels' `autograd.Function`s, the
loss through the cross-entropy kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import ParamMeta
from repro_torch.kernels.cross_entropy import ops as xent_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.common import ArchConfig


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-5, unit_offset: bool = False):
    return rms_ops.rmsnorm(x, w, eps=eps, unit_offset=unit_offset)


def norm_meta(name: str, d: int, dtype) -> ParamMeta:
    return ParamMeta(name, (d,), tp_dim=None, dtype=dtype)


def norm_init(d: int, device, dtype, unit_offset: bool = False):
    # gemma-style norms store (w - 1) when unit_offset
    fill = torch.zeros if unit_offset else torch.ones
    return fill((d,), device=device, dtype=dtype)


def _normal(shape, std, generator, device, dtype):
    return torch.empty(shape, device=device, dtype=dtype).normal_(
        0.0, std, generator=generator)


# ---------------------------------------------------------------------------
# RoPE (rotate-half convention, fp32 tables)
# ---------------------------------------------------------------------------
def _inv_freq(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, device=device,
                        dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exps)


def rope_cache(seq_len: int, head_dim: int, theta: float, device,
               positions=None):
    """cos/sin tables (S, hd/2). `positions` overrides 0..S-1 (decode)."""
    if positions is None:
        positions = torch.arange(seq_len, device=device)
    ang = positions[:, None].float() * _inv_freq(head_dim, theta, device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (S, hd/2)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def rope_pos(positions, head_dim: int, theta: float):
    """cos/sin for an explicit per-request position grid.

    positions: (B, S) int.  Returns (B, S, hd/2) tables for
    `apply_rope_pos`."""
    ang = positions[..., None].float() * _inv_freq(head_dim, theta,
                                                   positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_pos(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) from `rope_pos`."""
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _rotate(x, c, s):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------
def _softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              q_scale=None):
    """Prefill attention: the flash kernel on the card, its plain version
    on the CPU.  q: (B, S, H, hd); k/v: (B, T, Kh, hd)."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_scale=q_scale)


def cached_attention(q, ck, cv, qpos, *, window=None, softcap=None):
    """Decode attention over a dense cache, plain torch: the reference's
    einsums with fp32 scores.  q: (B, C, H, hd), already scaled; ck / cv:
    (B, T, Kh, hd); qpos: (B, C) absolute positions, each query seeing the
    keys at <= its position (and > position - window), or None: every key
    (encdec's cross-attention).  Returns (B, C, H, hd) in cv's dtype."""
    B, C, hl, hd = q.shape
    T, kl = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, C, kl, hl // kl, hd)
    s = _softcap(torch.einsum("bqkgh,btkh->bkgqt", qg.float(), ck.float()),
                 softcap)
    if qpos is not None:
        tpos = torch.arange(T, device=q.device)
        msk = tpos[None, None, :] <= qpos[:, :, None]
        if window is not None:
            msk &= tpos[None, None, :] > qpos[:, :, None] - window
        s = s.masked_fill(~msk[:, None, None, :, :], -1e30)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", pr.to(cv.dtype), cv)
    return out.reshape(B, C, hl, hd)


# ---------------------------------------------------------------------------
# Embedding and LM head
# ---------------------------------------------------------------------------
def embed_meta(name: str, cfg: ArchConfig, dtype) -> ParamMeta:
    return ParamMeta(name, (cfg.vocab, cfg.d_model), tp_dim=0, dtype=dtype)


def embed_init(generator, cfg: ArchConfig, device, dtype):
    return _normal((cfg.vocab, cfg.d_model), 0.02, generator, device, dtype)


def embed_apply(table, ids, cfg: ArchConfig, dcfg: DistConfig,
                scale: float | None = None):
    """table: (V, D); ids: (B, S) -> (B, S, D) in param_dtype, times
    `scale` where given (gemma2's sqrt(d)).  Ids outside the vocab embed to
    zeros, as in the reference's vocab-parallel lookup.  The scale is
    rounded to param_dtype before it multiplies, as the reference's
    ``jnp.asarray(scale, param_dtype)`` is: sqrt(4608) = 67.88 is 68.0 in
    bf16."""
    hit = (ids >= 0) & (ids < cfg.vocab)
    x = F.embedding(ids.clamp(0, cfg.vocab - 1), table)
    x = torch.where(hit[..., None], x, 0).to(dcfg.param_dtype)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=dcfg.param_dtype).item()
    return x


class _LogitsF32(torch.autograd.Function):
    """x (R, D) @ w -> fp32 logits (R, V), from operands in x's dtype with
    fp32 accumulation (the reference's ``preferred_element_type=float32``):
    `torch.mm(..., out_dtype=float32)` for bf16 on the card, an fp32 product
    elsewhere.  w is (D, V), or the (V, D) embedding table when `tied`.
    The backward multiplies in x's dtype (the fp32 cotangent is rounded to
    it first), so the bf16 step keeps its head products on tensor cores."""

    @staticmethod
    def forward(ctx, x, w, tied):
        ctx.save_for_backward(x, w)
        ctx.tied = tied
        wt = w.t() if tied else w
        if (x.dtype == torch.bfloat16 and x.is_cuda
                and hasattr(torch.ops.aten.mm, "dtype")):
            return torch.mm(x, wt, out_dtype=torch.float32)
        return torch.mm(x.float(), wt.float())

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        ct = ct.to(x.dtype)
        wt = w.t() if ctx.tied else w
        dx = torch.mm(ct, wt.t())
        dw = torch.mm(ct.t(), x) if ctx.tied else torch.mm(x.t(), ct)
        return dx, dw, None


def logits_f32(x, w, cfg: ArchConfig):
    """x: (B, S, D) -> fp32 logits (B, S, V) against the head (D, V) or,
    under tied embeddings, the embedding table (V, D); then the final
    softcap."""
    B, S, D = x.shape
    out = _LogitsF32.apply(x.reshape(B * S, D), w, cfg.tie_embeddings)
    return _softcap(out.view(B, S, -1), cfg.final_softcap)


def matmul_f32(x, w):
    """x (R, D) @ w (D, N) accumulated and returned in fp32 (the
    reference's ``preferred_element_type=float32``; the moe router)."""
    return _LogitsF32.apply(x, w, False)


def vocab_parallel_xent(logits, targets, valid):
    """Masked mean cross-entropy over the valid tokens (the reference's
    `vocab_parallel_xent` at tp=1), per-row losses from the cross-entropy
    kernel.  Returns (loss, aux)."""
    B, S, V = logits.shape
    per_tok = xent_ops.xent(logits.reshape(B * S, V),
                            targets.reshape(-1)).view(B, S)
    loss = (per_tok * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return loss, {}


def head_meta(name: str, cfg: ArchConfig, dtype) -> ParamMeta:
    return ParamMeta(name, (cfg.d_model, cfg.vocab), tp_dim=1, dtype=dtype)


def head_init(generator, cfg: ArchConfig, device, dtype):
    return _normal((cfg.d_model, cfg.vocab),
                   0.02 / math.sqrt(2 * cfg.n_layers), generator, device,
                   dtype)


# ---------------------------------------------------------------------------
# Attention unit (one layer)
# ---------------------------------------------------------------------------
def attn_metas(cfg: ArchConfig, dcfg: DistConfig, dtype,
               prefix: str = "") -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    lay = cfg.gqa_layout(dcfg.tp_size)
    hq, kvp = lay["hq"], lay["kvp"]
    kv_tp = 0 if lay["mode"] == "sharded" else None
    metas = {
        "wq": ParamMeta(prefix + "wq", (d, hq * hd), tp_dim=1, dtype=dtype),
        "wk": ParamMeta(prefix + "wk", (kvp * hd, d),
                        tp_dim=kv_tp, dtype=dtype),
        "wv": ParamMeta(prefix + "wv", (kvp * hd, d),
                        tp_dim=kv_tp, dtype=dtype),
        "wo": ParamMeta(prefix + "wo", (hq * hd, d), tp_dim=0, dtype=dtype),
    }
    if cfg.qk_norm:
        metas["q_norm"] = ParamMeta(prefix + "q_norm", (hd,), None, dtype)
        metas["k_norm"] = ParamMeta(prefix + "k_norm", (hd,), None, dtype)
    return metas


def attn_init(generator, cfg: ArchConfig, dcfg: DistConfig, device,
              dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    lay = cfg.gqa_layout(dcfg.tp_size)
    hq, kvp = lay["hq"], lay["kvp"]
    sd = 0.02
    p = {
        "wq": _normal((d, hq * hd), sd, generator, device, dtype),
        "wk": _normal((kvp * hd, d), sd, generator, device, dtype),
        "wv": _normal((kvp * hd, d), sd, generator, device, dtype),
        "wo": _normal((hq * hd, d), sd / math.sqrt(2 * cfg.n_layers),
                      generator, device, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, device, dtype)
        p["k_norm"] = norm_init(hd, device, dtype)
    return p


def head_mask(cfg: ArchConfig, dcfg: DistConfig, device, dtype):
    """(hq,) ones on real q heads, zeros on the padding heads of the
    'grouped' layout (tp=1: every rank-local head is global)."""
    lay = cfg.gqa_layout(dcfg.tp_size)
    if lay["mode"] == "sharded":
        return torch.ones((lay["hq"],), device=device, dtype=dtype)
    gids = torch.arange(lay["hq"], device=device)
    g = lay["g"]
    return ((gids // g < cfg.n_kv_heads)
            & (gids % g < lay["g_real"])).to(dtype)


def _local_qkv(p, xg, cfg: ArchConfig, dcfg: DistConfig):
    """Project to the q heads and the kv heads they read.

    Returns q (B,S,hq,hd), k/v (B,S,kvp,hd), head_mask (hq,) zeroing padded
    q heads.  At tp=1 a rank's kv slice is every kv head."""
    B, S, _ = xg.shape
    hd = cfg.head_dim
    lay = cfg.gqa_layout(dcfg.tp_size)
    q = torch.matmul(xg, p["wq"]).view(B, S, lay["hq"], hd)
    k = torch.matmul(xg, p["wk"].t()).view(B, S, lay["kvp"], hd)
    v = torch.matmul(xg, p["wv"].t()).view(B, S, lay["kvp"], hd)
    return q, k, v, head_mask(cfg, dcfg, xg.device, q.dtype)


def attn_apply(p, x, rope, cfg: ArchConfig, dcfg: DistConfig, window=None,
               q_scale=None):
    """Attention sublayer (train/prefill path): x (B, S, D) -> (projected
    output (B, S, D), (k, v) after RoPE).  rope: (cos, sin) of (S, hd/2)."""
    q, k, v, hmask = _local_qkv(p, x, cfg, dcfg)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attention(q, k, v, causal=True, window=window,
                    softcap=cfg.attn_softcap, q_scale=q_scale)
    out = out * hmask[None, None, :, None]
    B, S, hl, hd = out.shape
    return torch.matmul(out.reshape(B, S, hl * hd), p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# MLP unit: SwiGLU, GeGLU, or a plain GELU FFN
# ---------------------------------------------------------------------------
GATED_MLPS = ("swiglu", "geglu", "gelu")


def mlp_metas(cfg: ArchConfig, dcfg: DistConfig, dtype,
              prefix: str = "", d_ff: int | None = None) -> dict:
    """`d_ff` overrides cfg.d_ff (the moe family's shared expert).  The
    gated variants carry a gate matrix ``wg``; ``gelu`` does not."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    m = {
        "wu": ParamMeta(prefix + "wu", (d, f), tp_dim=1, dtype=dtype),
        "wd": ParamMeta(prefix + "wd", (f, d), tp_dim=0, dtype=dtype),
    }
    if cfg.gated_mlp != "gelu":
        m["wg"] = ParamMeta(prefix + "wg", (d, f), tp_dim=1, dtype=dtype)
    return m


def mlp_init(generator, cfg: ArchConfig, device, dtype,
             d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    sd = 0.02
    p = {
        "wu": _normal((d, f), sd, generator, device, dtype),
        "wd": _normal((f, d), sd / math.sqrt(2 * cfg.n_layers), generator,
                      device, dtype),
    }
    if cfg.gated_mlp != "gelu":
        p["wg"] = _normal((d, f), sd, generator, device, dtype)
    return p


def mlp_apply(p, x, cfg: ArchConfig, dcfg: DistConfig):
    """SwiGLU (silu(x wg) * (x wu)) wd, GeGLU (gelu(x wg) * (x wu)) wd, or
    gelu(x wu) wd.  GELU is the tanh form, the reference's
    ``jax.nn.gelu(approximate=True)``."""
    u = torch.matmul(x, p["wu"])
    if cfg.gated_mlp == "gelu":
        h = F.gelu(u, approximate="tanh")
    else:
        g = torch.matmul(x, p["wg"])
        act = F.gelu(g, approximate="tanh") if cfg.gated_mlp == "geglu" \
            else F.silu(g)
        h = act * u
    return torch.matmul(h, p["wd"])


# ---------------------------------------------------------------------------
# Quantized KV cache (kernels/quant codec: per-128-chunk f32 scales over
# each head vector, the path the wire collectives use)
# ---------------------------------------------------------------------------
def kv_quantize(x, codec="int8"):
    """x: (..., hd) -> (wire values (..., hd), f32 scales (..., nc))."""
    return quant_ops.encode_kv(x, codec)


def kv_dequantize(q, s, dtype):
    return quant_ops.decode_kv(q, s, dtype)
