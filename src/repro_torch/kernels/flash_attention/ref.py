"""Plain PyTorch quadratic attention on the port's public layout: the CPU
path of `ops.flash_attention` and the oracle the CUDA kernels are held
against on the card.

q: (B, S, H, hd); k/v: (B, T, Kh, hd) with H % Kh == 0; q head h reads kv
head h // (H // Kh).  Scores, softmax and the weighted sum are fp32; the
output is cast to q's dtype.  `q_offset` places q's rows at positions
q_offset .. q_offset + S - 1 of the key sequence (one query chunk of the
backward's recompute).

`attention_lse` and `attention_bwd` are the reverse pass the backward
kernels compute (the reference's `_vjp_bwd` written out): from the
forward's output and row log-sum-exp, fp32 inside and one rounding to the
output dtype.  Autograd through `attention` rounds elsewhere (its bf16
output before the cotangent meets it), so the bf16 kernels' gradients are
held to this.
"""

from __future__ import annotations

import math

import torch

# planted faults of `attention_bwd` that the checks on the card must reject
PLANTS = ("P in one bf16 part", "dS in one bf16 part",
          "a query head left out of dK/dV", "D = 0")


def _scores(q, k, causal, window, softcap, q_scale, q_offset=0):
    """(capped fp32 scores (B, Kh, g, S, T), tanh of the softcap or None,
    the mask (S, T), scale)."""
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    scale = q_scale if q_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, Kh, H // Kh, hd) * scale
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = softcap * th
    pos_q = torch.arange(q_offset, q_offset + S, device=q.device)[:, None]
    pos_k = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    return s, th, mask, scale


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              q_scale=None, q_offset=0):
    B, S, H, hd = q.shape
    s, _, mask, _ = _scores(q, k, causal, window, softcap, q_scale, q_offset)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_lse(q, k, *, causal=True, window=None, softcap=None,
                  q_scale=None):
    """Each row's log-sum-exp of the masked scores, (B, H, S) fp32: what the
    forward kernels write for the backward."""
    B, S, H, _ = q.shape
    s, _, mask, _ = _scores(q, k, causal, window, softcap, q_scale)
    lse = torch.logsumexp(s.masked_fill(~mask, -float("inf")), dim=-1)
    return lse.reshape(B, H, S)


def attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                  softcap=None, q_scale=None, plant=None):
    """(dq, dk, dv) of `attention` from its output `o`, row log-sum-exp
    `lse` ((B, H, S)) and cotangent `do`: P = exp(c - lse), D = rowsum(do o
    o), dS = P (dP - D) (1 - tanh^2) scale, dq = dS k, dk = dS^T q (summed
    over each kv head's group), dv = P^T do; fp32 inside, cast once to the
    inputs' dtype.  `plant` (one of PLANTS) plants a fault for the checks:
    P or dS rounded to one bf16 part before the products that take it, the
    group's last query head left out of dk and dv, or D taken as 0."""
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    g = H // Kh
    s, th, mask, scale = _scores(q, k, causal, window, softcap, q_scale)
    p = torch.exp(s - lse.reshape(B, Kh, g, S, 1)).masked_fill(~mask, 0.0)
    dog = do.float().reshape(B, S, Kh, g, hd)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v.float())
    delta = (do.float() * o.float()).sum(-1).reshape(B, S, Kh, g)
    if plant == "D = 0":
        delta = torch.zeros_like(delta)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if th is not None:
        ds = ds * (1 - th * th)
    ds = ds * scale
    if plant == "P in one bf16 part":
        p = p.bfloat16().float()
    if plant == "dS in one bf16 part":
        ds = ds.bfloat16().float()
    ds_k = ds
    if plant == "a query head left out of dK/dV":
        keep = torch.ones(g, device=q.device)
        keep[-1] = 0
        p, ds_k = p * keep[:, None, None], ds * keep[:, None, None]
    qg = q.float().reshape(B, S, Kh, g, hd)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float())
    dk = torch.einsum("bkgst,bskgh->btkh", ds_k, qg)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
