"""Plain PyTorch quadratic attention on the port's public layout: the CPU
path of `ops.flash_attention` and the oracle the CUDA kernel is held against
on the card.

q: (B, S, H, hd); k/v: (B, T, Kh, hd) with H % Kh == 0; q head h reads kv
head h // (H // Kh).  Scores, softmax and the weighted sum are fp32; the
output is cast to q's dtype.  `q_offset` places q's rows at positions
q_offset .. q_offset + S - 1 of the key sequence (one query chunk of the
backward's recompute).
"""

from __future__ import annotations

import math

import torch


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              q_scale=None, q_offset=0):
    B, S, H, hd = q.shape
    T, Kh = k.shape[1], k.shape[2]
    g = H // Kh
    scale = q_scale if q_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, Kh, g, hd) * scale
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos_q = torch.arange(q_offset, q_offset + S, device=q.device)[:, None]
    pos_k = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
