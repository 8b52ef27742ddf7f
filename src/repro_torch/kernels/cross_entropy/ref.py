"""Plain PyTorch cross-entropy: the CPU path of `ops.xent` and the oracle
the CUDA kernels are held against on the card (the reference's
`repro/kernels/cross_entropy/ref.py`, in torch).

A target outside [0, V) contributes no target logit and no one-hot term,
as in the TPU kernel."""

from __future__ import annotations

import torch


def xent(logits: torch.Tensor, targets: torch.Tensor):
    """logits (R, V); targets (R,) int.  Returns (loss (R,), lse (R,)) fp32."""
    lf = logits.float()
    m = lf.max(-1).values
    lse = torch.log(torch.exp(lf - m[:, None]).sum(-1)) + m
    V = logits.shape[1]
    hit = (targets >= 0) & (targets < V)
    tl = lf.gather(1, targets.clamp(0, V - 1).long()[:, None])[:, 0]
    return lse - torch.where(hit, tl, 0.0), lse


def dlogits(logits, targets, lse, g):
    """d loss / d logits for the per-row cotangent g, in the logits' dtype."""
    p = torch.exp(logits.float() - lse[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)
    onehot = (cols[None, :] == targets[:, None]).float()
    return ((p - onehot) * g[:, None]).to(logits.dtype)
