"""Plain PyTorch AdamW update (bias-corrected, decoupled decay): the CPU
path of `ops.adamw_update` and the oracle the CUDA kernel is held against
on the card (the reference's `repro/kernels/adamw/ref.py`, in torch, with
the gradient clip scale folded in as the kernel folds it)."""

from __future__ import annotations

import torch


def adamw_update(p, g, m, v, *, lr, t, scale, b1, b2, eps, wd):
    """Returns new (p, m, v) in p's dtype.  lr, scale: fp32 scalars; t: the
    1-based step (a scalar tensor)."""
    gf = g.float() * scale
    m = b1 * m.float() + (1 - b1) * gf
    v = b2 * v.float() + (1 - b2) * gf * gf
    tf = t.float()
    mhat = m / (1 - b1 ** tf)
    vhat = v / (1 - b2 ** tf)
    pf = p.float()
    pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
    return pf.to(p.dtype), m.to(p.dtype), v.to(p.dtype)
