"""Plain PyTorch RMSNorm: the CPU path of `ops.rmsnorm` and the oracle the
CUDA kernel is held against on the card."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            unit_offset: bool = False) -> torch.Tensor:
    xf = x.float()
    var = xf.pow(2).mean(-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    scale = w.float() + 1.0 if unit_offset else w.float()
    return (y * scale).to(x.dtype)
