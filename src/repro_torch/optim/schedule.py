"""LR schedules (warmup + cosine, the TorchTitan default used by the paper's
evals), computed on the step's device so the train step never syncs."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor_frac: float = 0.1) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
