"""Host offload: the device <-> host channel the memory planner can spend
(port of `repro.core.memory.offload`).

Two offloadable stores are chosen by `core/memory/planner.plan_memory`:
the optimizer state (AdamW m / v, cold between steps) and the
segment-boundary residuals.  These helpers move a tree of tensors to
pinned host memory and back.  As in the reference, no step calls them
yet: a plan that picks offload reports a peak the step does not have
(ROADMAP, faults of the reference).  Unlike the reference, a transfer
that cannot be made raises; it never returns the tree unchanged.
"""

from __future__ import annotations

import torch

from repro_torch.core.meta import tree_map


def host_offload_supported() -> bool:
    """Pinned host memory needs a CUDA device to pin against."""
    return torch.cuda.is_available()


def to_host(tree):
    """Every tensor of `tree` -> a copy in pinned host memory."""
    if not host_offload_supported():
        raise RuntimeError(
            "host offload needs pinned host memory, which needs a CUDA "
            "device; none is available")
    return tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, pin_memory=True).copy_(t.detach()), tree)


def to_device(tree, device):
    """Every tensor of `tree` -> a copy on `device`."""
    device = torch.device(device)
    return tree_map(lambda t: t.to(device, non_blocking=t.is_pinned()),
                    tree)
