"""ZeRO-sharded AdamW (port of `repro.optim.adamw`, without error
feedback: quantized collectives are not ported).

Parameters live as flat local shards (core/meta.py), so the optimizer is
ZeRO-3 by construction: moments are allocated per shard and the update is
elementwise on local data.  The global gradient norm needs one scalar
all-reduce over the FSDP ranks.  Weight decay applies to every leaf, as in
the reference.  The update runs in the fused AdamW kernel
(`kernels/adamw`), one launch per storage leaf, reading lr, the step and
the clip scale from device scalars: a step never syncs with the host.
p, m and v are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import leaves, tree_map
from repro_torch.kernels.adamw import ops as adamw_ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(storage_tree):
    """Fresh moments beside the storage and the step counter (an int32
    device scalar)."""
    dev = leaves(storage_tree)[0].device
    return {"m": tree_map(torch.zeros_like, storage_tree),
            "v": tree_map(torch.zeros_like, storage_tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_grad_norm(grads_tree, cfg: DistConfig) -> torch.Tensor:
    """sqrt(sum of squares over every distinct gradient element): shards
    are distinct across the FSDP ranks, so their squares all-reduce."""
    total = sum(torch.sum(g.float() ** 2) for g in leaves(grads_tree))
    if cfg.fsdp_size > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


def apply_adamw(storage, grads, opt_state, cfg: DistConfig,
                ocfg: AdamWConfig, lr: torch.Tensor) -> torch.Tensor:
    """One AdamW step on the sharded storage, IN PLACE on storage and
    opt_state.  lr: fp32 device scalar.  Returns the global grad norm."""
    t = opt_state["step"] + 1
    gnorm = global_grad_norm(grads, cfg)
    scale = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if ocfg.grad_clip else torch.ones_like(gnorm)
    lr = lr.to(torch.float32)
    for p, g, m, v in zip(leaves(storage), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        adamw_ops.adamw_update(p, g, m, v, lr=lr, t=t, scale=scale,
                               b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps,
                               wd=ocfg.weight_decay)
    opt_state["step"] = t
    return gnorm
