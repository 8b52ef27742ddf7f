"""ZeRO-sharded AdamW with the error-feedback hop of the quantized
collectives (port of `repro.optim.adamw`).

Parameters live as flat local shards (core/meta.py), so the optimizer is
ZeRO-3 by construction: moments are allocated per shard and the update is
elementwise on local data.  The global gradient norm needs one scalar
all-reduce over the FSDP ranks.  Weight decay applies to every leaf, as in
the reference.  The update runs in the fused AdamW kernel
(`kernels/adamw`), one launch per storage leaf, reading lr, the step and
the clip scale from device scalars: a step never syncs with the host.
p, m and v are updated in place.

Under a `*_ef` wire precision the state carries an fp32 error-feedback
accumulator `ef` beside m and v (`DistConfig.needs_ef`): each step the
shard-local reduced gradient plus `ef` goes through the fp8 wire codec
(round to nearest; the reference uses fp8 here under int8_ef too), the
decoded value feeds the norm and the update, and the rounding residual is
kept for the next step.  Under ``comm_precision="auto"`` the hop applies
only to the leaves whose bucket the planner put at an ``*_ef`` precision
(`ef_mask`); the reference applies it to every leaf, so a bucket it
gathers and reduces in bf16 still gets fp8-rounded gradients.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import leaves, tree_map, unflatten_like
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.quant import ops as quant_ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(storage_tree, cfg: DistConfig | None = None):
    """Fresh moments beside the storage and the step counter (an int32
    device scalar), plus the fp32 error-feedback accumulator when
    `cfg.needs_ef`."""
    dev = leaves(storage_tree)[0].device
    state = {"m": tree_map(torch.zeros_like, storage_tree),
             "v": tree_map(torch.zeros_like, storage_tree),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg is not None and cfg.needs_ef:
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), storage_tree)
    return state


def global_grad_norm(grads_tree, cfg: DistConfig) -> torch.Tensor:
    """sqrt(sum of squares over every distinct gradient element): shards
    are distinct across the FSDP ranks, so their squares all-reduce."""
    total = sum(torch.sum(g.float() ** 2) for g in leaves(grads_tree))
    if cfg.fsdp_size > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


def error_feedback(grads, ef, mask=None):
    """The quantize-compensate hop: g2 = g + ef; gq = fp8 round trip of g2
    (round to nearest); ef' = g2 - gq.  Returns gq; `ef` becomes ef' IN
    PLACE (g2 is formed in its buffer).  `mask` (a tree of bools like
    `grads`; None = every leaf) picks the leaves the hop applies to; the
    others pass through and keep their `ef`."""
    flags = leaves(mask) if mask is not None else [True] * len(leaves(ef))
    out = []
    for g, e, on in zip(leaves(grads), leaves(ef), flags):
        if not on:
            out.append(g)
            continue
        e.add_(g.to(torch.float32))
        gq = quant_ops.roundtrip(e, "fp8", stochastic=False)
        e.sub_(gq)
        out.append(gq)
    return unflatten_like(grads, out)


def apply_adamw(storage, grads, opt_state, cfg: DistConfig,
                ocfg: AdamWConfig, lr: torch.Tensor,
                ef_mask=None) -> torch.Tensor:
    """One AdamW step on the sharded storage, IN PLACE on storage and
    opt_state (the error-feedback hop first, on the leaves `ef_mask`
    picks — all by default; the state carries "ef" exactly when
    `cfg.needs_ef`).  lr: fp32 device scalar.  Returns the global grad
    norm."""
    if ("ef" in opt_state) != cfg.needs_ef:
        raise ValueError(
            f"comm_precision={cfg.comm_precision!r} "
            f"{'needs' if cfg.needs_ef else 'takes no'} error-feedback "
            "state, but the optimizer state "
            f"{'lacks' if cfg.needs_ef else 'carries'} 'ef': build it with "
            "init_opt_state(storage, cfg)")
    t = opt_state["step"] + 1
    if "ef" in opt_state:
        grads = error_feedback(grads, opt_state["ef"], ef_mask)
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
