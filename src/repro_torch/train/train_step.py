"""Training step assembly at pp = 1 (port of `repro.train.train_step`):
SimpleFSDP forward/backward + gradient accumulation over microbatches +
global-norm clipping + AdamW + LR schedule.

The steps are plain callables built from a `Parallelized` bundle
(`core/api.py`); they run the plan's `exec_dcfg`, the config with the
memory plan's resolved remat written back, and hand the stack the blocks'
bucket plan the `ParallelPlan` reports, so the plan that runs (and the
error-feedback mask read from it) is the one `describe()` prints.  Storage and optimizer state
are this rank's shards; a batch is global and each rank takes its rows.
The logged loss is the mean over the data-parallel ranks, as the
reference's `pmean`.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.collectives import default_precision
from repro_torch.core.meta import (leaves, named_leaves, tree_map,
                                   unflatten_like)
from repro_torch.optim.adamw import AdamWConfig, apply_adamw, init_opt_state
from repro_torch.optim.schedule import warmup_cosine


def step_wire_metrics(model, plan) -> dict:
    """Per-step collective wire-byte accounting by comm precision, straight
    from the plan's own bucket groups and precision assignments — the
    numbers `Trainer` mirrors into `train/wire_bytes/<prec>` counters each
    step.  Host math only: {"total_bytes", "by_precision"}."""
    from repro_torch.core.autowrap import _cfg_precision
    from repro_torch.core.irgraph import build_nodes

    dcfg = plan.dcfg
    metas = model.metas(dcfg)
    by_prec: dict[str, float] = {}
    total = 0.0
    for key, bplan in plan.bucket_plans.items():
        if key not in metas:
            continue
        nodes = {n.name: n for n in build_nodes(metas[key], dcfg, None)}
        precs = bplan.precisions or \
            [_cfg_precision(dcfg)] * len(bplan.groups)
        mult = max(1, plan.stacked_keys.get(key, 1))
        for grp, prec in zip(bplan.groups, precs):
            wire = sum(nodes[n].ag_wire(prec) + nodes[n].rs_wire(prec)
                       for n in grp if n in nodes) * mult
            by_prec[prec] = by_prec.get(prec, 0.0) + wire
            total += wire
    return {"total_bytes": total, "by_precision": by_prec}


def _loss_and_grads(par, storage, batch):
    """(loss, grads, aux) of the model's local loss w.r.t. every storage
    leaf; `aux` holds the model's aux sums apart, detached (moe: the
    router's load-balance term, which the loss includes, and the drop
    count)."""
    dcfg = par.plan.exec_dcfg
    params = [a.detach().requires_grad_() for a in leaves(storage)]
    loss, aux = par.model.loss_local(unflatten_like(storage, params), batch,
                                     dcfg, par.plan.bucket_plan("blocks"))
    grads = torch.autograd.grad(loss, params)
    return (loss.detach(), unflatten_like(storage, grads),
            {k: v.detach() for k, v in aux.items()})


def _rank_mean(x: torch.Tensor, par) -> torch.Tensor:
    if par.mesh.size > 1:
        x = x.clone()
        dist.all_reduce(x)
        x /= par.mesh.size
    return x


def make_loss_step(par):
    """step(storage, batch) -> (loss, grads)."""
    def step(storage, batch):
        loss, grads, _ = _loss_and_grads(par, storage,
                                         par.local_batch(batch))
        return _rank_mean(loss, par), grads
    return step


def ef_mask(par):
    """Per storage leaf: whether its gradient is reduce-scattered at an
    ``*_ef`` precision, the leaves the error-feedback hop applies to.  A
    stacked group's leaf takes its bucket's precision in the plan the
    steps run; every other group gathers at the config's own precision
    ('auto': bf16)."""
    dcfg = par.plan.exec_dcfg
    metas = par.model.metas(dcfg)
    prec = {n: default_precision(dcfg) for n, _ in named_leaves(metas)}
    for k, plan in par.plan.bucket_plans.items():
        names = [n for n, _ in named_leaves(metas[k])]
        for grp, p in zip(plan.index_groups(metas[k]),
                          plan.group_precisions(metas[k], dcfg)):
            prec.update((f"{k}/{names[i]}", p) for i in grp)
    return unflatten_like(metas, [p.endswith("_ef") for p in prec.values()])


def make_train_step(par, ocfg: AdamWConfig,
                    schedule: Callable | None = None):
    """step(storage, opt_state, batch) -> (storage, opt_state, metrics),
    updating storage and opt_state in place.  metrics: loss, grad_norm and
    lr as device scalars, and the model's aux terms on their own (moe:
    `moe_aux`, the load-balance term the loss includes, and `moe_drops`,
    the (token, choice) pairs dropped over capacity in all layers)."""
    dcfg = par.plan.exec_dcfg
    mask = ef_mask(par) if dcfg.needs_ef else None
    sched = schedule or (lambda t: torch.full((), ocfg.lr,
                                              device=t.device))

    def step(storage, opt_state, batch):
        b = par.local_batch(batch)
        k = dcfg.microbatches
        if k > 1:
            rows = next(iter(b.values())).shape[0] // k
            mbs = [{n: a[i * rows:(i + 1) * rows] for n, a in b.items()}
                   for i in range(k)]
            loss, grads, aux = _loss_and_grads(par, storage, mbs[0])
            for mb in mbs[1:]:
                l, g, a = _loss_and_grads(par, storage, mb)
                loss = loss + l
                aux = {n: aux[n] + a[n] for n in aux}
                tree_map(lambda acc, x: acc.add_(x), grads, g)
            loss = loss * (1.0 / k)
            aux = {n: v * (1.0 / k) for n, v in aux.items()}
            tree_map(lambda acc: acc.mul_(1.0 / k), grads)
        else:
            loss, grads, aux = _loss_and_grads(par, storage, b)
        lr = sched(opt_state["step"])
        gnorm = apply_adamw(storage, grads, opt_state, dcfg, ocfg, lr,
                            ef_mask=mask)
        metrics = {"loss": _rank_mean(loss, par), "grad_norm": gnorm,
                   "lr": lr.to(torch.float32),
                   **{n: _rank_mean(v, par) for n, v in aux.items()}}
        return storage, opt_state, metrics

    return step


def default_schedule(ocfg: AdamWConfig, total_steps: int, warmup: int = 100):
    return functools.partial(warmup_cosine, peak_lr=ocfg.lr, warmup=warmup,
                             total=total_steps)


def init_train_state(par, generator: torch.Generator):
    """Fresh seeded storage (this rank's shards, made on the device) and
    optimizer state (with the error-feedback accumulator when the config's
    wire precision needs one)."""
    storage = par.init_storage(generator)
    return storage, init_opt_state(storage, par.dcfg)
