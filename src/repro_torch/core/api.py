"""The user-facing entry point at pp = 1 (port of `repro.core.api`):

    par = parallelize(model, dcfg, shape, device="cuda")
    storage, opt_state = init_train_state(par, generator)   # train_step.py
    step = par.train_step(AdamWConfig(), schedule)
    storage, opt_state, metrics = step(storage, opt_state, batch)

  * **`ParallelPlan`** — the frozen, resolved description of how one model
    runs: the stacked param groups, the bucket plan per group (the paper's
    wrapping decision) and the remat policy.  The reference's memory plan
    changes nothing that runs for a fixed remat policy (`plan_memory`
    returns no bucket plan and the resolved policies), and its budgeted
    form is not ported, so `memory` is None.
  * **`parallelize(model, dcfg, shape)`** — returns a `Parallelized`
    bundle: the plan, the process group, storage init and the loss /
    train steps (`train/train_step.py`).

`shard_params` / `unshard_params` are the one full <-> storage layout
transform (stacked-aware).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.bucketing import BucketPlan, plan_for
from repro_torch.core.dist import (DistConfig, Mesh, check_trainable,
                                   make_mesh, resolve_device)
from repro_torch.core.meta import from_storage, to_storage, tree_map
from repro_torch.core.remat import parse_remat


def shard_params(params_full, metas, cfg: DistConfig):
    """Full shaped params -> flat/padded/TP-indexed ZeRO-3 storage (whole,
    every rank's chunk).  A leaf with one extra leading dim relative to its
    meta is layer-stacked."""
    def one(m, p):
        if p.dim() == len(m.global_shape) + 1:
            return torch.stack([to_storage(p[i], m, cfg)
                                for i in range(p.shape[0])])
        return to_storage(p, m, cfg)
    return tree_map(one, metas, params_full)


def unshard_params(storage, metas, cfg: DistConfig):
    """Inverse of `shard_params` (stacked-aware)."""
    def one(m, p):
        if p.dim() == len(m.storage_shape(cfg)) + 1:
            return torch.stack([from_storage(p[i], m, cfg)
                                for i in range(p.shape[0])])
        return from_storage(p, m, cfg)
    return tree_map(one, metas, storage)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Resolved bucketing / remat decisions for (model, dcfg) at pp = 1."""

    dcfg: DistConfig
    stacked_keys: Mapping[str, int]
    bucket_plans: Mapping[str, BucketPlan]
    remat: str
    memory: Any = None

    def bucket_plan(self, key: str) -> BucketPlan | None:
        return self.bucket_plans.get(key)

    def describe(self) -> str:
        d = self.dcfg
        mesh = "x".join(f"{a}={s}" for a, s in
                        zip(d.mesh_axes, d.mesh_shape))
        buckets = ",".join(f"{k}:{p.n_buckets}"
                           for k, p in self.bucket_plans.items())
        quant = f" comm={d.comm_precision}" \
            if d.comm_precision != "bf16" else ""
        return (f"mesh[{mesh}] fsdp={d.fsdp_axes} tp={d.tp_size} "
                f"remat={self.remat} buckets[{buckets}]{quant}")


def plan_parallel(model, dcfg: DistConfig, shape=None) -> ParallelPlan:
    """Build + validate the frozen `ParallelPlan` for one (model, dcfg).
    Raises a pointed "not yet ported" error for every layout the port does
    not run (tp > 1, pp/cp axes, comm_precision='auto', the auto bucket and
    memory planners)."""
    from repro_torch.models.runtime import stacked_keys as model_stacked_keys
    check_trainable(dcfg)
    parse_remat(dcfg.remat)
    if shape is not None:
        rows = dcfg.dp_total * max(1, dcfg.microbatches)
        if shape.global_batch % rows:
            raise ValueError(
                f"global batch {shape.global_batch} does not split over "
                f"{dcfg.dp_total} data-parallel ranks x "
                f"{dcfg.microbatches} microbatches")
    metas = model.metas(dcfg)
    sk = model_stacked_keys(model)
    for k in sk:
        if k not in metas:
            raise ValueError(
                f"{type(model).__name__}.stacked_keys names {k!r} which is "
                f"not a param group ({sorted(metas)})")
    return ParallelPlan(dcfg=dcfg, stacked_keys=sk,
                        bucket_plans={k: plan_for(metas[k], dcfg)
                                      for k in sk},
                        remat=dcfg.remat)


@dataclasses.dataclass
class Parallelized:
    """What `parallelize` returns: the plan plus what a training loop
    needs.  Storage and optimizer state are THIS rank's shards; batches
    are global (numpy or torch) and each rank takes its rows."""

    model: Any
    plan: ParallelPlan
    mesh: Mesh
    device: torch.device

    @property
    def dcfg(self) -> DistConfig:
        return self.plan.dcfg

    def shard(self, storage):
        """Whole storage -> this rank's shards."""
        from repro_torch.models import runtime as RT
        return RT.local_shard(storage, self.dcfg, self.mesh.rank)

    def unshard(self, local):
        """This rank's shards -> whole storage (all-gather)."""
        from repro_torch.models import runtime as RT
        return RT.gather_shards(local, self.dcfg)

    def init_storage(self, generator: torch.Generator):
        """Seeded storage made on the device, this rank's shards."""
        from repro_torch.models import runtime as RT
        return self.shard(RT.init_storage(self.model, generator, self.dcfg,
                                          self.device))

    def local_batch(self, batch) -> dict:
        """Global batch -> this rank's rows on the device."""
        out = {}
        for k, a in batch.items():
            a = torch.from_numpy(np.ascontiguousarray(a)) \
                if isinstance(a, np.ndarray) else a
            rows = a.shape[0] // self.dcfg.dp_total
            out[k] = a[self.mesh.rank * rows:(self.mesh.rank + 1) * rows] \
                .to(self.device)
        return out

    def loss_step(self):
        """step(storage, batch) -> (loss, grads)."""
        from repro_torch.train import train_step as TS
        return TS.make_loss_step(self)

    def train_step(self, ocfg, lr_schedule=None):
        """step(storage, opt_state, batch) -> (storage, opt_state,
        metrics); storage and opt_state are updated in place."""
        from repro_torch.train import train_step as TS
        return TS.make_train_step(self, ocfg, lr_schedule)


def parallelize(model, dcfg: DistConfig, shape=None,
                device="cuda") -> Parallelized:
    """The paper's one-line wrap, resolved for (model, dcfg[, shape]) on
    `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return Parallelized(model=model, plan=plan_parallel(model, dcfg, shape),
                        mesh=make_mesh(dcfg), device=dev)
