"""The user-facing entry point at pp = 1 (port of `repro.core.api`):

    par = parallelize(model, dcfg, shape, device="cuda")
    storage, opt_state = init_train_state(par, generator)   # train_step.py
    step = par.train_step(AdamWConfig(), schedule)
    storage, opt_state, metrics = step(storage, opt_state, batch)

  * **`ParallelPlan`** — the frozen, resolved description of how one model
    runs: the stacked param groups, the bucket plan per group (the paper's
    wrapping decision, manual or auto, with per-bucket wire precisions
    under ``comm_precision="auto"``), the remat policy and, when a shape
    is given or remat is budgeted, the memory plan (`core/memory`).
    `exec_dcfg` is the config the steps run: the memory plan's resolved
    policy vector (and any retightened buckets) written back.
  * **`parallelize(model, dcfg, shape)`** — returns a `Parallelized`
    bundle: the plan, the process group, storage init and the loss /
    train steps (`train/train_step.py`); `plan=` runs a pre-built plan.

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
from repro_torch.core.remat import AUTO_PREFIX, parse_remat


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
    """Resolved bucketing / remat / memory decisions for (model, dcfg) at
    pp = 1."""

    dcfg: DistConfig
    stacked_keys: Mapping[str, int]
    bucket_plans: Mapping[str, BucketPlan]
    remat: str
    memory: Any = None                  # core/memory.MemoryPlan | None

    def bucket_plan(self, key: str) -> BucketPlan | None:
        return self.bucket_plans.get(key)

    @property
    def exec_dcfg(self) -> DistConfig:
        """The DistConfig the steps run with: `dcfg` with the memory
        plan's decisions written back — the resolved per-segment policy
        vector replacing ``remat="auto:<GB>"`` and, when the planner
        retightened buckets against the budget, the chosen BucketPlan as
        the explicit bucket_mode."""
        d = self.dcfg
        kw = {}
        if self.memory is not None:
            if self.memory.policy_spec != d.remat:
                kw["remat"] = self.memory.policy_spec
            if self.memory.bucket_plan is not None:
                kw["bucket_mode"] = self.memory.bucket_plan
        return d.with_(**kw) if kw else d

    def describe(self) -> str:
        d = self.dcfg
        mesh = "x".join(f"{a}={s}" for a, s in
                        zip(d.mesh_axes, d.mesh_shape))
        buckets = ",".join(f"{k}:{p.n_buckets}"
                           for k, p in self.bucket_plans.items())
        mem = f" mem[{self.memory.describe()}]" if self.memory is not None \
            else ""
        quant = ""
        if d.comm_precision != "bf16":
            per_bucket = {q for p in self.bucket_plans.values()
                          for q in (p.precisions or ())}
            quant = f" comm={d.comm_precision}"
            if per_bucket:
                quant += "(" + ",".join(sorted(per_bucket)) + ")"
        return (f"mesh[{mesh}] fsdp={d.fsdp_axes} tp={d.tp_size} "
                f"remat={self.remat} buckets[{buckets}]{quant}{mem}")


def plan_parallel(model, dcfg: DistConfig, shape=None) -> ParallelPlan:
    """Build + validate the frozen `ParallelPlan` for one (model, dcfg).

    `shape` (models/common.ShapeConfig) feeds the auto bucket planners'
    workload model (per-device batch) and the memory plan.  Raises a
    pointed "not yet ported" error for every layout the port does not run
    (tp > 1, pp / cp axes, HSDP)."""
    from repro_torch.models.runtime import stacked_keys as model_stacked_keys
    check_trainable(dcfg)
    # malformed remat strings fail here, once, not at the first step
    remat_kind, _ = parse_remat(dcfg.remat)
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

    stats = None
    if shape is not None and hasattr(model, "block_stats") \
            and "blocks" in metas:
        # per-device workload: rows shard over batch_dp, the sequence over
        # the ctx axis
        b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
        stats = model.block_stats(
            dcfg, (b_local, shape.seq_len // max(1, dcfg.cp_size)))

    bucket_plans = {}
    for k in sk:
        segments = model.block_segments(dcfg) \
            if k == "blocks" and hasattr(model, "block_segments") else None
        bucket_plans[k] = plan_for(metas[k], dcfg,
                                   stats if k == "blocks" else None,
                                   segments=segments)

    # the memory plan: simulate (and, for remat="auto:<GB>", choose) the
    # per-segment policy vector under the HBM budget.  It needs the
    # workload shape; a fixed policy without one carries no memory record.
    memory = None
    if remat_kind == AUTO_PREFIX and not hasattr(model, "block_stats"):
        raise ValueError(
            f"remat={dcfg.remat!r}: the budgeted auto form needs the "
            f"model's cost contract, but {type(model).__name__} does not "
            "implement block_stats; set an explicit policy (or vector) "
            "instead")
    if (shape is not None or remat_kind == AUTO_PREFIX) \
            and hasattr(model, "block_stats"):
        from repro_torch.core.memory import plan_memory
        memory = plan_memory(model, dcfg, shape, bucket_plans=bucket_plans)
        if memory.bucket_plan is not None:
            # the override as the steps run it: under comm_precision='auto'
            # a plan without precisions (the per-param partition) gets them
            # here, priced with the same stats (the reference attaches them
            # only when its stack re-resolves the plan, so its describe()
            # omits them)
            k = memory.main_key
            bucket_plans = dict(bucket_plans)
            bucket_plans[k] = plan_for(
                metas[k], dcfg.with_(bucket_mode=memory.bucket_plan),
                stats if k == "blocks" else None)

    return ParallelPlan(dcfg=dcfg, stacked_keys=sk,
                        bucket_plans=bucket_plans, remat=dcfg.remat,
                        memory=memory)


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


def parallelize(model, dcfg: DistConfig, shape=None, device="cuda",
                plan: ParallelPlan | None = None) -> Parallelized:
    """The paper's one-line wrap, resolved for (model, dcfg[, shape]) on
    `device` (CUDA unless the caller asks for the CPU).  Pass a pre-built
    `plan` (a replan's, `core/obs/calibrate.replan`) to skip re-resolution;
    it must describe the same dcfg.  Raises when the memory plan takes
    host offload, which no step executes (its modeled peak would not be
    the step's)."""
    dev = resolve_device(device)
    plan = plan if plan is not None else plan_parallel(model, dcfg, shape)
    if plan.dcfg is not dcfg and plan.dcfg != dcfg:
        raise ValueError("plan was resolved for a different DistConfig")
    mem = plan.memory
    if mem is not None and (mem.offload_opt_state or mem.offload_residuals):
        raise NotImplementedError(
            f"remat={dcfg.remat!r}: the memory plan {mem.describe()} takes "
            "host offload, which is planned but not executed (the "
            "reference executes it nowhere either); its modeled peak is "
            "not the step's.  Raise the budget until the search needs no "
            "offload, or set an explicit policy")
    return Parallelized(model=model, plan=plan, mesh=make_mesh(dcfg),
                        device=dev)
