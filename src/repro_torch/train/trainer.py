"""Training loop (port of `repro.train.trainer` at pp = 1): data, init or
restore, failure restart, straggler monitor, checkpoints, history and
observability.

It resolves a `ParallelPlan` through `core/api.parallelize` (the workload
shape makes it resolve the memory plan too) and drives the plan's train
step, which runs `plan.exec_dcfg`.  Every step lands in a metrics
registry and a drift monitor beside the plan's modeled step time
(`core/obs`); with `replan_threshold` set, a drift streak profiles the
executed plan (`profile_step`), re-runs the planners under calibration
and, with `replan_apply`, restarts onto the new plan through the
checkpoint path.  `memory_report` sets the modeled peak beside the one the
card measures over a step.  Checkpoints hold the logical
(topology-independent) layout in the reference's format, so a run
restarts from a checkpoint written by either package; the port's also
hold the error-feedback accumulator of a `*_ef` run (the reference's drop
it, and resume with it at zero).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.api import parallelize
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import tree_map
from repro_torch.core.obs import (DriftMonitor, MetricsRegistry,
                                  calibrated_step_time, modeled_step_time,
                                  profile_step)
from repro_torch.core.obs import replan as obs_replan
from repro_torch.data.pipeline import DataConfig, SyntheticC4, adapt_batch
from repro_torch.ft.failures import FailureSource, StepTimer, \
    StragglerMonitor
from repro_torch.models.common import ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (default_schedule,
                                          init_train_state,
                                          step_wire_metrics)

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    warmup: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    max_restarts: int = 3
    metrics_jsonl: str | None = None  # append a registry snapshot here at
                                      # every log interval (core/obs)
    # profile-guided replanning (core/obs/profile + calibrate): when the
    # step_time drift |rel| stays above replan_threshold for
    # replan_patience consecutive steps, harvest a MeasuredProfile and
    # re-run the planners under calibration.  replan_apply additionally
    # restarts the loop onto the new plan through the checkpoint path.
    replan_threshold: float | None = None
    replan_patience: int = 3
    replan_apply: bool = False
    replan_profile_steps: int = 2


class Trainer:
    def __init__(self, model, dcfg: DistConfig, shape: ShapeConfig,
                 ocfg: AdamWConfig, tcfg: TrainerConfig,
                 failure_source: FailureSource | None = None,
                 seed: int = 0, device="cuda", registry=None):
        self.model, self.dcfg, self.shape = model, dcfg, shape
        self.ocfg, self.tcfg = ocfg, tcfg
        self.failures = failure_source or FailureSource()
        self.straggler = StragglerMonitor()
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self.data = SyntheticC4(DataConfig(
            vocab=model.cfg.vocab, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=seed))
        self._seed = seed
        self.par = parallelize(model, dcfg, shape, device=device)
        self.plan = self.par.plan
        self.step_fn = self.par.train_step(
            ocfg, default_schedule(ocfg, tcfg.total_steps, tcfg.warmup))
        self.history: list[dict] = []
        self.restarts = 0
        # profile-guided replanning state: drift streak, the latest
        # harvested MeasuredProfile, and one delta record per replan
        self._drift_streak = 0
        self._replan_pending = False
        self.profile = None
        self.replans: list[dict] = []
        # observability: one registry + drift monitor per trainer; the
        # plan's own step-time promise (None for a model without a cost
        # contract) and per-step wire bytes are frozen up front so the run
        # loop only records measurements
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.drift = DriftMonitor(self.registry)
        self._modeled_step_s = modeled_step_time(model, self.plan, shape)
        self._wire = step_wire_metrics(model, self.plan)
        if self.plan.memory is not None:
            log.info("plan: %s", self.plan.describe())
            for b in self.plan.memory.breakdown:
                log.info("modeled peak %s", b.describe())

    def memory_report(self, measured: bool = True) -> dict:
        """The memory plan's modeled per-device peak, its policy spec and
        per-stage breakdown.  On the card, with `measured`, also the
        measured peak: `torch.cuda.max_memory_allocated()` over one step
        from fresh state (the state is allocated before the peak counter
        is reset, so it counts), and modeled / measured."""
        mem = self.plan.memory
        rep = {
            "modeled_peak_bytes": mem.peak if mem else None,
            "policy_spec": mem.policy_spec if mem else self.dcfg.remat,
            "per_stage": [b.describe() for b in mem.breakdown]
            if mem else [],
        }
        dev = self.par.device
        if measured and dev.type == "cuda":
            storage, opt_state = init_train_state(self.par,
                                                  self._generator())
            batch = self._batch(0)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            self.step_fn(storage, opt_state, batch)
            torch.cuda.synchronize(dev)
            meas = torch.cuda.max_memory_allocated(dev)
            del storage, opt_state
            rep["measured_peak_bytes"] = meas
            if mem is not None:
                rep["modeled_over_measured"] = mem.peak / max(1, meas)
                # the one audited modeled-vs-measured path (core/obs)
                log.info("memory: %s", self.registry.record_peak(
                    "train", mem.peak, meas,
                    note=f"remat={rep['policy_spec']}"))
                self.drift.record("peak_memory", mem.peak, meas)
        return rep

    def _init_or_restore(self, generator):
        latest = self.ckpt.latest_step()
        if latest is not None:
            storage, opt_state, _ = self.ckpt.restore(latest, self.model,
                                                      self.dcfg)
            to_dev = functools.partial(tree_map,
                                       lambda a: a.to(self.par.device))
            storage = to_dev(self.par.shard(storage))
            opt_state = to_dev({k: v if k == "step" else self.par.shard(v)
                                for k, v in opt_state.items()})
            log.info("restored step %d", latest)
            return storage, opt_state, latest
        storage, opt_state = init_train_state(self.par, generator)
        return storage, opt_state, 0

    def _save(self, step, storage, opt_state):
        whole = {k: v if k == "step" else self.par.unshard(v)
                 for k, v in opt_state.items()}
        storage = self.par.unshard(storage)
        if self.par.mesh.rank == 0:
            self.ckpt.save(step, storage, whole, self.model, self.dcfg)

    def _batch(self, step):
        return adapt_batch(self.data.batch(step),
                           self.model.input_specs(self.shape, self.dcfg),
                           step=step, seed=self._seed)

    def _generator(self):
        return torch.Generator(device=self.par.device).manual_seed(self._seed)

    def _record_step(self, step: int, dt: float, metrics: dict) -> None:
        """Mirror one completed step into the registry + drift monitor."""
        r = self.registry
        r.counter("train/steps").inc()
        r.gauge("train/step_time_s").set(dt)
        r.gauge("train/tokens_per_s").set(
            self.shape.seq_len * self.shape.global_batch / max(1e-9, dt))
        r.gauge("train/grad_norm").set(metrics["grad_norm"])
        r.gauge("train/loss").set(metrics["loss"])
        for k in ("moe_aux", "moe_drops"):     # the moe family's aux terms
            if k in metrics:
                r.gauge(f"train/{k}").set(metrics[k])
        for prec, nbytes in self._wire["by_precision"].items():
            r.counter(f"train/wire_bytes/{prec}").inc(nbytes)
        if self._modeled_step_s is not None:
            rel = self.drift.record("step_time", self._modeled_step_s, dt,
                                    step=step)
            if self.tcfg.replan_threshold is not None \
                    and math.isfinite(rel):
                if abs(rel) > self.tcfg.replan_threshold:
                    self._drift_streak += 1
                    if self._drift_streak >= self.tcfg.replan_patience:
                        self._replan_pending = True
                else:
                    self._drift_streak = 0
        if self.tcfg.replan_threshold is not None and self.par.mesh.size > 1:
            # every rank replans at the same step, or their collectives
            # would part: one rank's streak arms them all
            flag = torch.tensor([float(self._replan_pending)],
                                device=self.par.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            self._replan_pending = bool(flag.item())

    def _replan(self, step, storage, opt_state):
        """Profile-guided replanning: harvest a `MeasuredProfile` against
        the drifting plan, re-run the planners under calibration, log the
        delta, and — when `replan_apply` — restart the loop onto the new
        plan through the checkpoint path (the same topology-independent
        restart the failure path uses).  Returns the (possibly restored)
        train state."""
        self._replan_pending = False
        self._drift_streak = 0
        rows = self.drift.records.get("step_time", [])
        recent = [r["measured"]
                  for r in rows[-max(1, self.tcfg.replan_patience):]]
        wall = sum(recent) / len(recent) if recent else None
        try:
            self.profile = profile_step(
                self.model, self.plan, self.shape,
                steps=self.tcfg.replan_profile_steps, wall_step_s=wall,
                device=self.par.device)
            new_plan, delta = obs_replan(self.model, self.plan, self.shape,
                                         self.profile)
        except Exception:
            log.exception("replan failed at step %d; keeping current plan",
                          step)
            return storage, opt_state
        delta["step"] = step
        delta["applied"] = False
        self.replans.append(delta)
        r = self.registry
        r.counter("replan/count").inc()
        for k in ("modeled_step_before_s", "modeled_step_after_s"):
            if delta[k] is not None:
                r.gauge(f"replan/{k}").set(delta[k])
        log.info("replan at step %d: changed=%s gain=%s fields=%s", step,
                 delta["changed"], delta["modeled_gain_s"],
                 sorted(delta["fields"]))
        if not (self.tcfg.replan_apply and delta["changed"]):
            return storage, opt_state
        try:
            par = parallelize(self.model, self.dcfg, self.shape,
                              device=self.par.device, plan=new_plan)
        except NotImplementedError as e:
            # the new plan takes host offload, which no step executes
            log.warning("replan at step %d not applied: %s", step, e)
            delta["not_applied"] = str(e)
            return storage, opt_state
        # restart onto the new plan: checkpoints store the logical layout,
        # so save, rebuild the parallelized bundle, and restore sharded
        self._save(step, storage, opt_state)
        self.ckpt.wait()
        if self.par.mesh.size > 1:
            dist.barrier()            # rank 0 wrote it; every rank reads it
        del storage, opt_state
        self.par = par
        self.plan = par.plan
        self.step_fn = par.train_step(
            self.ocfg, default_schedule(self.ocfg, self.tcfg.total_steps,
                                        self.tcfg.warmup))
        self._modeled_step_s = calibrated_step_time(
            self.model, self.plan, self.shape, self.profile)
        self._wire = step_wire_metrics(self.model, self.plan)
        storage, opt_state, _ = self._init_or_restore(self._generator())
        delta["applied"] = True
        log.info("replan applied at step %d: %s", step, self.plan.describe())
        return storage, opt_state

    def run(self, generator: torch.Generator | None = None):
        generator = generator or self._generator()
        storage, opt_state, start = self._init_or_restore(generator)
        step = start
        while step < self.tcfg.total_steps:
            if self.failures.check(step):
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise RuntimeError("restart budget exhausted")
                log.warning("failure detected at step %d; restarting", step)
                self.ckpt.wait()
                storage, opt_state, step = self._init_or_restore(
                    self._generator())
                continue

            batch = self._batch(step)
            with StepTimer() as t:
                storage, opt_state, metrics = self.step_fn(
                    storage, opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            if self.straggler.observe(t.dt) == "escalate":
                log.warning("straggler escalation at step %d", step)
            step += 1
            self._record_step(step, t.dt, metrics)
            if self._replan_pending:
                storage, opt_state = self._replan(step, storage, opt_state)
            if step % self.tcfg.log_every == 0 or step == 1:
                self.history.append({"step": step, "dt": t.dt, **metrics})
                log.info("step %d loss %.4f gnorm %.3f %.0fms", step,
                         metrics["loss"], metrics["grad_norm"], t.dt * 1e3)
                if self.tcfg.metrics_jsonl and self.par.mesh.rank == 0:
                    self.registry.dump_jsonl(self.tcfg.metrics_jsonl,
                                             step=step)
            if step % self.tcfg.ckpt_every == 0 \
                    or step == self.tcfg.total_steps:
                self._save(step, storage, opt_state)
        self.ckpt.wait()
        return storage, opt_state, self.history
