"""Training loop (port of `repro.train.trainer` at pp = 1): data, init or
restore, failure restart, straggler monitor, checkpoints and history.

It resolves a `ParallelPlan` through `core/api.parallelize` (the workload
shape makes it resolve the memory plan too) and drives the plan's train
step, which runs `plan.exec_dcfg`.  `memory_report` sets the modeled peak
beside the one the card measures over a step.  Checkpoints hold the logical (topology-independent)
layout in the reference's format, so a run restarts from a checkpoint
written by either package; the port's also hold the error-feedback
accumulator of a `*_ef` run (the reference's drop it, and resume with it
at zero).  The reference's observability pieces (metrics
registry, drift monitor, modeled step time, replanning) are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.api import parallelize
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import tree_map
from repro_torch.data.pipeline import DataConfig, SyntheticC4, adapt_batch
from repro_torch.ft.failures import FailureSource, StepTimer, \
    StragglerMonitor
from repro_torch.models.common import ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import default_schedule, init_train_state

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    warmup: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    max_restarts: int = 3


class Trainer:
    def __init__(self, model, dcfg: DistConfig, shape: ShapeConfig,
                 ocfg: AdamWConfig, tcfg: TrainerConfig,
                 failure_source: FailureSource | None = None,
                 seed: int = 0, device="cuda"):
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
                log.info("memory: modeled %.2f GiB, measured %.2f GiB "
                         "(remat=%s)", mem.peak / 2**30, meas / 2**30,
                         rep["policy_spec"])
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
            if step % self.tcfg.log_every == 0 or step == 1:
                self.history.append({"step": step, "dt": t.dt, **metrics})
                log.info("step %d loss %.4f gnorm %.3f %.0fms", step,
                         metrics["loss"], metrics["grad_norm"], t.dt * 1e3)
            if step % self.tcfg.ckpt_every == 0 \
                    or step == self.tcfg.total_steps:
                self._save(step, storage, opt_state)
        self.ckpt.wait()
        return storage, opt_state, self.history

