"""Measured-execution step profiler: the measurement half of the
profile -> calibrate -> replan loop (port of `repro.core.obs.profile`).

`profile_step(model, plan, shape)` times the EXECUTED schedule of a frozen
`ParallelPlan` at span granularity and freezes the result as a
JSON-serializable `MeasuredProfile` (the interchange format: a profile
written by either package loads into the other):

  * per-segment compute — each block segment (models/common.BlockSegments)
    runs alone on one device at the plan's per-device microbatch, under
    `torch.no_grad()`, on seeded normal inputs and parameters (all-zero
    GEMMs draw less power and can run faster than real data), with the
    state threaded from segment to segment.  Measured-over-modeled ratios
    become the per-segment scales `calibrated_block_stats` applies.
  * per-bucket AG/RS — the flat-buffer collectives
    (`core/collectives.gather_flat` / `reduce_scatter_flat`) timed at the
    plan's own bucket sizes on the process group; an effective per-axis
    bandwidth is fit for the calibration context.  A trivial FSDP domain
    (one rank) measures none.
  * quant codec — `launch/dryrun.harvest_quant_timing`, once per wire
    codec the plan (or the 'auto' lattice) can use.
  * wall step — `steps` full optimizer steps through the plan's own train
    step, unless the caller passes the wall it measured; per-rank rows
    when a process group of more than one rank is up.

Times are CUDA-event times on the card and host-clock times on the CPU.
The analytic model prices the active `core/hw` profile's roofline, so a
global closure factor is folded into the segment scales: the plan's own
`modeled_step_time`, re-evaluated with the calibrated stats, lands on the
measured wall step.  With more than one rank, every rank takes rank 0's
profile, so every rank replans to the same plan.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.core import hw
from repro_torch.core.dist import precision_codecs, resolve_device
from repro_torch.core.irgraph import build_nodes
from repro_torch.launch.dryrun import elapsed_s, harvest_quant_timing


@dataclasses.dataclass(frozen=True)
class MeasuredProfile:
    """Frozen result of one `profile_step` run.  JSON-serializable; every
    consumer (`calibrated_block_stats`, `calibration`, the trace overlay)
    reads it read-only, so two emissions from the same profile are
    byte-identical."""

    # provenance: arch/plan describe, steps, backend, closure factor,
    # segment-name order (segment index -> name, for the trace overlay)
    meta: dict = dataclasses.field(default_factory=dict)
    # measured wall clock of ONE optimizer step (median over steps)
    wall_step_s: float = 0.0
    # raw span table: {"name", "cat", "dur_s", ...} rows in record order
    spans: tuple = ()
    # segment name -> multiplicative scale on that segment's analytic
    # (flops, bytes) — scaling both scales the roofline time linearly
    seg_scales: dict = dataclasses.field(default_factory=dict)
    # param name -> segment name (how the scales distribute over params)
    param_segment: dict = dataclasses.field(default_factory=dict)
    # mesh axis -> {"bytes_per_s", "alpha_s"} measured collective bandwidth
    comm_bandwidth: dict = dataclasses.field(default_factory=dict)
    # wire codec -> measured roundtrip rate (bytes of input / s)
    quant_rates: dict = dataclasses.field(default_factory=dict)
    # process rank -> measured wall step (straggler rows)
    rank_step_s: dict = dataclasses.field(default_factory=dict)

    def is_empty(self) -> bool:
        return not (self.seg_scales or self.comm_bandwidth
                    or self.quant_rates)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MeasuredProfile":
        d = json.loads(s)
        d["spans"] = tuple(d.get("spans", ()))
        return cls(**d)

    @classmethod
    def empty(cls) -> "MeasuredProfile":
        return cls(meta={"source": "empty"})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _dcfg1(dcfg):
    """The degenerate one-device config the segment timings run at."""
    return dcfg.with_(mesh_axes=("data", "model"), mesh_shape=(1, 1),
                      fsdp_axes=("data",), microbatches=1)


def _time_fn(fn, iters: int, dev: torch.device) -> float:
    """Median time of one `fn()` call over `iters` calls, after one
    warm-up call that absorbs builds and allocator growth."""
    fn()
    return statistics.median(elapsed_s(fn, 1, dev)
                             for _ in range(max(1, iters)))


# ---------------------------------------------------------------------------
# per-segment compute
# ---------------------------------------------------------------------------
def _profile_segments(model, dcfg, bshape, iters, spans, dev):
    """Run each block segment alone on one device; return (seg_scales,
    param_segment, seg_names).  Scales are measured-over-modeled at the
    SAME one-device config and shape, so they transfer multiplicatively to
    the target mesh's analytic stats."""
    from repro_torch.core.bucketing import assign_segments
    from repro_torch.core.meta import leaves, named_leaves, tree_map, \
        unflatten_like

    if not (hasattr(model, "block_stats") and hasattr(model, "block_metas")
            and hasattr(model, "block_fn")):
        return {}, {}, []
    saved = getattr(model, "measured_stats", None)
    if hasattr(model, "measured_stats"):
        model.measured_stats = None
    try:
        dcfg1 = _dcfg1(dcfg)
        an_ref = model.block_stats(dcfg1, bshape)
    finally:
        if hasattr(model, "measured_stats"):
            model.measured_stats = saved

    metas = model.block_metas(dcfg1)
    B, S = bshape
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std) \
            .to(dcfg1.param_dtype)

    consts = model.consts(S, dev)
    x = randn((B, S, model.cfg.d_model))
    params = tree_map(lambda m: randn(m.local_shape(dcfg1), 0.02), metas)
    names = [k for k, _ in named_leaves(metas)]
    nodes = {n.name: n for n in build_nodes(metas, dcfg1, an_ref)}

    segments = model.block_segments(dcfg1) \
        if hasattr(model, "block_segments") else None
    if segments is not None and len(segments.fns) > 1:
        seg_names = list(segments.names)
        seg_of = assign_segments(names, segments.param_globs, seg_names)
        seg_fns = list(segments.fns)
    else:
        seg_names = ["block"]
        seg_of = [0] * len(names)
        seg_fns = [lambda p, c, st: model.block_fn(p, c, st, dcfg1)]

    flat = leaves(params)
    param_segment = {n: seg_names[sg] for n, sg in zip(names, seg_of)}
    seg_scales = {}
    state = x
    with torch.no_grad():
        for s, seg_name in enumerate(seg_names):
            masked = unflatten_like(params, [
                lf if seg_of[i] == s else None for i, lf in enumerate(flat)])

            def call(s=s, masked=masked, state=state):
                return seg_fns[s](masked, consts, state)

            dt = _time_fn(call, iters, dev)
            state = call()
            modeled = sum(nodes[n].t_comp()
                          for n, sg in zip(names, seg_of) if sg == s)
            spans.append({"name": f"compute[{seg_name}]", "cat": "compute",
                          "dur_s": dt, "modeled_s": modeled,
                          "segment": seg_name})
            if modeled > 0.0 and dt > 0.0:
                seg_scales[seg_name] = dt / modeled
    return seg_scales, param_segment, seg_names


# ---------------------------------------------------------------------------
# per-bucket collectives through the flat-buffer path
# ---------------------------------------------------------------------------
def _profile_collectives(model, plan, iters, spans, dev,
                         cap_elems: int = 1 << 20):
    """Time one flat-buffer all-gather + reduce-scatter per bucket of the
    plan's main group and fit an effective bandwidth per FSDP axis.
    Skipped (empty dict back) when the FSDP domain is trivial or the
    process group cannot host the plan's mesh."""
    from repro_torch.core import collectives as C

    dcfg = plan.dcfg
    if dcfg.fsdp_size <= 1 or dcfg.n_devices > _world():
        return {}
    key = "blocks" if "blocks" in plan.bucket_plans \
        else next(iter(plan.bucket_plans))
    metas = model.block_metas(dcfg) if key == "blocks" \
        and hasattr(model, "block_metas") else None
    if metas is None:
        return {}
    nodes = {n.name: n for n in build_nodes(metas, dcfg, None)}
    fsdp = dcfg.fsdp_size
    itemsize = dcfg.param_dtype.itemsize
    axes = dcfg.fsdp_axes
    frac = sum((dcfg.axis_size(a) - 1) / dcfg.axis_size(a)
               for a in axes if dcfg.axis_size(a) > 1)
    gen = torch.Generator(device=dev).manual_seed(0)

    rows = []
    for i, grp in enumerate(plan.bucket_plans[key].groups):
        n_tot = sum(nodes[p].n_elems for p in grp if p in nodes)
        if n_tot <= 0:
            continue
        shard = min(max(1, n_tot // fsdp), cap_elems)
        buf = torch.randn(shard, generator=gen, device=dev) \
            .to(dcfg.param_dtype)
        ct = torch.randn((fsdp, shard), generator=gen, device=dev) \
            .to(dcfg.param_dtype)
        t_ag = _time_fn(lambda: C.gather_flat(buf, dcfg), iters, dev)
        t_rs = _time_fn(lambda: C.reduce_scatter_flat(ct, dcfg), iters, dev)
        nbytes = fsdp * shard * itemsize
        modeled = hw.collective_time_s(nbytes, dcfg.axis_sizes, axes)
        spans.append({"name": f"AG[bucket {i}]", "cat": "all_gather",
                      "dur_s": t_ag, "modeled_s": modeled,
                      "bytes": nbytes, "bucket": i})
        spans.append({"name": f"RS[bucket {i}]", "cat": "reduce_scatter",
                      "dur_s": t_rs, "modeled_s": modeled,
                      "bytes": nbytes, "bucket": i})
        rows.append((nbytes, t_ag, t_rs))
    if not rows or frac <= 0.0:
        return {}
    # effective bandwidth from the largest timed bucket (alpha ~ 0 there),
    # split evenly over the active FSDP axes: t = frac * n / bw
    nbytes, t_ag, t_rs = max(rows)
    t = (t_ag + t_rs) / 2.0
    bw = frac * nbytes / max(1e-12, t)
    n_active = sum(1 for a in axes if dcfg.axis_size(a) > 1)
    # residual fixed cost from the smallest bucket, floored at zero
    nb0, ta0, tr0 = min(rows)
    alpha = max(0.0, (ta0 + tr0) / 2.0 - frac * nb0 / bw) / max(1, n_active)
    return {a: {"bytes_per_s": bw, "alpha_s": alpha}
            for a in axes if dcfg.axis_size(a) > 1}


# ---------------------------------------------------------------------------
# quant codec rates (the dryrun harvest, per codec in play)
# ---------------------------------------------------------------------------
def _plan_codecs(plan) -> list[str]:
    """Wire codecs the plan executes — or, under comm_precision='auto',
    every codec the planner lattice can assign (so a replan can price
    int8 against fp8 with measured rates on both)."""
    dcfg = plan.dcfg
    if dcfg.comm_precision == "bf16":
        return []
    if dcfg.comm_precision == "auto":
        return ["fp8", "int8"]
    codecs = set()
    for bp in plan.bucket_plans.values():
        for prec in (bp.precisions or [dcfg.comm_precision]):
            codecs.update(c for c in precision_codecs(prec) if c)
    return sorted(codecs)


def _profile_quant(model, plan, spans, dev) -> dict:
    codecs = _plan_codecs(plan)
    if not codecs:
        return {}
    key = "blocks" if "blocks" in plan.bucket_plans \
        else next(iter(plan.bucket_plans))
    metas = model.block_metas(plan.dcfg) if hasattr(model, "block_metas") \
        else None
    if metas is None:
        return {}
    nodes = {n.name: n for n in build_nodes(metas, plan.dcfg, None)}
    elems = [sum(nodes[p].n_elems for p in grp if p in nodes)
             for grp in plan.bucket_plans[key].groups]
    rates = {}
    for codec in codecs:
        q = harvest_quant_timing(elems, codec=codec, device=dev)
        if q is None:
            continue
        rates[codec] = q["rate_bytes_per_s"]
        for s in q["samples"]:
            spans.append({"name": f"quant[{codec} n={s['n_elems']}]",
                          "cat": "quant", "dur_s": s["t_us"] * 1e-6,
                          "bytes": s["bytes"], "codec": codec})
    return rates


# ---------------------------------------------------------------------------
# wall step through the plan's own train step
# ---------------------------------------------------------------------------
def _profile_wall(model, plan, shape, steps, spans, dev):
    """Median wall of `steps` optimizer steps of a second `parallelize` of
    the plan, after one warm-up step.  It makes its own train state: at
    full width, free the caller's first (the Trainer passes its measured
    wall instead and never comes here)."""
    from repro_torch.core.api import parallelize
    from repro_torch.data.pipeline import DataConfig, SyntheticC4, \
        adapt_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state

    par = parallelize(model, plan.dcfg, shape, device=dev, plan=plan)
    step_fn = par.train_step(AdamWConfig(lr=1e-3))
    storage, opt = init_train_state(
        par, torch.Generator(device=dev).manual_seed(0))
    data = SyntheticC4(DataConfig(vocab=model.cfg.vocab,
                                  seq_len=shape.seq_len,
                                  global_batch=shape.global_batch))
    batch = adapt_batch(data.batch(0), model.input_specs(shape, plan.dcfg),
                        step=0)
    storage, opt, _ = step_fn(storage, opt, batch)      # warm-up
    _sync(dev)
    walls = []
    for k in range(max(1, steps)):
        t0 = time.perf_counter()
        storage, opt, _ = step_fn(storage, opt, batch)
        _sync(dev)
        dt = time.perf_counter() - t0
        walls.append(dt)
        spans.append({"name": f"step[{k}]", "cat": "wall", "dur_s": dt})
    return statistics.median(walls)


# ---------------------------------------------------------------------------
# closure: fold the residual model error into the segment scales
# ---------------------------------------------------------------------------
def _close_scales(model, plan, shape, profile: MeasuredProfile,
                  rounds: int = 6, tol: float = 0.02) -> MeasuredProfile:
    """Multiply every segment scale by a common factor until the plan's
    own `modeled_step_time`, evaluated with the calibrated stats under the
    calibration context, lands on the measured wall step.  Fixed-point
    iteration — `modeled_step_time` is monotone in a uniform compute
    scale, so g <- g * wall / modeled converges in a few rounds."""
    from repro_torch.core.obs.calibrate import calibrated_step_time

    if not profile.seg_scales or profile.wall_step_s <= 0.0:
        return profile
    g, wall = 1.0, profile.wall_step_s
    base = dict(profile.seg_scales)
    for _ in range(rounds):
        trial = dataclasses.replace(
            profile, seg_scales={k: v * g for k, v in base.items()})
        m = calibrated_step_time(model, plan, shape, trial)
        if m is None or m <= 0.0:
            return profile
        if abs(m - wall) / wall <= tol:
            break
        g = min(1e12, max(1e-12, g * wall / m))
    meta = dict(profile.meta)
    meta["closure_factor"] = g
    return dataclasses.replace(
        profile, meta=meta,
        seg_scales={k: v * g for k, v in base.items()})


def profile_step(model, plan, shape, steps: int = 2,
                 wall_step_s: float | None = None,
                 device="cuda") -> MeasuredProfile:
    """Profile the executed schedule of a frozen plan on `device` (the
    card unless the caller asks for the CPU); returns the frozen
    `MeasuredProfile` (see the module docstring for what is timed).  Pass
    `wall_step_s` (e.g. the Trainer's own drift-measured step time) to
    skip re-executing the full train step.  A failure of any part raises:
    nothing falls back to an analytic number."""
    dev = resolve_device(device)
    dcfg = plan.dcfg
    spans: list[dict] = []
    # all of a rank's rows, the workload `modeled_step_time` prices (the
    # reference's pp = 1 plans carry microbatches = 0 here too)
    b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
    bshape = (b_local, shape.seq_len // max(1, dcfg.cp_size))

    seg_scales, param_segment, seg_names = _profile_segments(
        model, dcfg, bshape, steps, spans, dev)
    comm_bw = _profile_collectives(model, plan, steps, spans, dev)
    quant_rates = _profile_quant(model, plan, spans, dev)
    if wall_step_s is None:
        wall_step_s = _profile_wall(model, plan, shape, steps, spans, dev)
    else:
        spans.append({"name": "step[given]", "cat": "wall",
                      "dur_s": wall_step_s})

    rank = dist.get_rank() if dist.is_initialized() else 0
    rank_step_s = {str(rank): wall_step_s}
    if _world() > 1:
        walls = [None] * _world()
        dist.all_gather_object(walls, wall_step_s)
        rank_step_s = {str(r): float(w) for r, w in enumerate(walls)}

    backend = dev.type if dev.type != "cuda" \
        else f"cuda: {torch.cuda.get_device_name(dev)}"
    profile = MeasuredProfile(
        meta={"plan": plan.describe(),
              "arch": type(model).__name__,
              "steps": steps,
              "backend": backend,
              "seg_names": seg_names},
        wall_step_s=wall_step_s,
        spans=tuple(spans),
        seg_scales=seg_scales,
        param_segment=param_segment,
        comm_bandwidth=comm_bw,
        quant_rates=quant_rates,
        rank_step_s=rank_step_s,
    )
    if _world() > 1:
        # one profile for every rank, so that every rank replans alike
        obj = [profile.to_json()]
        dist.broadcast_object_list(obj, src=0)
        profile = MeasuredProfile.from_json(obj[0])
    return _close_scales(model, plan, shape, profile)
