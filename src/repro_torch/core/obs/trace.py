"""Plan-aligned Chrome/Perfetto trace emitter (port of
`repro.core.obs.trace`).

Walks the SAME executed schedules the cost models walk and lays them out
as trace-event JSON (`chrome://tracing` / Perfetto "trace event format"):

  * collective lanes — the pooled cyclic (AG, RS, compute) hiding windows
    `core/autowrap.partition_exposure` scores.  The layout is constructed
    so that the comm-lane span time NOT covered by a compute-lane span
    equals the modeled exposure: window i issues pool i's all-gather and
    pool i-1's reduce-scatter against pool i-1's compute, the window
    advances by max(compute, comm), and the quant codec overhead (never
    hidden — it is unoverlappable critical-path work) is appended after
    the window.  `nonoverlapped_comm_s` recovers the number from the
    emitted JSON alone.
  * ring lanes — per-hop exchange vs per-hop attention compute from a
    ring-cost dict (the reference's `core/context.ring_cost`; live hops
    hide an exchange, skipped hops expose theirs).
  * serving lanes — a `core/serving` ContinuousBatcher's virtual-clock
    event log (admission, prefill chunks, decode windows, preemptions,
    finishes);
  * pipeline lanes need `core/pipeline`'s slot tables, which are not
    ported yet: they raise.

Modeled lanes live under their own pid; measured spans (`measured_span`,
`measured_overlay`) render under a second pid next to them, so overlap is
visually auditable plan-vs-reality in one timeline.

Everything modeled here is host math over the frozen plan — two
emissions of the same plan are byte-identical, and equal the reference's
under the same `core/hw` profile.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

from repro_torch.core import hw
from repro_torch.core.autowrap import _active, _cfg_precision
from repro_torch.core.irgraph import (ag_time, build_nodes, quant_overhead_s,
                                      rs_time)

US = 1e6      # trace-event timestamps are microseconds

PID_MODELED = 1
PID_MEASURED = 2
PID_SERVING = 3

TID_COMPUTE = 0
TID_COMM = 1
TID_RING_COMM = 2
TID_RING_COMPUTE = 3
TID_STRAGGLER = 4             # per-rank straggler gauge (measured pid)
TID_PIPE_BASE = 10            # + stage rank

SERVE_TID_ADMIT = 0
SERVE_TID_PREFILL = 1
SERVE_TID_DECODE = 2
SERVE_TID_PREEMPT = 3


class TraceBuilder:
    """Accumulates trace events; serializes deterministically."""

    def __init__(self):
        self.events: list[dict] = []
        self._origin: float | None = None   # wall-clock zero (measured pid)

    # ------------------------------------------------------- metadata ----
    def process(self, pid: int, name: str) -> None:
        self.events.append({"ph": "M", "pid": pid, "tid": 0,
                            "name": "process_name", "args": {"name": name}})

    def thread(self, pid: int, tid: int, name: str) -> None:
        self.events.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": name}})

    # --------------------------------------------------------- events ----
    def span(self, pid: int, tid: int, name: str, ts_s: float, dur_s: float,
             cat: str = "modeled", args: dict | None = None) -> None:
        # no rounding: adjacent spans must stay exactly adjacent (the
        # within-lane no-overlap invariant is asserted at float precision)
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name, "cat": cat,
              "ts": ts_s * US, "dur": dur_s * US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, pid: int, tid: int, name: str, ts_s: float,
                cat: str = "modeled", args: dict | None = None) -> None:
        ev = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
              "cat": cat, "ts": ts_s * US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ----------------------------------------------- measured wall clock --
    @contextlib.contextmanager
    def measured_span(self, name: str, tid: int = 0, cat: str = "measured",
                      device=None):
        """Wall-clock span hook: renders under PID_MEASURED next to the
        modeled lanes.  First use pins the trace's wall-clock origin.  With
        a CUDA `device`, the device is synchronized at both ends, so the
        span covers the work queued inside it, not just its launches."""
        dev = None if device is None else torch.device(device)
        sync = dev is not None and dev.type == "cuda"
        if sync:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if self._origin is None:
            self._origin = t0
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            self.span(PID_MEASURED, tid, name, t0 - self._origin, t1 - t0,
                      cat=cat)

    # ------------------------------------------------------ serialize ----
    def to_doc(self) -> dict:
        order = {"M": 0, "X": 1, "i": 1}
        evs = sorted(self.events,
                     key=lambda e: (e["pid"], e["tid"], order[e["ph"]],
                                    e.get("ts", -1.0), e["name"]))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), sort_keys=True)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


# ---------------------------------------------------------------------------
# collective lanes: the pooled cyclic hiding windows, materialized
# ---------------------------------------------------------------------------
def comm_windows(plan, metas_tree, cfg, stats=None, segments=None
                 ) -> list[dict]:
    """The pooled (ag, rs, comp, overhead) windows `partition_exposure`
    scores, one dict per pool, resolved with the SAME rewrite
    `exposed_comm_time` applies (split at segment boundaries,
    segment-major order, per-bucket precisions).  Summing
    ``overhead + max(0, ag_i + rs_{i-1} - comp_{i-1})`` cyclically over
    these windows reproduces `exposed_s` exactly — the invariant the
    trace layout rests on."""
    nodes = {n.name: n for n in build_nodes(metas_tree, cfg, stats)}
    pools = None
    if _active(segments):
        from repro_torch.core.bucketing import (assign_segments,
                                                split_plan_at_segments)
        from repro_torch.core.meta import named_leaves

        plan = split_plan_at_segments(plan, metas_tree, segments)
        names = [k for k, _ in named_leaves(metas_tree)]
        seg_of = assign_segments(names, segments.param_globs, segments.names)
        name_seg = dict(zip(names, seg_of))
        pools = [name_seg[grp[0]] for grp in plan.groups]
    groups = [[nodes[name] for name in grp] for grp in plan.groups]
    if pools is None:
        pools = list(range(len(groups)))
    if plan.precisions is not None:
        precisions = list(plan.precisions)
    else:
        precisions = [_cfg_precision(cfg)] * len(groups)

    windows: list[dict] = []
    cur_id = None
    for pid, grp, prec in zip(pools, groups, precisions):
        if pid != cur_id:
            windows.append({"pool": pid, "ag_s": 0.0, "rs_s": 0.0,
                            "comp_s": 0.0, "overhead_s": 0.0,
                            "n_params": 0, "precisions": []})
            cur_id = pid
        w = windows[-1]
        w["ag_s"] += ag_time(grp, cfg, prec)
        w["rs_s"] += rs_time(grp, cfg, prec)
        w["comp_s"] += sum(n.t_comp() for n in grp)
        w["overhead_s"] += quant_overhead_s(grp, prec)
        w["n_params"] += len(grp)
        w["precisions"].append(prec)
    return windows


def emit_comm_lanes(tb: TraceBuilder, windows: list[dict],
                    pid: int = PID_MODELED, t0: float = 0.0,
                    repeats: int = 1) -> dict:
    """Lay the cyclic steady state out as spans.  Per window step i:
    pool i-1's compute span and, concurrently on the comm lane, pool i's
    AG then pool i-1's RS; the clock advances by max(compute, comm), then
    the quant codec overhead of pool i runs unhidden.  Comm-lane time not
    covered by a compute span is therefore exactly the modeled
    exposure."""
    k = len(windows)
    t = t0
    exposed = comm_total = comp_total = 0.0
    for rep in range(repeats):
        for i in range(k):
            w, prev = windows[i], windows[(i - 1) % k]
            comp, ag, rs = prev["comp_s"], w["ag_s"], prev["rs_s"]
            oh = w["overhead_s"]
            if comp > 0.0:
                tb.span(pid, TID_COMPUTE, f"compute[pool {prev['pool']}]",
                        t, comp, cat="compute",
                        args={"layer": rep, "pool": prev["pool"]})
            if ag > 0.0:
                tb.span(pid, TID_COMM, f"AG[pool {w['pool']}]", t, ag,
                        cat="all_gather",
                        args={"layer": rep, "pool": w["pool"],
                              "precisions": list(w["precisions"])})
            if rs > 0.0:
                tb.span(pid, TID_COMM, f"RS[pool {prev['pool']}]", t + ag,
                        rs, cat="reduce_scatter",
                        args={"layer": rep, "pool": prev["pool"]})
            adv = max(comp, ag + rs)
            if oh > 0.0:
                tb.span(pid, TID_COMM, f"quant[pool {w['pool']}]", t + adv,
                        oh, cat="quant", args={"layer": rep})
            exposed += max(0.0, ag + rs - comp) + oh
            comm_total += ag + rs + oh
            comp_total += comp
            t += adv + oh
    return {"end_s": t, "exposed_s": exposed, "comm_s": comm_total,
            "compute_s": comp_total}


# ---------------------------------------------------------------------------
# measured overlay: the profiler's numbers, span-for-span next to modeled
# ---------------------------------------------------------------------------
def measured_overlay(tb: TraceBuilder, windows: list[dict], profile,
                     repeats: int = 1, t0: float = 0.0) -> dict:
    """Second process (PID_MEASURED): the SAME cyclic walk as
    `emit_comm_lanes`, with span durations resolved from a frozen
    `MeasuredProfile` instead of the cost model — compute spans carry the
    profiled segment scales, AG/RS spans the measured-over-modeled
    collective ratio, quant spans the measured codec rate.  Every span is
    aligned span-for-span with its modeled twin (same name, same
    lane, same walk order) and carries {modeled_s, measured_s,
    rel_residual} args, so "which window is the model wrong about" is a
    trace click.  A per-rank straggler gauge rides its own lane.  Pure
    host math over the frozen profile — two emissions are
    byte-identical.  PID_MODELED is untouched, so `nonoverlapped_comm_s`
    (the exposed_s invariant) is preserved by construction.  The quant
    ratio is taken against the active profile's analytic codec prior
    (HBM bandwidth / 2)."""
    tb.process(PID_MEASURED,
               f"measured profile [{profile.meta.get('plan', '?')}]")
    tb.thread(PID_MEASURED, TID_COMPUTE, "compute (measured)")
    tb.thread(PID_MEASURED, TID_COMM, "collectives (measured)")

    # per-pool compute scale: pool ids are segment indices when the plan
    # is segmented (seg_names carries the index -> name order), bucket
    # indices otherwise (a single unsegmented scale covers them all)
    seg_names = list(profile.meta.get("seg_names", []))
    scales = profile.seg_scales or {}

    def comp_scale(pool) -> float:
        if len(seg_names) == 1:
            return scales.get(seg_names[0], 1.0)
        if isinstance(pool, int) and 0 <= pool < len(seg_names):
            return scales.get(seg_names[pool], 1.0)
        return scales.get(str(pool), 1.0)

    # one global measured/modeled ratio per collective kind, from the
    # profiler's per-bucket rows (1.0 = unseen: measured == modeled)
    def span_ratio(cat: str) -> float:
        meas = sum(s["dur_s"] for s in profile.spans
                   if s.get("cat") == cat and s.get("modeled_s"))
        mod = sum(s["modeled_s"] for s in profile.spans
                  if s.get("cat") == cat and s.get("modeled_s"))
        return meas / mod if mod > 0.0 and meas > 0.0 else 1.0

    ag_ratio = span_ratio("all_gather")
    rs_ratio = span_ratio("reduce_scatter")
    q_rates = profile.quant_rates or {}
    q_ratio = ((hw.active().hbm_bandwidth / 2.0)
               / (sum(q_rates.values()) / len(q_rates))) if q_rates else 1.0

    def emit(tid, name, cat, t, modeled, measured, args):
        rel = (measured - modeled) / modeled if modeled else 0.0
        tb.span(PID_MEASURED, tid, name, t, measured, cat=cat,
                args={**args, "modeled_s": modeled, "measured_s": measured,
                      "rel_residual": rel})

    k = len(windows)
    t = t0
    for rep in range(repeats):
        for i in range(k):
            w, prev = windows[i], windows[(i - 1) % k]
            comp_m = prev["comp_s"] * comp_scale(prev["pool"])
            ag_m = w["ag_s"] * ag_ratio
            rs_m = prev["rs_s"] * rs_ratio
            oh_m = w["overhead_s"] * q_ratio
            if prev["comp_s"] > 0.0:
                emit(TID_COMPUTE, f"compute[pool {prev['pool']}]",
                     "compute", t, prev["comp_s"], comp_m,
                     {"layer": rep, "pool": prev["pool"]})
            if w["ag_s"] > 0.0:
                emit(TID_COMM, f"AG[pool {w['pool']}]", "all_gather", t,
                     w["ag_s"], ag_m, {"layer": rep, "pool": w["pool"]})
            if prev["rs_s"] > 0.0:
                emit(TID_COMM, f"RS[pool {prev['pool']}]",
                     "reduce_scatter", t + ag_m, prev["rs_s"], rs_m,
                     {"layer": rep, "pool": prev["pool"]})
            adv = max(comp_m, ag_m + rs_m)
            if w["overhead_s"] > 0.0:
                emit(TID_COMM, f"quant[pool {w['pool']}]", "quant",
                     t + adv, w["overhead_s"], oh_m, {"layer": rep})
            t += adv + oh_m

    ranks = sorted((profile.rank_step_s or {}).items())
    if ranks:
        tb.thread(PID_MEASURED, TID_STRAGGLER, "straggler (per rank)")
        mean = sum(v for _, v in ranks) / len(ranks)
        for r, v in ranks:
            tb.instant(PID_MEASURED, TID_STRAGGLER, f"rank {r} step", t0,
                       cat="straggler",
                       args={"rank": r, "step_s": v,
                             "rel_vs_mean": (v - mean) / mean
                             if mean else 0.0})
    return {"end_s": t, "ag_ratio": ag_ratio, "rs_ratio": rs_ratio,
            "quant_ratio": q_ratio}


# ---------------------------------------------------------------------------
# pipeline lanes: one lane per stage rank, spans from the slot tables
# ---------------------------------------------------------------------------
def pipeline_lanes(tb: TraceBuilder, n_micro: int, n_stages: int,
                   schedule: str, virtual: int = 1, slot_s: float = 1e-3,
                   pid: int = PID_MODELED, t0: float = 0.0) -> float:
    """F/B/W spans per stage rank from `core/pipeline`'s slot tables."""
    raise NotImplementedError(
        "pipeline_lanes needs core/pipeline's slot tables, which are not "
        "yet ported to repro_torch")


# ---------------------------------------------------------------------------
# ring lanes: per-hop ppermute exchange vs per-hop attention compute
# ---------------------------------------------------------------------------
def ring_lanes(tb: TraceBuilder, ring: dict, pid: int = PID_MODELED,
               t0: float = 0.0) -> float:
    """One layer's ring-attention schedule from `core/context.ring_cost`:
    `live-1` exchanges ride a compute hop (hidden up to the spill), the
    remaining `cp-1-live+1` windowed-out exchanges run bare."""
    cp = ring["cp"]
    if cp <= 1:
        return t0
    comm, comp = ring["hop_comm_s"], ring["hop_comp_s"]
    hidden = max(0, ring["live_hops"] - 1)
    t = t0
    # hop 0: the local block's attention compute, exchange 1 in flight
    tb.span(pid, TID_RING_COMPUTE, "ring attn[hop 0]", t, comp, cat="ring")
    for h in range(cp - 1):
        tb.span(pid, TID_RING_COMM, f"ppermute[{h}]", t, comm, cat="ring",
                args={"hop": h, "bytes": ring["hop_bytes"]})
        if h < hidden:
            if h > 0:
                tb.span(pid, TID_RING_COMPUTE, f"ring attn[hop {h}]", t,
                        comp, cat="ring")
            t += max(comm, comp)
        else:
            t += comm      # windowed-out hop: exchange runs, compute skipped
    return t


# ---------------------------------------------------------------------------
# serving lanes: the batcher's virtual-clock event log
# ---------------------------------------------------------------------------
def serving_lanes(tb: TraceBuilder, batcher, pid: int = PID_SERVING,
                  t0: float = 0.0) -> float:
    """Render a `ContinuousBatcher`'s event log (`enable_trace()` before
    driving it).  Virtual timestamps are already monotonic per lane, so
    spans never overlap within a lane by construction."""
    events = getattr(batcher, "events", None)
    if events is None:
        raise ValueError(
            "batcher has no event log; call batcher.enable_trace() before "
            "driving it (run_virtual(..., trace=True))")
    tb.process(pid, "serving (virtual clock)")
    tb.thread(pid, SERVE_TID_ADMIT, "admission")
    tb.thread(pid, SERVE_TID_PREFILL, "prefill chunks")
    tb.thread(pid, SERVE_TID_DECODE, "decode windows")
    tb.thread(pid, SERVE_TID_PREEMPT, "preemption/finish")
    end = t0
    for ev in events:
        kind = ev[0]
        if kind == "admit":
            _, t, rid = ev
            tb.instant(pid, SERVE_TID_ADMIT, f"admit r{rid}", t0 + t,
                       cat="serving")
        elif kind == "prefill":
            _, ts, te, rid, n = ev
            tb.span(pid, SERVE_TID_PREFILL, f"prefill r{rid} +{n}", t0 + ts,
                    te - ts, cat="serving", args={"rid": rid, "tokens": n})
            end = max(end, t0 + te)
        elif kind == "decode":
            _, ts, te, nseq = ev
            tb.span(pid, SERVE_TID_DECODE, f"decode x{nseq}", t0 + ts,
                    te - ts, cat="serving", args={"batch": nseq})
            end = max(end, t0 + te)
        elif kind == "preempt":
            _, t, rid = ev
            tb.instant(pid, SERVE_TID_PREEMPT, f"preempt r{rid}", t0 + t,
                       cat="serving")
        elif kind == "finish":
            _, t, rid = ev
            tb.instant(pid, SERVE_TID_PREEMPT, f"finish r{rid}", t0 + t,
                       cat="serving")
    return end


# ---------------------------------------------------------------------------
# the one-call entry point: everything a ParallelPlan implies
# ---------------------------------------------------------------------------
def plan_comm_windows(model, plan, shape) -> list[dict]:
    """Resolve (metas, stats, segments) for the plan's main stacked group
    exactly the way `plan_parallel` did, then build the hiding windows."""
    dcfg = plan.dcfg
    metas = model.metas(dcfg)
    key = "blocks" if "blocks" in plan.bucket_plans \
        else next(iter(plan.bucket_plans))
    stats = None
    if shape is not None and hasattr(model, "block_stats") \
            and key == "blocks":
        b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
        stats = model.block_stats(
            dcfg, (b_local, shape.seq_len // max(1, dcfg.cp_size)))
    segments = model.block_segments(dcfg) \
        if key == "blocks" and hasattr(model, "block_segments") else None
    return comm_windows(plan.bucket_plans[key], metas[key], dcfg,
                        stats=stats, segments=segments)


def plan_trace(model, plan, shape, *, repeats: int = 1, batcher=None,
               arch_cfg=None, profile=None,
               tb: TraceBuilder | None = None) -> TraceBuilder:
    """Full modeled timeline of a frozen `ParallelPlan`: collective
    hiding windows (`repeats` steady-state layers) and, optionally, a
    traced serving batcher's lanes (`batcher`).  Pass a frozen
    `MeasuredProfile` as `profile` to also render the measured overlay
    (`measured_overlay`) under PID_MEASURED.  Pure host math:
    deterministic, no devices touched.  The reference's ring-attention
    lanes (a ctx axis) and pipeline lanes raise until their modules are
    ported."""
    tb = tb or TraceBuilder()
    dcfg = plan.dcfg
    tb.process(PID_MODELED, f"modeled plan [{plan.describe()}]")
    tb.thread(PID_MODELED, TID_COMPUTE, "compute")
    tb.thread(PID_MODELED, TID_COMM, "collectives (AG/RS/quant)")

    windows = plan_comm_windows(model, plan, shape)
    emit_comm_lanes(tb, windows, repeats=repeats)
    if profile is not None:
        measured_overlay(tb, windows, profile, repeats=repeats)

    if dcfg.cp_size > 1 and arch_cfg is not None:
        raise NotImplementedError(
            "plan_trace's ring lanes need core/context.ring_cost, which is "
            "not yet ported to repro_torch")
    if batcher is not None:
        serving_lanes(tb, batcher)
    return tb


# ---------------------------------------------------------------------------
# reading traces back (tests + drift reports)
# ---------------------------------------------------------------------------
def lane_spans(doc: dict, pid: int, tid: int) -> list[tuple[float, float]]:
    """(ts, dur) of every complete event in one lane, sorted by ts."""
    return sorted((e["ts"], e["dur"]) for e in doc["traceEvents"]
                  if e["ph"] == "X" and e["pid"] == pid and e["tid"] == tid)


def nonoverlapped_comm_s(doc: dict, pid: int = PID_MODELED,
                         comm_tid: int = TID_COMM,
                         compute_tid: int = TID_COMPUTE) -> float:
    """Comm-lane span time NOT covered by any compute-lane span, computed
    from the emitted JSON alone — the trace-side measurement of the
    planner's `exposed_s`."""
    compute = [(ts, ts + d) for ts, d in lane_spans(doc, pid, compute_tid)]
    total = 0.0
    for ts, d in lane_spans(doc, pid, comm_tid):
        t0, t1 = ts, ts + d
        covered = 0.0
        for c0, c1 in compute:
            covered += max(0.0, min(t1, c1) - max(t0, c0))
        total += (t1 - t0) - covered
    return total / US
