"""Modeled-vs-measured drift monitor (port of `repro.core.obs.drift`).

The repo's planners promise numbers — step time (exposure + roofline
compute), per-device peak (live-range memory simulator).  This module
records what actually happened next to what was promised, per step, and
names the subsystem whose model drifts worst; the Trainer's replan hook
reads the step-time channel.

Residuals are relative: (measured - modeled) / modeled.  Positive means
reality is slower/bigger than the model promised.  A record with
``modeled == 0`` carries no usable relative residual — it is stored with
the NaN sentinel and EXCLUDED from every aggregate (`mean_abs_rel`,
`worst()`), so one degenerate promise cannot poison a channel forever.
"""

from __future__ import annotations

import math

# channel -> the cost model on the hook for its residual
SUBSYSTEMS = {
    "step_time": "exposure/roofline cost model (core/autowrap + core/hw)",
    "peak_memory": "live-range memory simulator (core/memory)",
    "bubble": "pipeline schedule tables (core/pipeline)",
    "decode_rate": "serving roofline (core/serving ServePlan)",
}


class DriftMonitor:
    """Per-channel (modeled, measured) series + the pointed report.

    `registry`: optional `MetricsRegistry`; every record also lands as
    `drift/<channel>` gauges (the EWMA'd residual the router/autotuner
    side consumes)."""

    def __init__(self, registry=None):
        self.registry = registry
        self.records: dict[str, list[dict]] = {}

    def record(self, channel: str, modeled: float, measured: float,
               step: int | None = None) -> float:
        """Append one observation; returns the relative residual (NaN
        sentinel when ``modeled == 0`` — undefined, excluded from every
        aggregate)."""
        rel = (measured - modeled) / modeled if modeled else math.nan
        self.records.setdefault(channel, []).append(
            {"step": step, "modeled": modeled, "measured": measured,
             "rel": rel})
        if self.registry is not None:
            if math.isfinite(rel):
                self.registry.gauge(f"drift/{channel}/rel_residual").set(rel)
            self.registry.gauge(f"drift/{channel}/measured").set(measured)
            self.registry.gauge(f"drift/{channel}/modeled").set(modeled)
        return rel

    def residuals(self, channel: str) -> list[float]:
        return [r["rel"] for r in self.records.get(channel, [])]

    def summary(self) -> dict:
        """{channel: {n, modeled_mean, measured_mean, mean_abs_rel,
        last_rel, subsystem}} (the reference's per-arch drift record).
        Sentinel (non-finite) residuals are excluded from `mean_abs_rel`
        and `last_rel`; a channel with ONLY sentinels reports 0.0."""
        out = {}
        for ch, rows in self.records.items():
            finite = [r["rel"] for r in rows if math.isfinite(r["rel"])]
            out[ch] = {
                "n": len(rows),
                "modeled_mean": sum(r["modeled"] for r in rows) / len(rows),
                "measured_mean": sum(r["measured"] for r in rows) / len(rows),
                "mean_abs_rel": sum(abs(x) for x in finite) / len(finite)
                if finite else 0.0,
                "last_rel": finite[-1] if finite else 0.0,
                "subsystem": SUBSYSTEMS.get(ch, ch),
            }
        return out

    def worst(self) -> str | None:
        """Channel with the largest mean |relative residual|."""
        s = self.summary()
        if not s:
            return None
        return max(s, key=lambda ch: s[ch]["mean_abs_rel"])

    def report(self) -> str:
        """Human-readable drift report, worst-drifting subsystem first."""
        s = self.summary()
        if not s:
            return "drift: no observations recorded"
        w = self.worst()
        lines = [
            f"drift report ({sum(v['n'] for v in s.values())} observations)",
            f"  worst-drifting subsystem: {s[w]['subsystem']} "
            f"[{w}: mean |rel| {s[w]['mean_abs_rel']:.2f}]",
        ]
        for ch in sorted(s, key=lambda c: -s[c]["mean_abs_rel"]):
            v = s[ch]
            lines.append(
                f"  {ch:12s} n={v['n']:<4d} modeled {v['modeled_mean']:.3e} "
                f"measured {v['measured_mean']:.3e} "
                f"mean|rel| {v['mean_abs_rel']:.2f} "
                f"last {v['last_rel']:+.2f}")
        return "\n".join(lines)


def modeled_step_time(model, plan, shape) -> float | None:
    """The plan's own wall-clock promise for ONE optimizer step: per-layer
    roofline compute (forward + ~2x backward) plus the modeled exposed
    collective time, over the stacked depth.  This is the modeled side of
    the trainer's `step_time` drift channel — deliberately built from the
    same `exposed_comm_time` numbers the planners already trust, not a new
    model.  None when the model carries no cost contract.  Port plans are
    never pipelined (pp = 1); the reference's bubble inflation raises here
    until `core/pipeline` is ported."""
    from repro_torch.core.autowrap import exposed_comm_time

    if getattr(plan, "pipelined", False):
        raise NotImplementedError(
            "modeled_step_time of a pipelined plan (bubble_fraction) is not "
            "yet ported to repro_torch")
    dcfg = plan.dcfg
    key = "blocks" if "blocks" in plan.bucket_plans else None
    if key is None or not hasattr(model, "block_stats"):
        return None
    metas = model.metas(dcfg)
    b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
    stats = model.block_stats(
        dcfg, (b_local, shape.seq_len // max(1, dcfg.cp_size)))
    segments = model.block_segments(dcfg) \
        if hasattr(model, "block_segments") else None
    r = exposed_comm_time(plan.bucket_plans[key], metas[key], dcfg, stats,
                          segments=segments)
    per_layer = 3.0 * r["compute_s"] + r["exposed_s"]
    layers = max(1, plan.stacked_keys.get(key, 1))
    return layers * per_layer
