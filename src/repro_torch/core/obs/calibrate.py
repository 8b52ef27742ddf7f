"""Calibration + replan: feed measured rates back into the planners (port
of `repro.core.obs.calibrate`).

The replan half of the measured-cost loop: a frozen `MeasuredProfile`
(core/obs/profile.py) rewrites the model's cost contract and the hw rate
constants, and the ORIGINAL planners — bucket-partition/precision DP and
the `auto:<GB>` remat search — re-run against the calibrated numbers.
Nothing here plans; it only changes what the planners believe.

  * `calibrated_block_stats(stats, profile)` — per-segment multiplicative
    rewrite of BlockStats.  Monotone: a param the profiler never saw
    keeps its analytic value; an empty profile returns `stats` itself.
  * `calibration(profile)` — context manager installing the measured
    per-axis collective bandwidths (core/hw) and per-codec quant rates
    (core/irgraph), restoring the priors on exit.
  * `calibrated_step_time(model, plan, shape, profile)` — the plan's
    `modeled_step_time` promise re-evaluated under calibration.
  * `replan(model, plan, shape, profile)` — a NEW frozen `ParallelPlan`
    from `plan_parallel` under calibration (same DistConfig, so
    `parallelize(plan=...)` accepts it) plus a delta report.
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.core.irgraph import BlockStats, build_nodes


def calibrated_block_stats(stats: BlockStats | None,
                           profile) -> BlockStats | None:
    """Rewrite `stats` from the profile's measured per-segment rates.

    Each param's (flops, bytes) are multiplied by its segment's scale —
    scaling both scales the roofline `compute_time_s` linearly, so the
    calibrated stats reproduce the measured segment times under the
    unchanged cost model.  Monotone: params outside `param_segment` (or
    in a segment the profiler never timed) keep their analytic values;
    with no scales at all the SAME object comes back (identity)."""
    if stats is None or profile is None:
        return stats
    scales = getattr(profile, "seg_scales", None) or {}
    if not scales:
        return stats
    pseg = getattr(profile, "param_segment", None) or {}

    def s_for(name: str) -> float:
        return scales.get(pseg.get(name, ""), 1.0)

    return BlockStats(
        param_flops={k: v * s_for(k)
                     for k, v in stats.param_flops.items()},
        param_bytes={k: v * s_for(k)
                     for k, v in stats.param_bytes.items()},
        act_bytes=stats.act_bytes,
        source="calibrated",
        seg_act_bytes=stats.seg_act_bytes,
    )


@contextlib.contextmanager
def calibration(profile):
    """Install the profile's measured hw rates (per-axis collective
    bandwidth, per-codec quant throughput) for the dynamic extent of the
    block; the analytic priors are restored on exit.  An empty profile is
    a no-op."""
    from repro_torch.core import hw, irgraph

    comm = getattr(profile, "comm_bandwidth", None) or {}
    quant = getattr(profile, "quant_rates", None) or {}
    prev_bw: dict = {}
    prev_q: dict = {}
    try:
        for ax in sorted(comm):
            d = comm[ax]
            prev_bw[ax] = hw.set_measured_axis_bandwidth(
                ax, hw.AxisBandwidth(bytes_per_s=d["bytes_per_s"],
                                     alpha_s=d["alpha_s"]))
        for codec in sorted(quant):
            prev_q[codec] = irgraph.set_measured_quant_rate(
                quant[codec], codec)
        yield
    finally:
        for ax, prev in prev_bw.items():
            hw.set_measured_axis_bandwidth(ax, prev)
        for codec, prev in prev_q.items():
            irgraph.set_measured_quant_rate(prev, codec)


def _pin_activations(model, dcfg, base: BlockStats,
                     cal: BlockStats) -> BlockStats:
    """`cal` with the analytic activation footprint of `base` pinned as
    `seg_act_bytes`, per declared segment and for the whole block.

    `calibrated_block_stats` scales each param's bytes to scale its
    roofline time, but the memory simulator derives a segment's
    activations from the same bytes (`CommNode.act_out_bytes`), so a
    time scale of 10 would model 10x the activations: the reference's
    calibrated memory plans inflate so (a smoke step measured on the CPU
    models hundreds of GiB) that a budgeted `auto:<GB>` search finds no
    plan.  The simulator prefers `seg_act_bytes`, so pinning keeps
    the memory model what it was while compute times take the measured
    scales."""
    if cal is base or base.seg_act_bytes:
        return cal
    from repro_torch.core.bucketing import assign_segments

    nodes = build_nodes(model.block_metas(dcfg), dcfg, base)
    acts = {"block": sum(n.act_out_bytes() for n in nodes)}
    segs = model.block_segments(dcfg) \
        if hasattr(model, "block_segments") else None
    if segs is not None and len(segs.fns) > 1:
        seg_of = assign_segments([n.name for n in nodes], segs.param_globs,
                                 segs.names)
        for i, name in enumerate(segs.names):
            acts[name] = sum(n.act_out_bytes()
                             for n, sg in zip(nodes, seg_of) if sg == i)
    return dataclasses.replace(cal, seg_act_bytes=acts)


@contextlib.contextmanager
def _installed_stats(model, plan, shape, profile):
    """Yield with the model's cost contract swapped for the calibrated
    stats, activations pinned (`_pin_activations`; restored on exit);
    yields the installed BlockStats or None when the model carries no
    contract."""
    if not hasattr(model, "measured_stats") \
            or not hasattr(model, "block_stats"):
        yield None
        return
    dcfg = plan.dcfg
    b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
    base = model.block_stats(
        dcfg, (b_local, shape.seq_len // max(1, dcfg.cp_size)))
    cal = _pin_activations(model, dcfg, base,
                           calibrated_block_stats(base, profile))
    saved = model.measured_stats
    model.measured_stats = cal
    try:
        yield cal
    finally:
        model.measured_stats = saved


def calibrated_step_time(model, plan, shape, profile) -> float | None:
    """`modeled_step_time` of the plan with the calibrated stats
    installed and the measured hw rates active — the promise the drift
    monitor should hold a replanned run to."""
    from repro_torch.core.obs.drift import modeled_step_time

    with _installed_stats(model, plan, shape, profile), \
            calibration(profile):
        return modeled_step_time(model, plan, shape)


def replan(model, plan, shape, profile):
    """Re-run `plan_parallel` against the calibrated cost model; returns
    (new_plan, delta).

    The DistConfig is the original plan's — unchanged — so the new plan
    passes `parallelize`'s plan/dcfg equality check and every auto
    resolution (bucket partition + per-bucket precision, `auto:<GB>`
    remat) re-runs with the calibrated stats and measured rates.  `delta`
    records what changed and the modeled gain, both evaluated UNDER
    calibration so the two step times are comparable.  At pp = 1 the
    reference's other `fields` (remat, microbatches, the pipeline
    schedule) are the DistConfig's and never differ, so `fields` compares
    the bucket counts; a changed remat vector shows in `describe()`."""
    from repro_torch.core.api import plan_parallel
    from repro_torch.core.obs.drift import modeled_step_time

    with _installed_stats(model, plan, shape, profile), \
            calibration(profile):
        before_s = modeled_step_time(model, plan, shape)
        new_plan = plan_parallel(model, plan.dcfg, shape)
        after_s = modeled_step_time(model, new_plan, shape)

    def _buckets(p):
        return {k: len(bp.groups) for k, bp in p.bucket_plans.items()}

    fields = {}
    if _buckets(plan) != _buckets(new_plan):
        fields["n_buckets"] = [_buckets(plan), _buckets(new_plan)]
    delta = {
        "changed": new_plan.describe() != plan.describe(),
        "before": plan.describe(),
        "after": new_plan.describe(),
        "fields": fields,
        "modeled_step_before_s": before_s,
        "modeled_step_after_s": after_s,
        "modeled_gain_s": (before_s - after_s)
        if before_s is not None and after_s is not None else None,
        "wall_step_s": getattr(profile, "wall_step_s", None),
    }
    return new_plan, delta
