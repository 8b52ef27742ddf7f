"""Budgeted auto-SAC planner: ``dcfg.remat="auto:<GB>"`` (port of
`repro.core.memory.planner`).

Chooses, under an explicit per-device HBM budget, the cheapest combination
of

  * a per-segment remat policy vector over `core/remat.POLICIES`,
  * optional host offload of optimizer state and segment-boundary
    residuals (`core/memory/offload.py`), and
  * the bucket partition of the main block stack — tighter buckets shrink
    the gathered peak but pay more collective alpha / exposure, so the
    search evaluates bucket candidates jointly with the policy vector
    against the same exposure objective the bucket DP optimizes
    (`core/autowrap.exposed_comm_time`),

minimizing the modeled recompute + exposed-communication + offload-traffic
cost per step, subject to `simulate_peak` <= budget.

The chosen vector is written back as the resolved `dcfg.remat` string (the
vector grammar of `core/remat.parse_policy_vector`), so the runtime applies
exactly what was planned — `core/api.ParallelPlan.exec_dcfg`.  The offload
decisions are recorded and priced, but, as in the reference, no step moves
state to the host.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core import hw
from repro_torch.core.autowrap import exposed_comm_time
from repro_torch.core.bucketing import BucketPlan, per_param_plan, plan_for
from repro_torch.core.dist import DistConfig
from repro_torch.core.irgraph import BlockStats
from repro_torch.core.memory.simulator import (BlockProfile, context_peaks,
                                               executed_segments,
                                               main_block_key, make_context,
                                               simulate_peak, storage_bytes)
from repro_torch.core.remat import (AUTO_PREFIX, POLICIES, parse_remat,
                                    resolve_segment_policies)

# modeled recompute weight per policy: the fraction of a segment's forward
# compute the backward pays again. fsdp_only re-gathers (comm, mostly
# hidden) plus cheap unpack work; save_dots redoes the elementwise tail;
# full redoes the whole segment forward.
RECOMPUTE_W = {"none": 0.0, "fsdp_only": 0.10, "save_dots": 0.35,
               "full": 1.0}


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Frozen memory-side decisions for one (model, dcfg, shape) — carried
    by `core/api.ParallelPlan.memory`."""

    main_key: str                       # the stacked group the vector wraps
    segment_names: tuple[str, ...]
    policies: tuple[str, ...]           # one per segment (len 1 when unsegmented)
    policy_spec: str                    # resolved dcfg.remat string form
    offload_opt_state: bool
    offload_residuals: bool
    budget_bytes: float | None          # None for fixed (non-auto) specs
    peak_bytes: tuple[float, ...]       # modeled per-device peak per stage
    cost_s: float                       # recompute+exposure+offload per step
    bucket_plan: BucketPlan | None      # override for main_key (None = keep)
    breakdown: tuple                    # MemoryBreakdown per stage

    @property
    def peak(self) -> float:
        return max(self.peak_bytes)

    def describe(self) -> str:
        gib = 1 / 1024**3
        pol = self.policy_spec
        off = "".join([",+opt_offload" if self.offload_opt_state else "",
                       ",+res_offload" if self.offload_residuals else ""])
        bud = (f" budget={self.budget_bytes*gib:.2f}GiB"
               if self.budget_bytes else "")
        return (f"remat[{pol}{off}]{bud} peak="
                f"{self.peak*gib:.2f}GiB cost={self.cost_s*1e3:.2f}ms")


def _policy_spec(policies: tuple[str, ...], seg_names) -> str:
    if len(set(policies)) == 1:
        return policies[0]
    if seg_names and seg_names != ("block",) \
            and len(seg_names) == len(policies):
        return ",".join(f"{n}={p}" for n, p in zip(seg_names, policies))
    return ",".join(policies)


def _policy_vectors(n_seg: int):
    """Candidate vectors, exhaustive when small. For very segment-rich
    blocks fall back to two-policy prefix mixes (which still cover every
    uniform vector), deduplicated."""
    if 4 ** n_seg <= 4096:
        yield from itertools.product(POLICIES, repeat=n_seg)
        return
    seen = set()
    for a in POLICIES:
        for b in POLICIES:
            for k in range(n_seg + 1):
                v = (a,) * k + (b,) * (n_seg - k)
                if v not in seen:
                    seen.add(v)
                    yield v


def _exposure_s(plan: BucketPlan, metas_tree, cfg, stats, segments) -> float:
    return exposed_comm_time(plan, metas_tree, cfg, stats,
                             segments=segments)["exposed_s"]


def _offload_cost_s(prof: BlockProfile, L_total: int, opt_bytes: float,
                    offload_opt: bool, offload_res: bool) -> float:
    """Per-step exposed transfer time of the host-offload channel.

    Optimizer state crosses twice per step (out after the update, back in
    before the next); residual copies are double-buffered per layer and
    only their spill over the layer's compute time is exposed."""
    p = hw.active()
    t = 0.0
    if offload_opt:
        t += p.host_dma_alpha_s + 2.0 * opt_bytes / p.host_dma_bw
    if offload_res:
        per_layer = 2.0 * prof.segments[0].input_bytes / p.host_dma_bw
        t += L_total * max(0.0, per_layer - prof.comp_s) \
            + L_total * p.host_dma_alpha_s
    return t


def plan_cost_s(prof: BlockProfile, policies, L_total: int,
                exposure_s: float, opt_bytes: float = 0.0,
                offload_opt: bool = False,
                offload_res: bool = False) -> float:
    """Modeled per-step cost of one candidate: backward recompute per the
    policy vector + steady-state exposed communication of the bucket
    partition + exposed offload traffic.  Relative metric — the planner's
    objective, also logged for cross-PR tracking."""
    recompute = sum(RECOMPUTE_W[p] * s.comp_s
                    for s, p in zip(prof.segments, policies))
    return L_total * (recompute + exposure_s) \
        + _offload_cost_s(prof, L_total, opt_bytes, offload_opt, offload_res)


def _batch_shape_for(dcfg: DistConfig, shape, microbatches: int):
    # rows shard over batch_dp, the sequence over the ctx axis — the
    # simulator's activation terms see the true per-device token count
    b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
    mb = microbatches or dcfg.microbatches or 1
    return (max(1, b_local // max(1, mb)),
            shape.seq_len // max(1, dcfg.cp_size))


def auto_microbatches(model, dcfg: DistConfig, shape,
                      budget: float | None = None, stage=None,
                      act_scale: float | None = None) -> int:
    """Smallest microbatch count whose modeled per-device peak fits
    `budget` (the active profile's HBM by default).

    Candidates are divisors of the per-device row count, ascending (the
    step splits rows into equal microbatches).  Returns the deepest split
    when even it does not fit.  `act_scale` is a measured calibration
    factor of the activation terms; without one the pick uses 4.0, the
    reference's calibration ceiling (an optimistic split turns into an OOM
    at run time, a pessimistic one costs a few accumulation steps).  An
    unresolved ``remat='auto:<GB>'`` is evaluated at 'fsdp_only': the
    budgeted planner refines the policy afterwards."""
    if not hasattr(model, "block_stats"):
        return 1
    budget = budget or hw.active().hbm_bytes
    act_scale = 4.0 if act_scale is None else act_scale
    if parse_remat(dcfg.remat)[0] == AUTO_PREFIX:
        dcfg = dcfg.with_(remat="fsdp_only")
    b_local = max(1, shape.global_batch // max(1, dcfg.batch_dp))
    floor = stage.n_stages if stage is not None else 1
    cands = [d for d in range(1, b_local + 1)
             if b_local % d == 0 and d >= floor] or [b_local]
    for mb in cands:
        bshape = _batch_shape_for(dcfg, shape, mb)
        peaks = simulate_peak(model, dcfg, bshape, stage=stage,
                              microbatches=(mb if stage is not None else 0),
                              act_scale=act_scale)
        if max(b.peak_bytes for b in peaks) <= budget:
            return mb
    return cands[-1]


def plan_memory(model, dcfg: DistConfig, shape=None, bucket_plans=None,
                stage=None, microbatches: int = 0,
                stats: BlockStats | None = None,
                batch_shape=None, act_scale: float = 1.0) -> MemoryPlan:
    """Resolve ``dcfg.remat`` into a frozen `MemoryPlan`.

    Fixed specs (a POLICIES entry or an explicit vector) are simulated and
    recorded as-is; ``"auto:<GB>"`` runs the budgeted search.  Raises a
    pointed ValueError when no candidate fits the budget, naming the budget,
    the offending stage and the residual components."""
    kind, budget = parse_remat(dcfg.remat)
    if batch_shape is None:
        if shape is None:
            raise ValueError(
                f"remat={dcfg.remat!r}: plan_memory needs the workload "
                "shape to size activations; pass shape= (ShapeConfig) to "
                "plan_parallel/parallelize or batch_shape= here")
        batch_shape = _batch_shape_for(dcfg, shape, microbatches)

    metas = model.metas(dcfg)
    sk = dict(model.stacked_keys)
    main = main_block_key(metas, sk)
    declared = model.block_segments(dcfg) \
        if hasattr(model, "block_segments") else None
    declared_names = tuple(declared.names) \
        if declared is not None and len(declared.fns) > 1 else ()
    # plan over the EXECUTED schedule: with segment_prefetch off the
    # prefetch runtime collapses any vector to one whole-layer policy, so
    # the search space and the profile must collapse with it
    segments, _ = executed_segments(dcfg, declared)
    seg_names = tuple(segments.names) if segments is not None else ("block",)
    if stats is None and hasattr(model, "block_stats"):
        stats = model.block_stats(dcfg, batch_shape)
    L_total = sk[main]
    base_plan = (bucket_plans or {}).get(main) \
        or plan_for(metas[main], dcfg, stats, segments=segments)

    opt_bytes = 2.0 * storage_bytes(metas, sk, dcfg, stage)

    def context_for(plan):
        """Candidate-independent simulation state per bucket plan — the
        expensive derivation, hoisted out of the search loops (the inner
        sweep is pure arithmetic via `context_peaks`)."""
        plans = dict(bucket_plans or {})
        plans[main] = plan
        ctx = make_context(model, dcfg, batch_shape, bucket_plans=plans,
                           stage=stage, microbatches=microbatches,
                           stats=stats)
        exp = _exposure_s(plan, metas[main], dcfg, stats, segments)
        return ctx, exp

    def simulate(ctx, policies, off_opt, off_res):
        return context_peaks(ctx, policies=policies, offload_opt=off_opt,
                             offload_residuals=off_res,
                             act_scale=act_scale)

    def build(policies, ctx, exp, off_opt, off_res, bk, override):
        cost = plan_cost_s(ctx.prof, policies, L_total, exp, opt_bytes,
                           off_opt, off_res)
        return MemoryPlan(
            main_key=main, segment_names=seg_names,
            policies=tuple(policies),
            policy_spec=_policy_spec(tuple(policies), seg_names),
            offload_opt_state=off_opt, offload_residuals=off_res,
            budget_bytes=budget,
            peak_bytes=tuple(b.peak_bytes for b in bk),
            cost_s=cost, bucket_plan=override, breakdown=tuple(bk))

    if kind != AUTO_PREFIX:
        policies = resolve_segment_policies(dcfg.remat, declared_names)
        _, policies = executed_segments(dcfg, declared, policies)
        ctx, exp = context_for(base_plan)
        bk = simulate(ctx, policies, False, False)
        return build(policies, ctx, exp, False, False, bk, None)

    # ---------------- the budgeted search ----------------
    # bucket candidates: the resolved plan, plus (joint with the bucket DP)
    # tighter-cap replans and the per-param partition — smaller gathered
    # peak, more alpha/exposure. Overridable only when the model has a
    # single main stack to retarget.
    bucket_cands: list[tuple[BucketPlan, BucketPlan | None]] = [
        (base_plan, None)]
    if len(sk) == 1:
        if dcfg.bucket_mode in ("auto", "auto_dp"):
            for frac in (0.25, 0.0625):
                tight = dcfg.with_(
                    autowrap_mem_limit=dcfg.autowrap_mem_limit * frac)
                p = plan_for(metas[main], tight, stats, segments=segments)
                if p.groups != base_plan.groups:
                    bucket_cands.append((p, p))
        solo = per_param_plan(metas[main])
        if solo.groups != base_plan.groups:
            bucket_cands.append((solo, solo))

    offload_cands = ((False, False), (True, False), (False, True),
                     (True, True))

    best = None          # (cost, peak, MemoryPlan)
    tightest = None      # (peak, breakdown) of the most frugal candidate
    for plan, override in bucket_cands:
        ctx, exp = context_for(plan)             # per bucket plan, hoisted
        for policies in _policy_vectors(len(seg_names)):
            for off_opt, off_res in offload_cands:
                bk = simulate(ctx, policies, off_opt, off_res)
                peak = max(b.peak_bytes for b in bk)
                if tightest is None or peak < tightest[0]:
                    tightest = (peak, bk)
                if peak > budget:
                    continue
                cand = build(policies, ctx, exp, off_opt, off_res, bk,
                             override)
                key = (cand.cost_s, peak)
                if best is None or key < best[0]:
                    best = (key, cand)
    if best is None:
        peak, bk = tightest
        worst = max(bk, key=lambda b: b.peak_bytes)
        gib = 1 / 1024**3
        raise ValueError(
            f"remat={dcfg.remat!r}: no plan fits the {budget*gib:.2f} GiB "
            f"budget for {type(model).__name__}"
            f"[{getattr(model.cfg, 'name', '?')}] — the most frugal "
            f"candidate (full remat + offload + per-param buckets) still "
            f"peaks at {peak*gib:.2f} GiB on stage {worst.stage} "
            f"({worst.describe()}); raise the budget, shrink the "
            f"microbatch, or add parallelism")
    return best[1]
