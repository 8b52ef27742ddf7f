"""Bucket plans: which parameters share one all-gather / reduce-scatter
(port of `repro.core.bucketing`).

A `BucketPlan` is an explicit, ordered partition of a block's parameter
names into gather groups, optionally with one wire precision per group.
It is produced either

  * manually (`manual_plan`) from user module-name lists — the paper's
    manual wrapping (per-transformer-block in its evals), or
  * automatically (`core/autowrap.py`) by the greedy Algorithm 1
    (``bucket_mode="auto"``) or by the exposure-minimizing interval DP
    (``bucket_mode="auto_dp"``).

The runtime consumers are `collectives.replicate_tree` (vanilla path) and
`core/stack.py` (the prefetch stack), which issue ONE packed collective
per group at the group's precision.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import logging

from repro_torch.core import hw
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves

log = logging.getLogger("repro_torch.bucketing")


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Ordered partition of parameter names into gather groups."""

    groups: tuple[tuple[str, ...], ...]
    # Per-group resolved wire precision (core/dist.COMM_PRECISIONS minus
    # 'auto'), aligned with `groups`.  None = every bucket at the config's
    # own (non-auto) comm_precision; set by the auto planners when
    # comm_precision='auto'.
    precisions: tuple[str, ...] | None = None

    def index_groups(self, metas_tree) -> list[list[int]]:
        """Name groups -> leaf indices in `named_leaves` order; params the
        plan leaves out gather one by one after the planned groups."""
        names = [k for k, _ in named_leaves(metas_tree)]
        pos = {n: i for i, n in enumerate(names)}
        seen: set[str] = set()
        out: list[list[int]] = []
        for grp in self.groups:
            idxs = []
            for name in grp:
                if name not in pos:
                    raise KeyError(f"bucket plan names unknown param {name!r};"
                                   f" known: {names[:8]}...")
                idxs.append(pos[name])
                seen.add(name)
            out.append(sorted(idxs))
        out.extend([pos[n]] for n in names if n not in seen)
        return out

    @property
    def n_buckets(self) -> int:
        return len(self.groups)

    def bucket_bytes(self, metas_tree, cfg: DistConfig) -> list[int]:
        """Gathered payload per bucket (param_dtype bytes) — feeds Alg. 1."""
        from repro_torch.core.irgraph import wire_bytes

        metas = dict(named_leaves(metas_tree))
        itemsize = cfg.param_dtype.itemsize
        return [
            sum(wire_bytes(metas[n].padded_len(cfg), itemsize) for n in grp)
            for grp in self.groups
        ]

    def group_precisions(self, metas_tree, cfg: DistConfig) -> list[str]:
        """Resolved per-bucket wire precision aligned with `index_groups`
        (unplanned params gather individually at the default).  The default
        is the config's own precision, with 'auto' degrading to bf16 for
        any bucket the planner did not annotate."""
        default = cfg.comm_precision if cfg.comm_precision != "auto" \
            else "bf16"
        n_groups = len(self.index_groups(metas_tree))
        out = list(self.precisions) if self.precisions is not None \
            else [default] * len(self.groups)
        out += [default] * (n_groups - len(out))
        return out


def assign_segments(names: list[str], param_globs, seg_names) -> list[int]:
    """Each block-param name -> the first segment whose globs match it.
    Raises on unassigned params."""
    seg_of: list = [None] * len(names)
    for s, globs in enumerate(param_globs):
        for i, n in enumerate(names):
            if seg_of[i] is None and any(fnmatch.fnmatch(n, g)
                                         for g in globs):
                seg_of[i] = s
    missing = [n for n, s in zip(names, seg_of) if s is None]
    if missing:
        raise ValueError(
            f"block segments {tuple(seg_names)} leave params unassigned: "
            f"{missing}; every param must match one segment's globs")
    return seg_of


def split_plan_at_segments(plan: BucketPlan, metas_tree,
                           segments) -> BucketPlan:
    """The partition executed for `plan` under a segmented block: groups
    split at segment boundaries (a bucket must be gathered no later than
    the first segment consuming any of its params), segment-major order,
    each piece keeping its parent's precision.  The one implementation:
    core/stack applies it before scheduling and exposed_comm_time before
    scoring."""
    if segments is None:
        return plan
    names = [k for k, _ in named_leaves(metas_tree)]
    seg_of = assign_segments(names, segments.param_globs, segments.names)
    n_seg = len(segments.names)
    out: list[list[tuple[str, ...]]] = [[] for _ in range(n_seg)]
    out_prec: list[list[str]] = [[] for _ in range(n_seg)]
    precs = None
    if plan.precisions is not None:
        # appended singletons (params the plan left out) carry bf16, the
        # same default group_precisions resolves for them
        precs = list(plan.precisions)
    for gi, grp in enumerate(plan.index_groups(metas_tree)):
        parent_prec = precs[gi] if precs is not None and gi < len(precs) \
            else "bf16"
        by_seg: dict[int, list[int]] = {}
        for i in grp:
            by_seg.setdefault(seg_of[i], []).append(i)
        for s in sorted(by_seg):
            out[s].append(tuple(names[i] for i in sorted(by_seg[s])))
            out_prec[s].append(parent_prec)
    return BucketPlan(
        tuple(g for s in range(n_seg) for g in out[s]),
        tuple(p for s in range(n_seg) for p in out_prec[s])
        if precs is not None else None)


def per_param_plan(metas_tree) -> BucketPlan:
    """No bucketing: one collective per parameter (paper's 'vanilla')."""
    return BucketPlan(tuple((k,) for k, _ in named_leaves(metas_tree)))


def whole_block_plan(metas_tree) -> BucketPlan:
    """One bucket for the whole block (paper's per-block wrapping)."""
    return BucketPlan((tuple(k for k, _ in named_leaves(metas_tree)),))


def manual_plan(metas_tree, module_lists: list[list[str]]) -> BucketPlan:
    """Bucket by user-provided module name (glob) lists, in order: each
    inner list is one bucket; a name matches if any glob in the list
    matches the param path."""
    names = [k for k, _ in named_leaves(metas_tree)]
    taken: set[str] = set()
    groups: list[tuple[str, ...]] = []
    for globs in module_lists:
        grp = tuple(
            n for n in names
            if n not in taken and any(fnmatch.fnmatch(n, g) for g in globs)
        )
        if grp:
            groups.append(grp)
            taken.update(grp)
    return BucketPlan(tuple(groups))


# ---------------------------------------------------------------------------
# Plan resolution + memoization.  Plans depend only on (named metas, cfg,
# stats, segment assignment) and the hardware profile the planners price
# with, all value-like, so they are memoized on that key; the chosen auto
# plan and its modeled exposure are logged once per key.
# ---------------------------------------------------------------------------
_PLAN_CACHE: dict[tuple, BucketPlan] = {}


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


def _plan_cache_key(metas_tree, cfg: DistConfig, block_stats,
                    seg_key) -> tuple:
    from repro_torch.core import irgraph

    metas_key = tuple(
        (k, m.global_shape, m.tp_dim, str(m.dtype))
        for k, m in named_leaves(metas_tree)
    )
    stats_key = block_stats.cache_key() if block_stats is not None else None
    return (metas_key, cfg, stats_key, seg_key, hw.active(),
            hw.measured_key(), irgraph.measured_key())


def _resolve_plan(metas_tree, cfg: DistConfig, block_stats,
                  segments) -> BucketPlan:
    if isinstance(cfg.bucket_mode, BucketPlan):
        plan = cfg.bucket_mode
    elif cfg.bucket_mode == "none":
        plan = per_param_plan(metas_tree)
    elif cfg.bucket_mode == "block":
        plan = whole_block_plan(metas_tree)
    elif cfg.bucket_mode in ("auto", "auto_dp"):
        from repro_torch.core.autowrap import (auto_dp_plan, auto_plan,
                                               exposed_comm_time)

        planner = auto_plan if cfg.bucket_mode == "auto" else auto_dp_plan
        plan = planner(metas_tree, cfg, block_stats, segments=segments)
        plan = _with_precisions(plan, metas_tree, cfg, block_stats)
        r = exposed_comm_time(plan, metas_tree, cfg, block_stats,
                              segments=segments)
        log.info(
            "bucket_mode=%s (stats=%s, profile=%s): %d buckets, "
            "exposed=%.1fus comm=%.1fus compute=%.1fus, precisions=%s, "
            "plan=%s",
            cfg.bucket_mode, getattr(block_stats, "source", "default"),
            hw.active().name, r["n_buckets"], r["exposed_s"] * 1e6,
            r["total_comm_s"] * 1e6, r["compute_s"] * 1e6,
            list(r["precisions"]), [list(g) for g in plan.groups])
        return plan
    else:
        raise ValueError(f"unknown bucket_mode {cfg.bucket_mode!r}")
    return _with_precisions(plan, metas_tree, cfg, block_stats)


def _with_precisions(plan: BucketPlan, metas_tree, cfg: DistConfig,
                     block_stats) -> BucketPlan:
    """Under comm_precision='auto', every resolved plan leaves here with
    per-bucket precisions attached (no-op otherwise)."""
    if cfg.comm_precision != "auto" or plan.precisions is not None:
        return plan
    from repro_torch.core.autowrap import assign_precisions

    return assign_precisions(plan, metas_tree, cfg, block_stats)


def _active_segments(metas_tree, cfg: DistConfig, segments):
    """Segments the runtime actually executes (reorder + segment_prefetch
    + more than one segment): only then do the auto planners plan in
    execution order with pooled hiding windows.  Returns
    (segments-or-None, hashable cache key)."""
    if (segments is None or not cfg.reorder or not cfg.segment_prefetch
            or len(segments.fns) <= 1):
        return None, None
    names = [k for k, _ in named_leaves(metas_tree)]
    seg_of = assign_segments(names, segments.param_globs, segments.names)
    return segments, tuple(seg_of)


def plan_for(metas_tree, cfg: DistConfig, block_stats=None,
             segments=None) -> BucketPlan:
    """Resolve cfg.bucket_mode into a concrete plan for one block
    (memoized).  `segments` (models/common.BlockSegments) makes the auto
    planners plan the segmented schedule the stack executes."""
    active, seg_key = _active_segments(metas_tree, cfg, segments)
    key = _plan_cache_key(metas_tree, cfg, block_stats, seg_key)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _PLAN_CACHE[key] = _resolve_plan(metas_tree, cfg,
                                                block_stats, active)
    return plan
