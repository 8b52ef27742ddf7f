"""Bucket plans: which parameters share one all-gather / reduce-scatter
(port of `repro.core.bucketing`).

A `BucketPlan` is an explicit, ordered partition of a block's parameter
names into gather groups.  `plan_for` resolves ``bucket_mode``:

  * ``"none"``  — one collective per parameter (the paper's vanilla);
  * ``"block"`` — one bucket for the whole block (the paper's manual
    per-transformer-block wrapping);
  * a `BucketPlan` — used as given.

``"auto"`` and ``"auto_dp"`` need the bucket planners (`autowrap`,
`irgraph`, `hw`), which are not ported yet, and raise.
"""

from __future__ import annotations

import dataclasses
import fnmatch

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Ordered partition of parameter names into gather groups."""

    groups: tuple[tuple[str, ...], ...]

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
    split at segment boundaries, segment-major order."""
    if segments is None:
        return plan
    names = [k for k, _ in named_leaves(metas_tree)]
    seg_of = assign_segments(names, segments.param_globs, segments.names)
    out: list[list[tuple[str, ...]]] = [[] for _ in segments.names]
    for grp in plan.index_groups(metas_tree):
        by_seg: dict[int, list[int]] = {}
        for i in grp:
            by_seg.setdefault(seg_of[i], []).append(i)
        for s in sorted(by_seg):
            out[s].append(tuple(names[i] for i in sorted(by_seg[s])))
    return BucketPlan(tuple(g for seg in out for g in seg))


def per_param_plan(metas_tree) -> BucketPlan:
    """No bucketing: one collective per parameter (paper's 'vanilla')."""
    return BucketPlan(tuple((k,) for k, _ in named_leaves(metas_tree)))


def whole_block_plan(metas_tree) -> BucketPlan:
    """One bucket for the whole block (paper's per-block wrapping)."""
    return BucketPlan((tuple(k for k, _ in named_leaves(metas_tree)),))


def plan_for(metas_tree, cfg: DistConfig) -> BucketPlan:
    """Resolve cfg.bucket_mode into a concrete plan for one block."""
    mode = cfg.bucket_mode
    if isinstance(mode, BucketPlan):
        return mode
    if mode == "none":
        return per_param_plan(metas_tree)
    if mode == "block":
        return whole_block_plan(metas_tree)
    if mode in ("auto", "auto_dp"):
        raise NotImplementedError(
            f"bucket_mode={mode!r}: the bucket planners (autowrap / irgraph /"
            " hw, ROADMAP item 4) are not yet ported to repro_torch; use "
            "'block', 'none' or an explicit BucketPlan")
    raise ValueError(f"unknown bucket_mode {mode!r}")
