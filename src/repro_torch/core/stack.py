"""apply_stack: run a homogeneous layer stack under SimpleFSDP scheduling
(port of `repro.core.stack`, the vanilla schedule).

  reorder=False  ("vanilla")
      for each layer: remat(gather -> compute).  Every layer's all-gather
      sits right before its compute: fully exposed communication, the
      paper's unoptimized trace, with the gathers bucketed per `plan`.
      Backward collectives come from `collectives.gather_group`.  A Python
      loop over the layers stands in for `lax.scan`.

  reorder=True   (bucketing + reordering, the hand-scheduled prefetch
      stack of the reference, `_prefetch_stack`) is not yet ported
      (ROADMAP item 5): `core/api.plan_parallel` rejects it.

Block contract: block_fn(params_full, consts, x) -> (y, aux) with aux a
dict of scalars summed over layers.  Segmented contract
(models/common.BlockSegments): fns[s](params, consts, state) -> state,
where params holds only segment s's gathered tensors.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import collectives as coll
from repro_torch.core.bucketing import (BucketPlan, assign_segments, plan_for,
                                        split_plan_at_segments)
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import leaves, named_leaves, tree_map, \
    unflatten_like
from repro_torch.core.remat import maybe_remat, resolve_segment_policies


def apply_stack(block_fn: Callable, metas_tree, cfg: DistConfig, stacked,
                consts, x, plan: BucketPlan | None = None, segments=None,
                remat=None):
    """Run the layer stack over `stacked` (leaves (L, *shard)); returns
    (y, aux_sums).

    `remat` is the per-segment policy vector; by default it is resolved
    from ``cfg.remat``.  A non-uniform vector checkpoints each segment
    separately, gathering that segment's buckets inside its own wrap."""
    if plan is None:
        plan = plan_for(metas_tree, cfg)
    seg_names = tuple(segments.names) \
        if segments is not None and len(segments.fns) > 1 else ()
    if remat is None:
        remat = resolve_segment_policies(cfg.remat, seg_names)
    remat = tuple(remat)
    if len(remat) != max(1, len(seg_names)):
        raise ValueError(
            f"remat vector {remat} does not match the block's "
            f"{max(1, len(seg_names))} segment(s) {seg_names or '(block)'}")

    if len(set(remat)) > 1 and seg_names:
        layer = _segmented_vanilla_layer(metas_tree, cfg, plan, consts,
                                         segments, remat)
    else:
        def layer(xc, layer_shards):
            params = coll.replicate_tree(layer_shards, metas_tree, cfg, plan)
            return block_fn(params, consts, xc)

        layer = maybe_remat(layer, remat[0])

    # one unbind per stacked leaf: its backward stacks the L layer grads
    # once, where indexing a[i] per layer would materialise a full-size
    # zero gradient in every layer's backward
    per_layer = tree_map(lambda a: a.unbind(0), stacked)
    aux = {}
    for i in range(len(leaves(per_layer)[0])):
        x, aux_l = layer(x, tree_map(lambda a: a[i], per_layer))
        aux = {k: aux.get(k, 0) + v for k, v in aux_l.items()}
    return x, aux


def _segmented_vanilla_layer(metas_tree, cfg, plan, consts, segments,
                             policies):
    """One layer as a per-segment checkpointed chain (non-uniform remat):
    each segment gathers ITS buckets inside its own remat wrap, so a
    `fsdp_only` entry drops exactly that segment's gathered params while a
    neighbouring `none` entry keeps its own."""
    names = [k for k, _ in named_leaves(metas_tree)]
    metas = [m for _, m in named_leaves(metas_tree)]
    seg_of = assign_segments(names, segments.param_globs, segments.names)
    exec_plan = split_plan_at_segments(plan, metas_tree, segments)
    seg_groups: list[list[list[int]]] = [[] for _ in segments.fns]
    for grp in exec_plan.index_groups(metas_tree):
        seg_groups[seg_of[grp[0]]].append(grp)

    def seg_run(s, shard_leaves, state):
        full: list = [None] * len(metas)
        for grp in seg_groups[s]:
            outs = coll.gather_group([shard_leaves[i] for i in grp],
                                     [metas[i] for i in grp], cfg)
            for i, o in zip(grp, outs):
                full[i] = o
        return segments.fns[s](unflatten_like(metas_tree, full), consts,
                               state)

    def layer(xc, layer_shards):
        shard_leaves = leaves(layer_shards)
        state = xc
        for s, pol in enumerate(policies):
            state = maybe_remat(
                lambda st, s=s: seg_run(s, shard_leaves, st), pol)(state)
        return state                     # the last segment returns (y, aux)

    return layer
