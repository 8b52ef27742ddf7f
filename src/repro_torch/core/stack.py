"""apply_stack: run a homogeneous layer stack under SimpleFSDP scheduling
(port of `repro.core.stack`).

  reorder=False  ("vanilla")
      for each layer: remat(gather -> compute).  Every layer's all-gather
      sits right before its compute: fully exposed communication, the
      paper's unoptimized trace, with the gathers bucketed per `plan`.
      Backward collectives come from `collectives.gather_group`.  A Python
      loop over the layers stands in for `lax.scan`.

  reorder=True   (bucketing + reordering, paper Fig. 2; the reference's
      `_prefetch_stack`) — one hand-written `torch.autograd.Function` over
      the whole stack, pipelined at BUCKET granularity over the block's
      segments (the plan split at segment boundaries, segment-major):

        forward  — under no_grad; holds the gathered first bucket group of
                   layer i; segment s+1's buckets are all-gathered as async
                   collectives around segment s's compute (issued before it
                   when `ag_before_wait_fwd`, after it otherwise) and
                   waited on just before use; the last segment prefetches
                   layer i+1's first bucket.  Saves ONLY each layer's input
                   (full activation checkpointing); gathered buffers drop
                   as soon as their segment is done.
        backward — per layer from the top: re-gathers bucket by bucket
                   while recomputing segment by segment under enable_grad
                   (re-gather = the selective-AC MUST_RECOMPUTE semantics),
                   prefetches layer i-1's first bucket per
                   `ag_before_wait_bwd`, then sweeps the segments in reverse
                   with one `torch.autograd.grad` each; every bucket's
                   reduce-scatter goes out through `finalize_grad_bucket`
                   as an async collective, right after its layer or, under
                   `rs_delay`, one layer later, one issue point per bucket
                   spread over the next layer's segment sweep.

      Models that declare no segments (or `segment_prefetch=False`) run it
      with one whole-layer segment.  The Table-6 flags change the order of
      work and never the values.  A `Work` stays alive until its wait; the
      reduce-scatters of a layer land (wait, copy into the stacked
      gradient) one layer later, so at most two layers' are in flight.

Block contract: block_fn(params_full, consts, x) -> (y, aux) with aux a
dict of scalars summed over layers.  Segmented contract
(models/common.BlockSegments): fns[s](params, consts, state) -> state,
where params holds only segment s's gathered tensors.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import collectives as coll
import torch

from repro_torch.core.bucketing import (BucketPlan, assign_segments, plan_for,
                                        split_plan_at_segments)
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import leaves, named_leaves, tree_map, \
    unflatten_like
from repro_torch.core.remat import (maybe_remat, most_aggressive,
                                    resolve_segment_policies)


def apply_stack(block_fn: Callable, metas_tree, cfg: DistConfig, stacked,
                consts, x, plan: BucketPlan | None = None, block_stats=None,
                segments=None, remat=None):
    """Run the layer stack over `stacked` (leaves (L, *shard)); returns
    (y, aux_sums).

    By default the bucket plan is `plan_for(metas_tree, cfg, block_stats,
    segments)`: the auto planners price the block's workload from
    `block_stats` and, under the prefetch stack, plan the segmented
    schedule it executes.  Every bucket gathers and reduce-scatters at its
    own precision (`BucketPlan.group_precisions`).  `remat` is the
    per-segment policy vector; by default it is resolved from
    ``cfg.remat``.  A non-uniform vector checkpoints each segment
    separately, gathering that segment's buckets inside its own wrap."""
    if plan is None:
        plan = plan_for(metas_tree, cfg, block_stats, segments=segments)
    seg_names = tuple(segments.names) \
        if segments is not None and len(segments.fns) > 1 else ()
    if remat is None:
        remat = resolve_segment_policies(cfg.remat, seg_names)
    remat = tuple(remat)
    if len(remat) != max(1, len(seg_names)):
        raise ValueError(
            f"remat vector {remat} does not match the block's "
            f"{max(1, len(seg_names))} segment(s) {seg_names or '(block)'}")

    if cfg.reorder:
        return _prefetch_stack(block_fn, metas_tree, cfg, plan, stacked,
                               consts, x, segments, remat)
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
    seg_groups: list[list[tuple[list[int], str]]] = [[] for _ in segments.fns]
    for grp, prec in zip(exec_plan.index_groups(metas_tree),
                         exec_plan.group_precisions(metas_tree, cfg)):
        seg_groups[seg_of[grp[0]]].append((grp, prec))

    def seg_run(s, shard_leaves, state):
        full: list = [None] * len(metas)
        for grp, prec in seg_groups[s]:
            outs = coll.gather_group([shard_leaves[i] for i in grp],
                                     [metas[i] for i in grp], cfg, prec)
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


# ---------------------------------------------------------------------------
# Prefetch: bucket-granular schedule with a hand-written backward.
# ---------------------------------------------------------------------------
def _tensors(obj) -> list:
    """The tensors of a state / cotangent structure, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _rebuild(template, values):
    """`template` with its tensors replaced by `values` (an iterator)."""
    if isinstance(template, torch.Tensor):
        return next(values)
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values) for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(o, values) for o in template)
    return template


def _grad_leaf(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.requires_grad_() if t.is_floating_point() else t


def _prefetch_stack(block_fn, metas_tree, cfg, plan, stacked, consts, x,
                    segments, policies):
    sched = _Schedule(block_fn, metas_tree, cfg, plan, consts, segments,
                      policies)
    outs = _PrefetchStack.apply(sched, x, *leaves(stacked))
    return outs[0], dict(zip(sched.aux_keys, outs[1:]))


class _Schedule:
    """The static part of one prefetch-stack call: segments, their bucket
    groups, and the gather / compute / reduce steps."""

    def __init__(self, block_fn, metas_tree, cfg, plan, consts, segments,
                 policies):
        self.cfg, self.consts, self.metas_tree = cfg, consts, metas_tree
        names = [k for k, _ in named_leaves(metas_tree)]
        self.metas = [m for _, m in named_leaves(metas_tree)]
        self.shard_shapes = [m.shard_shape(cfg) for m in self.metas]
        if (segments is not None and cfg.segment_prefetch
                and len(segments.fns) > 1):
            fns = tuple(segments.fns)
            seg_of = assign_segments(names, segments.param_globs,
                                     segments.names)
            plan = split_plan_at_segments(plan, metas_tree, segments)
        else:       # one whole-layer segment
            fns = (block_fn,)
            seg_of = [0] * len(names)
        if len(policies) != len(fns):
            # segments declared but not pipelined: the whole-layer wrap
            # must not save more than the vector promised
            policies = (most_aggressive(policies),) * len(fns)
        self.fwd_fns = fns
        # residual-dropping policies bound the backward recompute's
        # residency per segment; the forward runs without autograd
        self.bwd_fns = tuple(
            maybe_remat(fn, p) if p in ("full", "save_dots") else fn
            for fn, p in zip(fns, policies))
        S = self.S = len(fns)
        self.seg_groups: list[list[list[int]]] = [[] for _ in range(S)]
        self.seg_precs: list[list[str]] = [[] for _ in range(S)]
        for grp, prec in zip(plan.index_groups(metas_tree),
                             plan.group_precisions(metas_tree, cfg)):
            self.seg_groups[seg_of[grp[0]]].append(grp)
            self.seg_precs[seg_of[grp[0]]].append(prec)
        # segment-major flat group order: the reduce-scatter order
        self.flat_groups = [g for s in range(S) for g in self.seg_groups[s]]
        self.flat_precs = [p for s in range(S) for p in self.seg_precs[s]]
        self.seg_base = [sum(len(self.seg_groups[t]) for t in range(s))
                         for s in range(S)]
        self.seg_idxs = [sorted(i for g in self.seg_groups[s] for i in g)
                         for s in range(S)]
        self.pos_in = [{i: p for p, i in enumerate(idxs)}
                       for idxs in self.seg_idxs]
        self.aux_keys: list[str] = []

    # -- collectives --------------------------------------------------------
    def issue_gather(self, stacked, idx: int, s: int) -> list:
        """Async all-gathers of segment s's bucket groups of layer idx."""
        return [coll.gather_group_start(
            [stacked[i][idx] for i in grp], [self.metas[i] for i in grp],
            self.cfg, prec, async_op=True)
            for grp, prec in zip(self.seg_groups[s], self.seg_precs[s])]

    def wait_gather(self, works: list, s: int) -> list[torch.Tensor]:
        """Segment s's gathered tensors, ordered as seg_idxs[s]."""
        full: list = [None] * len(self.seg_idxs[s])
        for grp, w in zip(self.seg_groups[s], works):
            for i, o in zip(grp, w.wait()):
                full[self.pos_in[s][i]] = o
        return full

    def issue_reduce(self, layer: int, gi: int, packed) -> tuple:
        grp = self.flat_groups[gi]
        return layer, gi, coll.finalize_grad_bucket(
            packed, [self.metas[i] for i in grp], self.cfg,
            [self.shard_shapes[i] for i in grp], self.flat_precs[gi],
            async_op=True)

    def land(self, issued: list, dstack: list) -> None:
        """Waits on issued reduce-scatters; their chunks go into the
        stacked gradients."""
        for layer, gi, work in issued:
            for i, g in zip(self.flat_groups[gi], work.wait()):
                dstack[i][layer].copy_(g)

    # -- compute ------------------------------------------------------------
    def seg_apply(self, fns, s: int, g_seg, state):
        full: list = [None] * len(self.metas)
        for i, t in zip(self.seg_idxs[s], g_seg):
            full[i] = t
        return fns[s](unflatten_like(self.metas_tree, full), self.consts,
                      state)

    def forward(self, stacked, x):
        """-> (y, aux sums, layer inputs)."""
        cfg, S, L = self.cfg, self.S, stacked[0].shape[0]
        xs, aux = [], {}
        pending = self.issue_gather(stacked, 0, 0)  # exposed prologue
        for i in range(L):
            xs.append(x)
            state = x
            g = self.wait_gather(pending, 0)
            for s in range(S):
                last = s == S - 1
                target = (i + 1, 0) if last else (i, s + 1)
                prefetch = not last or i + 1 < L
                if prefetch and cfg.ag_before_wait_fwd:
                    pending = self.issue_gather(stacked, *target)
                state = self.seg_apply(self.fwd_fns, s, g, state)
                g = None                    # this segment's buffers drop
                if prefetch and not cfg.ag_before_wait_fwd:
                    pending = self.issue_gather(stacked, *target)
                if not last:
                    g = self.wait_gather(pending, s + 1)
            x, aux_l = state
            aux = {k: aux.get(k, 0) + v for k, v in aux_l.items()}
        return x, aux, xs

    def layer_backward(self, stacked, idx, g_works, xl, ct, prv, emit,
                       issued):
        """Recompute + backward of layer idx, segment-pipelined.

        g_works: the issued gathers of this layer's first bucket group; ct:
        the cotangent of the layer's (y, aux); prv: the layer whose first
        bucket to prefetch (None: none); emit: the previous layer's packed
        gradients whose reduce-scatters go out during the sweep (rs_delay;
        issued ones are appended to `issued`).  Returns (packed gradients
        per flat group, the input's cotangent, the prefetch's works)."""
        cfg, S = self.cfg, self.S
        G = len(self.flat_groups)
        records: list = [None] * S
        prefetched = None
        state = _grad_leaf(xl)
        g = self.wait_gather(g_works, 0)
        with torch.enable_grad():
            for s in range(S):
                last = s == S - 1
                nxt = None
                if cfg.ag_before_wait_bwd:
                    if not last:
                        nxt = self.issue_gather(stacked, idx, s + 1)
                    elif prv is not None:
                        prefetched = self.issue_gather(stacked, prv, 0)
                g_req = [_grad_leaf(t) for t in g]
                g = None
                out = self.seg_apply(self.bwd_fns, s, g_req, state)
                records[s] = (g_req, state, out)
                if not cfg.ag_before_wait_bwd and not last:
                    nxt = self.issue_gather(stacked, idx, s + 1)
                if not last:
                    g = self.wait_gather(nxt, s + 1)
                    state = _rebuild(out, iter(
                        [_grad_leaf(t) for t in _tensors(out)]))
        packed: list = [None] * G
        for s in reversed(range(S)):
            if emit is not None:      # one RS issue point per bucket
                for gi in range((S - 1 - s) * G // S, (S - s) * G // S):
                    issued.append(self.issue_reduce(idx + 1, gi, emit[gi]))
            g_req, st_in, out = records[s]
            records[s] = None
            ins = g_req + [t for t in _tensors(st_in) if t.requires_grad]
            pairs = [(o, c) for o, c in zip(_tensors(out), _tensors(ct))
                     if o.requires_grad and c is not None]
            grads = torch.autograd.grad(
                [o for o, _ in pairs], ins, [c for _, c in pairs],
                allow_unused=True) if pairs else [None] * len(ins)
            grads = [torch.zeros_like(t) if d is None else d
                     for t, d in zip(ins, grads)]
            dg, dst = grads[:len(g_req)], iter(grads[len(g_req):])
            ct = _rebuild(st_in, iter([next(dst) if t.requires_grad
                                       else None
                                       for t in _tensors(st_in)]))
            for k, grp in enumerate(self.seg_groups[s]):
                packed[self.seg_base[s] + k] = coll.pack_grad_bucket(
                    [dg[self.pos_in[s][i]] for i in grp],
                    [self.metas[i] for i in grp], cfg)
        if prv is not None and not cfg.ag_before_wait_bwd:
            prefetched = self.issue_gather(stacked, prv, 0)
        return packed, ct, prefetched

    def backward(self, stacked, xs, dy, daux):
        """-> (stacked shard gradients, the stack input's cotangent)."""
        cfg, L = self.cfg, len(xs)
        dstack = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                  for a in stacked]
        ct_aux = dict(zip(self.aux_keys, daux))
        dx = dy
        works = self.issue_gather(stacked, L - 1, 0)
        pending = None            # rs_delay: the layer above's packed grads
        in_flight: list = []
        for idx in reversed(range(L)):
            issued: list = []
            packed, dx, works = self.layer_backward(
                stacked, idx, works, xs[idx], (dx, ct_aux),
                idx - 1 if idx > 0 else None,
                pending if cfg.rs_delay else None, issued)
            if cfg.rs_delay:
                pending = packed
            else:
                issued += [self.issue_reduce(idx, gi, p)
                           for gi, p in enumerate(packed)]
            self.land(in_flight, dstack)
            in_flight = issued
        if cfg.rs_delay:          # layer 0's grads are still pending
            in_flight += [self.issue_reduce(0, gi, p)
                          for gi, p in enumerate(pending)]
        self.land(in_flight, dstack)
        return dstack, dx


class _PrefetchStack(torch.autograd.Function):
    """y, *aux = stack(x); the stacked shards' gradients come from the
    schedule's own backward (collectives included)."""

    @staticmethod
    def forward(ctx, sched, x, *stacked):
        y, aux, xs = sched.forward(stacked, x.detach())
        sched.aux_keys = sorted(aux)
        ctx.sched, ctx.xs = sched, xs[1:]
        ctx.save_for_backward(x, *stacked)
        return (y, *(aux[k] for k in sched.aux_keys))

    @staticmethod
    def backward(ctx, dy, *daux):
        x, *stacked = ctx.saved_tensors
        dstack, dx = ctx.sched.backward(stacked, [x.detach(), *ctx.xs],
                                        dy, daux)
        return (None, dx, *dstack)
