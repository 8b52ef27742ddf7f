"""Auto-wrapping: greedy Algorithm 1 plus the exposure-minimizing DP
planner (port of `repro.core.autowrap`, pure host math).

Two planners over the per-parameter `CommNode` list (execution order):

`greedy_buckets` — the paper's Algorithm 1.  Walks nodes and merges node
*i* into the current bucket iff

  forward   T_AG(bucket + i)              <= T_C(previous bucket's compute)
  backward  T_RS(prev bucket) + T_AG(...) <= T_C(previous bucket's compute)
  memory    M_C(bucket + i)               <= M_max

(both directions must admit the merge, since one plan serves forward and
backward).  The first bucket has no preceding compute to hide behind; it
is bounded by its own compute time and the memory cap.

`dp_buckets` — an interval-partition dynamic program that minimizes the
modeled steady-state exposed communication directly: bucket b's
all-gather plus bucket b-1's delayed reduce-scatter hide behind bucket
b-1's compute, with wraparound (bucket 0 of layer l hides behind the last
bucket of layer l-1, the schedule `core/stack.py` runs).  Exhaustive over
every contiguous partition whose multi-node buckets fit the memory cap, so

    exposure(dp) <= exposure(greedy) <= exposure(per-param)

holds by construction.  `dp_buckets_precision` extends the states with
each bucket's wire precision (``comm_precision="auto"``).

Every float sum here runs in the reference's order (Python `sum` over the
same lists), so plans and exposures equal the reference's to the last bit
under the same `core/hw.py` profile.
"""

from __future__ import annotations

import math

from repro_torch.core import hw
from repro_torch.core.bucketing import (BucketPlan, assign_segments,
                                        split_plan_at_segments)
from repro_torch.core.dist import AUTO_PRECISIONS, DistConfig
from repro_torch.core.irgraph import (BlockStats, CommNode, ag_time,
                                      build_nodes, comp_time,
                                      quant_overhead_s, rs_time)
from repro_torch.core.meta import named_leaves


def _cfg_precision(cfg: DistConfig) -> str:
    """The uniform wire precision a planner prices when it is NOT doing the
    per-bucket search: the config's own value, with 'auto' planning at bf16
    (precisions are then assigned per bucket afterwards)."""
    return "bf16" if cfg.comm_precision == "auto" else cfg.comm_precision


def greedy_buckets(nodes: list[CommNode], cfg: DistConfig,
                   mem_limit: float | None = None,
                   cuts: frozenset[int] = frozenset()
                   ) -> list[list[CommNode]]:
    """`cuts`: node indices where a bucket MUST close (segment boundaries —
    the runtime gathers per segment, so planning across one would describe
    a schedule the stack cannot execute)."""
    if not nodes:
        return []
    m_max = cfg.autowrap_mem_limit if mem_limit is None else mem_limit
    buckets: list[list[CommNode]] = []
    cur: list[CommNode] = [nodes[0]]
    for k, nd in enumerate(nodes[1:], start=1):
        # bucket k+1's AG hides behind bucket k's compute; the FIRST bucket
        # (exposed prologue, paper Fig. 2) is bounded by its own compute so
        # comm-dominated graphs don't degenerate into one giant bucket.
        prev_c = comp_time(buckets[-1]) if buckets else comp_time(cur)
        cand = cur + [nd]
        prec = _cfg_precision(cfg)
        t_ag = ag_time(cand, cfg, prec)
        t_rs = rs_time(buckets[-1], cfg, prec) if buckets else 0.0
        time_ok = (t_ag <= prev_c) and (t_rs + t_ag <= prev_c)
        # `cand` already includes nd; counting nd.mem_bytes again would halve
        # the effective cap for the incoming node (regression-tested in
        # tests/test_core.py::test_greedy_mem_cap_not_double_counted).
        mem_ok = sum(c.mem_bytes for c in cand) <= m_max
        if time_ok and mem_ok and k not in cuts:
            cur.append(nd)
        else:
            buckets.append(cur)
            cur = [nd]
    buckets.append(cur)
    return buckets


# ---------------------------------------------------------------------------
# The modeled objective both planners are scored on.
# ---------------------------------------------------------------------------
def partition_exposure(buckets: list[list[CommNode]], cfg: DistConfig,
                       pools: list[int] | None = None,
                       precisions: list[str] | None = None) -> float:
    """Cyclic steady-state exposed collective time of a node partition.

    Without `pools` (one pool per bucket): bucket i's all-gather and bucket
    i-1's (rs_delay'ed) reduce-scatter hide behind bucket i-1's compute,
    bucket 0 wrapping to the last bucket — Algorithm 1's idealized premise,
    which matches the unsegmented runtime at LAYER granularity (one
    whole-layer gather point per layer).

    With `pools` (one id per bucket, consecutive buckets sharing an id form
    one pool): buckets in a pool are all gathered at ONE program point —
    `core/stack.py` issues every bucket of segment s+1 around
    segment s's compute — so their AG (and the previous pool's RS) hide
    behind the previous POOL's compute collectively; each bucket still pays
    its own collective alpha. This is the executed schedule's exposure for
    segmented blocks: intra-pool bucket boundaries only trade alpha against
    the memory cap, they create no extra hiding windows.

    The one-time prologue gather is amortized over the layer count and
    ignored in both forms.

    With `precisions` (one resolved wire precision per bucket; default = the
    config's uniform precision) each bucket's AG/RS is priced at its own
    wire bytes and the bucket's encode/decode overhead (quant_overhead_s —
    unhidden compute added to the critical path) is included, so the value
    is the objective the precision-aware planners minimize.
    """
    if not buckets:
        return 0.0
    if pools is None:
        pools = list(range(len(buckets)))
    if precisions is None:
        precisions = [_cfg_precision(cfg)] * len(buckets)
    # merge consecutive same-pool buckets into pooled AG/RS/compute terms
    pooled: list[tuple[float, float, float]] = []   # (ag, rs, comp)
    cur_id = None
    overhead = 0.0
    for pid, grp, prec in zip(pools, buckets, precisions):
        if pid != cur_id:
            pooled.append((0.0, 0.0, 0.0))
            cur_id = pid
        ag, rs, cp = pooled[-1]
        pooled[-1] = (ag + ag_time(grp, cfg, prec),
                      rs + rs_time(grp, cfg, prec),
                      cp + comp_time(grp))
        overhead += quant_overhead_s(grp, prec)
    exposed = overhead
    k = len(pooled)
    for i, (ag, _, _) in enumerate(pooled):
        _, rs_prev, comp_prev = pooled[(i - 1) % k]
        exposed += max(0.0, ag + rs_prev - comp_prev)
    return exposed


def per_param_partition(nodes: list[CommNode]) -> list[list[CommNode]]:
    return [[nd] for nd in nodes]


def greedy_partition(nodes: list[CommNode], cfg: DistConfig,
                     mem_limit: float | None = None,
                     cuts: frozenset[int] = frozenset()
                     ) -> list[list[CommNode]]:
    """Greedy buckets, guarded on the cyclic objective: Algorithm 1's local
    merge test is acyclic, so on some workloads a merge it admits *worsens*
    the steady-state exposure — never return a plan worse than no bucketing
    under the planner's own model."""
    if not nodes:
        return []
    buckets = greedy_buckets(nodes, cfg, mem_limit, cuts)
    solo = per_param_partition(nodes)
    if partition_exposure(buckets, cfg) > partition_exposure(solo, cfg):
        return solo
    return buckets


# ---------------------------------------------------------------------------
# Exposure-minimizing dynamic program.
# ---------------------------------------------------------------------------
def _linear_coll(cfg: DistConfig) -> tuple[float, float]:
    """hw.collective_time_s over the FSDP axes is affine in the payload:
    t(n) = alpha + beta*n. Derive (alpha, beta) from the model itself so the
    DP's O(1) interval costs can never drift from the source of truth."""
    alpha = hw.collective_time_s(0.0, cfg.axis_sizes, cfg.fsdp_axes)
    beta = hw.collective_time_s(1.0, cfg.axis_sizes, cfg.fsdp_axes) - alpha
    return alpha, beta


def dp_buckets(nodes: list[CommNode], cfg: DistConfig,
               mem_limit: float | None = None,
               cuts: frozenset[int] = frozenset()) -> list[list[CommNode]]:
    """Exact minimum-exposure contiguous partition (cyclic objective).

    DP over (last-bucket start j, boundary i) states with O(1) interval
    costs from prefix sums; the cyclic wraparound term is closed by
    enumerating the first bucket's end. Feasibility matches greedy: buckets
    of >1 node must fit the memory cap and may not span a forced cut
    (segment boundary). Exhaustive over that set, so the result is <=
    greedy's exposure by construction (asserted in tests and a
    belt-and-braces min at the end).
    """
    n = len(nodes)
    if n == 0:
        return []
    if n == 1:
        return [list(nodes)]
    m_max = cfg.autowrap_mem_limit if mem_limit is None else mem_limit
    alpha, beta = _linear_coll(cfg)

    prec = _cfg_precision(cfg)
    agb = [0.0] * (n + 1)
    rsb = [0.0] * (n + 1)
    cpt = [0.0] * (n + 1)
    memb = [0.0] * (n + 1)
    for i, nd in enumerate(nodes):
        agb[i + 1] = agb[i] + nd.ag_wire(prec)
        rsb[i + 1] = rsb[i] + nd.rs_wire(prec)
        cpt[i + 1] = cpt[i] + nd.t_comp()
        memb[i + 1] = memb[i] + nd.mem_bytes

    def feasible(i: int, j: int) -> bool:          # bucket = nodes[i:j]
        if any(i < c < j for c in cuts):
            return False
        return j - i == 1 or memb[j] - memb[i] <= m_max

    def cost(h: int, i: int, j: int) -> float:     # prev nodes[h:i], cur [i:j]
        t_ag = alpha + beta * (agb[j] - agb[i])
        t_rs = alpha + beta * (rsb[i] - rsb[h])
        return max(0.0, t_ag + t_rs - (cpt[i] - cpt[h]))

    def wrap_cost(j: int, f: int) -> float:        # first [0:f] after last [j:n]
        t_ag = alpha + beta * agb[f]
        t_rs = alpha + beta * (rsb[n] - rsb[j])
        return max(0.0, t_ag + t_rs - (cpt[n] - cpt[j]))

    best_total = math.inf
    best_cut: list[int] | None = None

    if feasible(0, n):   # the single-bucket partition wraps onto itself
        e = max(0.0, (alpha + beta * agb[n]) + (alpha + beta * rsb[n])
                - cpt[n])
        best_total, best_cut = e, [0, n]

    for f in range(1, n):                          # first bucket = nodes[0:f]
        if not feasible(0, f):
            continue
        # dp[i][j]: min exposure of nodes[0:i] whose last bucket is
        # nodes[j:i], counting each non-first bucket's term (the first
        # bucket's own cyclic term is added by wrap_cost at closure).
        dp: list[dict[int, float]] = [dict() for _ in range(n + 1)]
        parent: list[dict[int, int]] = [dict() for _ in range(n + 1)]
        dp[f][0] = 0.0
        for i in range(f, n):
            for j, base in dp[i].items():
                for t in range(i + 1, n + 1):
                    if not feasible(i, t):
                        continue
                    cand = base + cost(j, i, t)
                    if cand < dp[t].get(i, math.inf):
                        dp[t][i] = cand
                        parent[t][i] = j
        for j, val in dp[n].items():
            total = val + wrap_cost(j, f)
            if total < best_total:
                bounds, end, start = [n], n, j
                while start > 0:
                    bounds.append(start)
                    end, start = start, parent[end][start]
                bounds.append(0)
                best_total, best_cut = total, bounds[::-1]

    assert best_cut is not None   # per-param partition is always feasible
    buckets = [list(nodes[a:b]) for a, b in zip(best_cut, best_cut[1:])]

    # Belt and braces: the invariant exposure(dp) <= exposure(greedy) must
    # survive any future drift between cost() and partition_exposure().
    greedy = greedy_partition(nodes, cfg, mem_limit, cuts)
    if partition_exposure(greedy, cfg) < partition_exposure(buckets, cfg):
        return greedy
    return buckets


def dp_buckets_precision(
        nodes: list[CommNode], cfg: DistConfig,
        mem_limit: float | None = None,
        cuts: frozenset[int] = frozenset()
) -> tuple[list[list[CommNode]], list[str]]:
    """Joint partition x per-bucket-precision DP (comm_precision='auto').

    Same interval DP as `dp_buckets`, with states extended by the LAST
    bucket's wire precision (the cyclic cost of bucket i prices bucket i's
    AG at its own precision and bucket i-1's RS at the previous one) and by
    the FIRST bucket's precision (needed to close the wraparound term).
    Each bucket additionally pays its encode/decode overhead
    (quant_overhead_s).  Values are (exposure, quantized-bucket count)
    tuples compared lexicographically, so at equal exposure the plan
    prefers bf16 — quantization must buy modeled time to be chosen.

    The lattice is `AUTO_PRECISIONS` (bf16 + the fp8 and int8 codec
    modes).  fp8 and int8 share identical wire bytes, so analytically
    they tie and strict-< improvement keeps fp8 (listed first); they
    separate only when measured per-codec rates are installed
    (`irgraph.set_measured_quant_rate`), which reprices quant_overhead_s
    per codec.
    """
    n = len(nodes)
    if n == 0:
        return [], []
    m_max = cfg.autowrap_mem_limit if mem_limit is None else mem_limit
    alpha, beta = _linear_coll(cfg)
    precs = AUTO_PRECISIONS

    agb = {p: [0.0] * (n + 1) for p in precs}
    rsb = {p: [0.0] * (n + 1) for p in precs}
    ovh = {p: [0.0] * (n + 1) for p in precs}
    cpt = [0.0] * (n + 1)
    memb = [0.0] * (n + 1)
    for i, nd in enumerate(nodes):
        for p in precs:
            agb[p][i + 1] = agb[p][i] + nd.ag_wire(p)
            rsb[p][i + 1] = rsb[p][i] + nd.rs_wire(p)
            ovh[p][i + 1] = ovh[p][i] + quant_overhead_s([nd], p)
        cpt[i + 1] = cpt[i] + nd.t_comp()
        memb[i + 1] = memb[i] + nd.mem_bytes

    def feasible(i: int, j: int) -> bool:          # bucket = nodes[i:j]
        if any(i < c < j for c in cuts):
            return False
        return j - i == 1 or memb[j] - memb[i] <= m_max

    def ag_t(i: int, j: int, p: str) -> float:
        return alpha + beta * (agb[p][j] - agb[p][i])

    def rs_t(i: int, j: int, p: str) -> float:
        return alpha + beta * (rsb[p][j] - rsb[p][i])

    def nq(p: str) -> int:
        return 0 if p == "bf16" else 1

    inf = (math.inf, math.inf)
    best_total, best_sol = inf, None

    for p in precs:                 # single-bucket partition wraps on itself
        if not feasible(0, n):
            break
        e = max(0.0, ag_t(0, n, p) + rs_t(0, n, p) - cpt[n]) + ovh[p][n]
        cand = (e, nq(p))
        if cand < best_total:
            best_total, best_sol = cand, ([0, n], [p])

    for f in range(1, n):                          # first bucket = nodes[0:f]
        if not feasible(0, f):
            continue
        # dp[i][(j, p, pf)]: best (exposure, n_quant) of nodes[0:i] whose
        # last bucket is nodes[j:i] at precision p, with the first bucket
        # (nodes[0:f]) at precision pf; each non-first bucket's cyclic term
        # and every bucket's overhead are counted, the first bucket's own
        # cyclic term closes at wrap-up.
        dp: list[dict] = [dict() for _ in range(n + 1)]
        parent: list[dict] = [dict() for _ in range(n + 1)]
        for pf in precs:
            dp[f][(0, pf, pf)] = (ovh[pf][f], nq(pf))
        for i in range(f, n):
            for (j, p, pf), base in dp[i].items():
                for t in range(i + 1, n + 1):
                    if not feasible(i, t):
                        continue
                    for q in precs:
                        step = max(0.0, ag_t(i, t, q) + rs_t(j, i, p)
                                   - (cpt[i] - cpt[j])) \
                            + ovh[q][t] - ovh[q][i]
                        cand = (base[0] + step, base[1] + nq(q))
                        key = (i, q, pf)
                        if cand < dp[t].get(key, inf):
                            dp[t][key] = cand
                            parent[t][key] = (j, p)
        for (j, p, pf), val in dp[n].items():
            wrap = max(0.0, ag_t(0, f, pf) + rs_t(j, n, p)
                       - (cpt[n] - cpt[j]))
            total = (val[0] + wrap, val[1])
            if total < best_total:
                bounds, pvec = [n], [p]
                end, cur = n, (j, p, pf)
                while cur[0] > 0:
                    bounds.append(cur[0])
                    prev = parent[end][cur]
                    pvec.append(prev[1])
                    end, cur = cur[0], (prev[0], prev[1], pf)
                bounds.append(0)
                best_total = total
                best_sol = (bounds[::-1], pvec[::-1])

    assert best_sol is not None   # per-param partition is always feasible
    best_cut, best_prec = best_sol
    buckets = [list(nodes[a:b]) for a, b in zip(best_cut, best_cut[1:])]

    # Belt and braces, mirroring dp_buckets: never return a plan worse
    # under the shared objective than greedy-at-bf16 with post-hoc local
    # precision assignment.
    greedy = greedy_partition(nodes, cfg, mem_limit, cuts)
    g_prec = _local_precisions(greedy, cfg)
    if partition_exposure(greedy, cfg, precisions=g_prec) \
            < partition_exposure(buckets, cfg, precisions=best_prec):
        return greedy, g_prec
    return buckets, best_prec


def _local_precisions(buckets: list[list[CommNode]], cfg: DistConfig,
                      pools: list[int] | None = None) -> list[str]:
    """Per-bucket precisions for a FIXED partition: one coordinate-descent
    pass over the global exposure objective — each bucket in turn picks the
    precision minimizing partition_exposure with the others held fixed
    (ties prefer bf16, the first lattice entry).  Used when the partition
    came from a planner that did not search precisions jointly."""
    precs = ["bf16"] * len(buckets)
    for b in range(len(buckets)):
        best, best_p = None, "bf16"
        for p in AUTO_PRECISIONS:
            precs[b] = p
            e = partition_exposure(buckets, cfg, pools, precs)
            if best is None or e < best:
                best, best_p = e, p
        precs[b] = best_p
    return precs


# ---------------------------------------------------------------------------
# Plan-level entry points (consumed by bucketing.plan_for).
# ---------------------------------------------------------------------------
def _segment_order(metas_tree, segments):
    """Execution-order view of a segmented block: node permutation
    (segment-major, flatten order within a segment), the forced cuts at
    segment starts (in permuted index space), and the segment id of each
    permuted node. The stack executes gathers in exactly this order."""
    names = [k for k, _ in named_leaves(metas_tree)]
    seg_of = assign_segments(names, segments.param_globs, segments.names)
    perm = sorted(range(len(names)), key=lambda i: (seg_of[i], i))
    seg_x = [seg_of[i] for i in perm]
    cuts = frozenset(i for i in range(1, len(perm))
                     if seg_x[i] != seg_x[i - 1])
    return perm, cuts, seg_x


def _min_count_packing(nodes: list[CommNode], m_max: float,
                       cuts: frozenset[int]) -> list[list[CommNode]]:
    """Fewest contiguous buckets under the memory cap, closing at forced
    cuts (singletons exempt from the cap, as everywhere). Under the POOLED
    exposure objective this is exact: intra-segment bucket boundaries only
    add collective alpha, so fewer buckets strictly dominate."""
    buckets: list[list[CommNode]] = []
    cur: list[CommNode] = []
    for k, nd in enumerate(nodes):
        if cur and (k in cuts
                    or sum(c.mem_bytes for c in cur) + nd.mem_bytes > m_max):
            buckets.append(cur)
            cur = []
        cur.append(nd)
    if cur:
        buckets.append(cur)
    return buckets


def _active(segments) -> bool:
    return segments is not None and len(segments.fns) > 1


def auto_plan(metas_tree, cfg: DistConfig,
              stats: BlockStats | None = None,
              segments=None) -> BucketPlan:
    """Paper Algorithm 1 (guarded greedy) -> BucketPlan.

    With `segments` (models/common.BlockSegments) the walk runs in
    execution order with forced cuts at segment boundaries and the guard
    scores the POOLED exposure — i.e. the schedule the segmented runtime
    executes, not the flatten-order fiction."""
    nodes = build_nodes(metas_tree, cfg, stats)
    if not _active(segments):
        buckets = greedy_partition(nodes, cfg)
    else:
        perm, cuts, seg_x = _segment_order(metas_tree, segments)
        nodes_x = [nodes[i] for i in perm]
        buckets = greedy_buckets(nodes_x, cfg, cuts=cuts)
        pools = _bucket_pools(buckets, seg_x)
        solo = per_param_partition(nodes_x)
        if partition_exposure(buckets, cfg, pools) \
                > partition_exposure(solo, cfg, seg_x):
            buckets = solo
    return BucketPlan(tuple(tuple(n.name for n in grp) for grp in buckets))


def auto_dp_plan(metas_tree, cfg: DistConfig,
                 stats: BlockStats | None = None,
                 segments=None) -> BucketPlan:
    """Exposure-minimizing planner -> BucketPlan (bucket_mode='auto_dp').

    Unsegmented blocks: the exact interval DP over the cyclic per-bucket
    objective — joint over partition x per-bucket precision when
    comm_precision='auto' (halved wire bytes change the optimal cuts, so
    the dimensions cannot be searched separately). Segmented blocks: the
    executed schedule pools each segment's gathers at one program point, so
    the exact minimizer of the pooled objective is minimum-bucket-count
    packing per segment under the memory cap (fewer collectives = less
    alpha; hiding windows are fixed by the segment chain), with precisions
    assigned per bucket afterwards."""
    nodes = build_nodes(metas_tree, cfg, stats)
    if not _active(segments):
        if cfg.comm_precision == "auto":
            buckets, precs = dp_buckets_precision(nodes, cfg)
            return BucketPlan(
                tuple(tuple(n.name for n in grp) for grp in buckets),
                tuple(precs))
        buckets = dp_buckets(nodes, cfg)
        pools = None
    else:
        m_max = cfg.autowrap_mem_limit
        perm, cuts, seg_x = _segment_order(metas_tree, segments)
        buckets = _min_count_packing([nodes[i] for i in perm], m_max, cuts)
        pools = _bucket_pools(buckets, seg_x)
    groups = tuple(tuple(n.name for n in grp) for grp in buckets)
    if cfg.comm_precision == "auto":
        return BucketPlan(groups,
                          tuple(_local_precisions(buckets, cfg, pools)))
    return BucketPlan(groups)


def assign_precisions(plan: BucketPlan, metas_tree, cfg: DistConfig,
                      stats: BlockStats | None = None) -> BucketPlan:
    """Attach per-bucket precisions to a partition produced without the
    joint search (bucket_mode none/block/auto/manual under
    comm_precision='auto'): coordinate descent on the exposure objective
    over the plan's own groups."""
    if cfg.comm_precision != "auto" or plan.precisions is not None:
        return plan
    nodes = {n.name: n for n in build_nodes(metas_tree, cfg, stats)}
    buckets = [[nodes[name] for name in grp] for grp in plan.groups]
    return BucketPlan(plan.groups, tuple(_local_precisions(buckets, cfg)))


def _bucket_pools(buckets: list[list[CommNode]],
                  seg_of_node: list[int]) -> list[int]:
    """Segment id per bucket, from the segment of each bucket's first node
    (buckets never span segments once cuts are enforced)."""
    pos = 0
    pools = []
    for b in buckets:
        pools.append(seg_of_node[pos])
        pos += len(b)
    return pools


def exposed_comm_time(plan: BucketPlan, metas_tree, cfg: DistConfig,
                      stats: BlockStats | None = None,
                      segments=None) -> dict:
    """Modeled exposure of a plan: how much collective time is NOT hidden.

    With `segments`, the plan is first rewritten to the partition the
    segmented runtime executes (split at segment boundaries, segment-major
    order) and scored with pooled hiding windows, so the number describes
    the schedule core/stack actually runs. Without segments, the per-bucket cyclic model
    (Alg. 1's premise) applies.
    """
    nodes = {n.name: n for n in build_nodes(metas_tree, cfg, stats)}
    pools = None
    if _active(segments):
        plan = split_plan_at_segments(plan, metas_tree, segments)
        names = [k for k, _ in named_leaves(metas_tree)]
        seg_of = assign_segments(names, segments.param_globs, segments.names)
        name_seg = dict(zip(names, seg_of))
        pools = [name_seg[grp[0]] for grp in plan.groups]
    groups = [[nodes[name] for name in grp] for grp in plan.groups]
    if plan.precisions is not None:
        precisions = list(plan.precisions)
    else:
        precisions = [_cfg_precision(cfg)] * len(groups)
    total_comm = sum(ag_time(g, cfg, p) + rs_time(g, cfg, p)
                     for g, p in zip(groups, precisions))
    wire = sum(n.ag_wire(p) + n.rs_wire(p)
               for g, p in zip(groups, precisions) for n in g)
    overhead = sum(quant_overhead_s(g, p)
                   for g, p in zip(groups, precisions))
    exposed = partition_exposure(groups, cfg, pools, precisions)
    return {
        # the planners' full objective: unhidden comm + encode/decode cost
        "exposed_s": exposed,
        # the comm component alone (overhead enters linearly, never hidden)
        "exposed_comm_s": exposed - overhead,
        "quant_overhead_s": overhead,
        "total_comm_s": total_comm,
        "compute_s": comp_time(list(nodes.values())),
        "n_buckets": len(groups),
        "comm_wire_bytes": wire,
        "precisions": tuple(precisions),
    }


def auto_layer_group(layer_nodes: list[CommNode], cfg: DistConfig,
                     n_layers: int, mem_limit: float | None = None) -> int:
    """Largest k (dividing n_layers) s.t. k layers' bucketed AG+RS still hides
    behind k layers' compute and fits the memory cap."""
    m_max = cfg.autowrap_mem_limit if mem_limit is None else mem_limit
    best = 1
    for k in range(2, n_layers + 1):
        if n_layers % k:
            continue
        grp = layer_nodes * k
        if ag_time(grp, cfg) + rs_time(grp, cfg) > comp_time(grp):
            break
        # Single-count cap, same accounting as greedy_buckets: the candidate
        # bucket's bytes are counted once (an ad-hoc 2x multiplier here
        # halved the effective cap relative to greedy — regression-tested in
        # tests/test_autowrap.py::test_auto_layer_group_mem_single_counted).
        if sum(n.mem_bytes for n in grp) > m_max:
            break
        best = k
    return best
