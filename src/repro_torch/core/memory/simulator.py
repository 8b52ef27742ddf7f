"""Live-range peak-memory simulator (port of
`repro.core.memory.simulator`): the memory-side twin of
`core/autowrap.exposed_comm_time`.

`exposed_comm_time` walks the executed schedule and integrates time that
is not hidden; this module walks the same schedule and takes the max over
live bytes.  Per (stage, segment, bucket) it accounts:

  * sharded params / grads / optimizer state (the ZeRO-3 storage layout);
  * gathered buckets in flight: the executed partition (split at segment
    boundaries, segment-major — `bucketing.split_plan_at_segments`, the
    same rewrite the stack and the exposure model apply) with the prefetch
    stack's double buffering;
  * saved residuals per remat policy (`core/remat.POLICIES`), per segment:
    `full` keeps the segment input, `save_dots` the dot outputs,
    `fsdp_only` everything but the re-gathered params, `none` additionally
    the gathered params themselves (the paper's no-AC memory cliff);
  * the delayed per-bucket reduce-scatter buffers (`cfg.rs_delay`);
  * the error-feedback accumulator and the quantized collectives' scales;
  * optional host offload (`core/memory/offload.py`): optimizer state and
    segment-boundary residuals move to host, leaving a double-buffered
    2-layer staging window on device.

Pipeline stages (pp > 1) and context parallelism (cp > 1) are not ported:
their branches raise "not yet ported" and are unreachable at pp = cp = 1.
Numbers come from the same `BlockStats` the bucket planners consume, so
"planned" and "scored" cannot drift.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.bucketing import (BucketPlan, assign_segments,
                                        plan_for, split_plan_at_segments)
from repro_torch.core.dist import DistConfig
from repro_torch.core.irgraph import BlockStats, build_nodes, comp_time
from repro_torch.core.meta import named_leaves
from repro_torch.core.remat import (AUTO_PREFIX, POLICIES, most_aggressive,
                                    parse_remat, resolve_segment_policies)


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not yet ported to repro_torch (the memory plan runs at "
        "pp = cp = 1)")


def pipe_shardable(metas_tree, dcfg: DistConfig) -> bool:
    """Whether a single-owner group is stored 1/S per pipe rank."""
    _unported("pipe-sharded storage (pp > 1)")

# fraction of a segment's intermediate activations the save_dots policy
# keeps (matmul outputs; elementwise intermediates are recomputed)
SAVE_DOTS_FRAC = 0.5


# ---------------------------------------------------------------------------
# Block profile: the per-layer memory raw material.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SegmentProfile:
    """One block segment's memory/compute summary (whole block if the model
    declares no segments)."""

    name: str
    gather_bytes: float        # gathered params of this segment (param dtype)
    rs_bytes: float            # packed grad cotangents (reduce dtype, full)
    act_bytes: float           # intermediate activations produced inside
    input_bytes: float         # the inter-segment state entering it
    comp_s: float              # forward compute time (hw.py roofline)

    def residency(self, policy: str) -> float:
        """Live bytes this segment contributes per layer under `policy` —
        saved residuals on the vanilla path, backward recompute residency on
        the prefetch path.  Monotone by construction:
        full <= save_dots <= fsdp_only <= none."""
        if policy == "full":
            return self.input_bytes
        if policy == "save_dots":
            return self.input_bytes + SAVE_DOTS_FRAC * self.act_bytes
        if policy == "fsdp_only":
            return self.input_bytes + self.act_bytes
        if policy == "none":
            return self.input_bytes + self.act_bytes + self.gather_bytes
        raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")


@dataclasses.dataclass(frozen=True)
class BlockProfile:
    """Executed-schedule view of ONE layer of the main block stack."""

    segments: tuple[SegmentProfile, ...]
    exec_pools: tuple[float, ...]      # gathered bytes per executed pool
    layer_gather_bytes: float          # one whole layer gathered at once
    layer_rs_bytes: float              # one layer's pending RS buffers
    comp_s: float                      # one layer's forward compute

    def residency(self, policies) -> float:
        return sum(s.residency(p) for s, p in zip(self.segments, policies))

    def gathered_live(self, cfg: DistConfig) -> float:
        """Peak gathered bytes in flight under the executed schedule."""
        if not cfg.reorder:
            return self.layer_gather_bytes       # one gather point per layer
        pools = self.exec_pools
        if len(pools) == 1:
            return 2.0 * pools[0]                # double buffer across layers
        # segment s's pool + the pool being prefetched (cyclic wrap = the
        # next layer's first pool riding the last segment's compute)
        return max(pools[i] + pools[(i + 1) % len(pools)]
                   for i in range(len(pools)))


def main_block_key(metas: dict, stacked_keys: dict) -> str:
    """The stacked group the block profile describes — the one
    `model.block_stats` / `block_segments` talk about."""
    if "blocks" in stacked_keys:
        return "blocks"
    if "dec_blocks" in stacked_keys:
        return "dec_blocks"
    return max(stacked_keys,
               key=lambda k: sum(math.prod(m.global_shape)
                                 for _, m in named_leaves(metas[k])))


def _group_storage_bytes(metas_tree, cfg: DistConfig) -> float:
    """Per-device sharded storage bytes of one (per-layer) group: every
    param's flat padded shard is padded_len/fsdp_size long (TP rows add a
    leading index dim sharded over the TP axis — per-device unchanged)."""
    return sum(
        m.padded_len(cfg) / max(1, cfg.fsdp_size)
        * m.dtype.itemsize
        for _, m in named_leaves(metas_tree))


def _group_gather_bytes(metas_tree, cfg: DistConfig) -> float:
    """TP-local gathered bytes of one group (param dtype)."""
    it = cfg.param_dtype.itemsize
    return sum(m.numel_local(cfg) * it for _, m in named_leaves(metas_tree))


def storage_bytes(metas: dict, stacked_keys: dict, dcfg: DistConfig,
                  stage=None) -> float:
    """Per-device sharded master-param bytes of the whole model (one pipe
    rank's slot under `stage`): the pipelined stack holds 1/S of its
    layers; single-owner (pre/post) groups whose chunks divide by S are
    pipe-SHARDED — 1/S per rank instead of a full zero-filled slot
    (models/staging.py); only non-divisible groups still pay the
    zero-fill."""
    total = 0.0
    for k in metas:
        g = _group_storage_bytes(metas[k], dcfg)
        if stage is not None and k == stage.pipelined:
            # the per-rank slot: layers_per_stage rows (zero-padded under
            # uneven stage_layers partitions — padding occupies real bytes)
            g *= stage.layers_per_stage
        elif k in stacked_keys:
            g *= stacked_keys[k]
            if stage is not None and isinstance(_owner(stage, k), int) \
                    and pipe_shardable(metas[k], dcfg):
                g /= stage.n_stages
        elif stage is not None and isinstance(_owner(stage, k), int) \
                and pipe_shardable(metas[k], dcfg):
            g /= stage.n_stages
        total += g
    return total


def build_block_profile(metas_tree, cfg: DistConfig,
                        stats: BlockStats | None = None,
                        segments=None,
                        plan: BucketPlan | None = None) -> BlockProfile:
    """Assemble the per-layer profile from the planners' own raw material."""
    nodes = build_nodes(metas_tree, cfg, stats)
    names = [n.name for n in nodes]

    if segments is not None and len(segments.fns) > 1:
        seg_of = assign_segments(names, segments.param_globs, segments.names)
        seg_names = tuple(segments.names)
    else:
        seg_of = [0] * len(nodes)
        seg_names = ("block",)

    input_b = float(stats.act_bytes) if stats is not None and \
        stats.act_bytes > 0 else max(
            (n.act_out_bytes() for n in nodes), default=0.0)

    seg_meas = stats.seg_act_bytes if stats is not None else None
    segs = []
    for s, name in enumerate(seg_names):
        sub = [n for n, sg in zip(nodes, seg_of) if sg == s]
        # a measured per-segment activation footprint wins over the
        # per-param analytic estimate
        act = seg_meas.get(name) if seg_meas else None
        segs.append(SegmentProfile(
            name=name,
            gather_bytes=sum(n.ag_bytes for n in sub),
            rs_bytes=sum(n.rs_bytes for n in sub),
            act_bytes=act if act is not None
            else sum(n.act_out_bytes() for n in sub),
            input_bytes=input_b,
            comp_s=comp_time(sub),
        ))

    if plan is None:
        plan = plan_for(metas_tree, cfg, stats, segments=segments)
    exec_plan = split_plan_at_segments(plan, metas_tree, segments) \
        if segments is not None and len(segments.fns) > 1 else plan
    by_name = {n.name: n for n in nodes}
    pools = tuple(sum(by_name[nm].ag_bytes for nm in grp)
                  for grp in exec_plan.groups)

    return BlockProfile(
        segments=tuple(segs),
        exec_pools=pools,
        layer_gather_bytes=sum(n.ag_bytes for n in nodes),
        layer_rs_bytes=sum(n.rs_bytes for n in nodes),
        comp_s=comp_time(nodes),
    )


# ---------------------------------------------------------------------------
# The simulator proper.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MemoryBreakdown:
    """Modeled per-device peak of ONE pipeline stage, by component."""

    stage: int
    parts: dict                     # component name -> bytes at the peak
    peak_bytes: float
    peak_point: str                 # program point where the peak occurs
    host_bytes: float = 0.0         # moved to host (NOT in peak_bytes)

    def describe(self) -> str:
        gib = 1 / 1024**3
        comps = " ".join(f"{k}={v*gib:.2f}" for k, v in
                         sorted(self.parts.items(), key=lambda kv: -kv[1])
                         if v > 0)
        off = f" host={self.host_bytes*gib:.2f}" if self.host_bytes else ""
        return (f"stage{self.stage}: peak {self.peak_bytes*gib:.2f} GiB "
                f"@{self.peak_point} [{comps}]{off} (GiB)")


def executed_segments(dcfg: DistConfig, segments, policies=None):
    """The (segments, policy vector) the runtime will actually execute.

    `core/stack._prefetch_stack` only applies the segment chain (and a
    per-segment vector) when ``cfg.segment_prefetch`` is on; with it off it
    collapses the vector to its most aggressive entry and gathers per
    whole layer — the simulator and the planner must model THAT schedule,
    not the declared one (the vanilla path executes vectors regardless).
    Returns (segments-or-None, policies-or-None) as executed.
    """
    active = segments is not None and len(segments.fns) > 1
    if active and dcfg.reorder and not dcfg.segment_prefetch:
        return None, ((most_aggressive(policies),)
                      if policies is not None else None)
    return (segments if active else None), \
        (tuple(policies) if policies is not None else None)


def _resolved_schedule(dcfg: DistConfig, virtual: int = 1) -> str:
    """The schedule the memory model walks: a stamped StageSpec.virtual > 1
    means the planner chose interleaved; a still-unresolved 'auto' is
    modeled as 1f1b (the bounded-memory baseline the scorer ties back to)."""
    if virtual > 1 or dcfg.pp_schedule == "interleaved":
        return "interleaved"
    return "1f1b" if dcfg.pp_schedule == "auto" else dcfg.pp_schedule


def in_flight_microbatches(dcfg: DistConfig, stage_idx: int, n_stages: int,
                           microbatches: int, virtual: int = 1) -> int:
    """Live saved-state entries at one stage: GPipe keeps all M microbatch
    stacks, 1F1B (and zb, whose F/Bx slots match 1F1B exactly) bounds stage
    s to min(M, S - s) (core/pipeline.py's ring).  Interleaved counts
    CHUNK-granularity entries from the actual slot table (roughly
    V*min(M, S - s) — each entry covers only layers_per_stage/V layers, so
    multiply by the per-chunk residency, not the per-stage one)."""
    if n_stages <= 1:
        return 1
    M = microbatches or n_stages
    sched = _resolved_schedule(dcfg, virtual)
    if sched == "interleaved":
        _unported("the interleaved pipeline schedule's slot table")
    if sched in ("1f1b", "zb"):
        return max(1, min(M, n_stages - stage_idx))
    return M


@dataclasses.dataclass(frozen=True)
class SimContext:
    """Everything `context_peaks` needs that does NOT depend on the
    candidate (policy vector / offload flags / act_scale): derived once per
    (model, dcfg, batch shape, bucket plans) and reused across the
    planner's whole candidate sweep."""

    dcfg: DistConfig
    prof: BlockProfile
    default_policies: tuple[str, ...] | None   # None while remat is auto
    params_b: float
    other_gather: float
    extras: tuple[float, ...]          # stage-entry/exit transient per stage
    L_stage: int
    n_stages: int
    microbatches: int
    # context parallelism (core/context.py): in-flight ring buffers, live
    # at every attention segment's peak.  Forward: the KV block being
    # attended plus the one arriving from the previous ctx rank (ppermute
    # double buffering), param dtype.  Backward additionally circulates
    # the travelling dK/dV accumulators in fp32 alongside the KV blocks
    # (the reverse ring), so its residency is strictly larger.  0 without
    # a ctx axis.
    ring_kv_b: float = 0.0          # forward-point in-flight bytes
    ring_kv_bwd_b: float = 0.0      # backward-point in-flight bytes
    # interleaved pipeline: virtual chunks per rank (StageSpec.virtual);
    # saved-state entries are chunk-granular (L_stage/virtual layers each)
    virtual: int = 1


def make_context(model, dcfg: DistConfig, batch_shape,
                 bucket_plans=None, stage=None, microbatches: int = 0,
                 stats: BlockStats | None = None) -> SimContext:
    """Derive the candidate-independent simulation state (the expensive
    part: metas, block profiles, storage accounting)."""
    metas = model.metas(dcfg)
    sk = dict(model.stacked_keys)
    main = main_block_key(metas, sk)
    segments = model.block_segments(dcfg) \
        if hasattr(model, "block_segments") else None
    if stats is None and hasattr(model, "block_stats"):
        stats = model.block_stats(dcfg, batch_shape)
    seg_names = tuple(segments.names) \
        if segments is not None and len(segments.fns) > 1 else ()
    if parse_remat(dcfg.remat)[0] == AUTO_PREFIX:
        # mid-search context: the planner supplies every candidate vector,
        # there is no resolvable default yet
        default = None
        segments, _ = executed_segments(dcfg, segments)
    else:
        default = resolve_segment_policies(dcfg.remat, seg_names)
        # model the schedule the runtime executes (segment_prefetch collapse)
        segments, default = executed_segments(dcfg, segments, default)

    prof = build_block_profile(metas[main], dcfg, stats, segments,
                               (bucket_plans or {}).get(main))
    params_b = storage_bytes(metas, sk, dcfg, stage)
    # other stacked groups: storage counted in params_b; their transient
    # gather (one layer live) rides the same peak point
    other_gather = max(
        (build_block_profile(metas[k], dcfg, None, None,
                             (bucket_plans or {}).get(k))
         .gathered_live(dcfg)
         for k in sk if k != main), default=0.0)

    n_stages = stage.n_stages if stage is not None else 1
    b_mb, seq = batch_shape                 # seq is the cp-LOCAL shard

    # ring attention in flight: current KV block + the arriving one; the
    # backward's reverse ring also carries double-buffered fp32 dK/dV
    # accumulators travelling with the blocks
    ring_kv_b = ring_kv_bwd_b = 0.0
    if dcfg.cp_size > 1:
        _unported("context parallelism's ring buffers (cp > 1)")
    extras = []
    for si in range(n_stages):
        # stage-entry / exit extras (transient at the peak point): gathered
        # non-stacked groups this stage touches, plus the f32 logits on the
        # loss-owning stage
        e = 0.0
        for k in metas:
            if k in sk:
                continue
            owner = _owner(stage, k)
            if owner == "all" or owner == si:
                e += _group_gather_bytes(metas[k], dcfg)
        if stage is None or si == n_stages - 1:
            vocab = getattr(model.cfg, "vocab", 0)
            e += b_mb * seq * (vocab / max(1, dcfg.tp_size)) * 4.0
        extras.append(e)

    return SimContext(
        dcfg=dcfg, prof=prof, default_policies=default, params_b=params_b,
        other_gather=other_gather, extras=tuple(extras),
        L_stage=(stage.layers_per_stage if stage is not None else sk[main]),
        n_stages=n_stages, microbatches=microbatches, ring_kv_b=ring_kv_b,
        ring_kv_bwd_b=ring_kv_bwd_b,
        virtual=(getattr(stage, "virtual", 1) if stage is not None else 1))


def context_peaks(ctx: SimContext,
                  policies: tuple[str, ...] | None = None,
                  offload_opt: bool = False,
                  offload_residuals: bool = False,
                  act_scale: float = 1.0) -> list[MemoryBreakdown]:
    """The candidate-dependent arithmetic: per-stage peak for one
    (policy vector, offload, act_scale) candidate over a `SimContext`."""
    dcfg, prof = ctx.dcfg, ctx.prof
    if policies is None:
        if ctx.default_policies is None:
            raise ValueError(
                f"remat={dcfg.remat!r} has no default policy vector; pass "
                "policies= explicitly (the auto form is resolved by the "
                "planner)")
        policies = ctx.default_policies
    elif dcfg.reorder and not dcfg.segment_prefetch \
            and len(policies) != len(prof.segments):
        policies = (most_aggressive(policies),)
    if len(policies) != len(prof.segments):
        raise ValueError(
            f"policy vector {policies} does not match the executed "
            f"{len(prof.segments)} segment(s) "
            f"{tuple(s.name for s in prof.segments)}")

    # ---- storage-resident state (near-identical on every pipe rank:
    # pre/post groups are pipe-sharded 1/S slices where chunks divide,
    # zero-filled full slots otherwise — models/staging.py) ----
    params_b = ctx.params_b
    grads_b = params_b
    opt_b = 2.0 * params_b
    if dcfg.needs_ef:
        # quantized-RS error-feedback accumulator (optim/adamw): one more
        # storage-shaped tree, held in fp32 regardless of param dtype
        opt_b += params_b * (4.0 / dcfg.param_dtype.itemsize)

    # zb decouples the weight-grad half of each backward and queues the
    # per-microbatch dW cotangent pytrees until their fill slots drain
    # them into the accumulator (core/pipeline.py's W-queue) — a real
    # params-shaped buffer per queued entry
    w_queue_b = 0.0
    if ctx.n_stages > 1 and \
            _resolved_schedule(dcfg, ctx.virtual) == "zb":
        _unported("the zb pipeline schedule's W-queue")

    # ---- per-layer terms ----
    reorder = bool(dcfg.reorder)
    residency = act_scale * prof.residency(policies)
    per_layer_saved = act_scale * prof.segments[0].input_bytes \
        if reorder else residency
    gathered = prof.gathered_live(dcfg)
    pending_rs = prof.layer_rs_bytes if (reorder and dcfg.rs_delay) else 0.0
    workspace = residency if reorder else 0.0

    # quantized collectives (kernels/quant): per-QCHUNK(=128-elem) fp32
    # scale buffers live alongside the packed payload while it is in
    # flight — 4B per 128 elems of a 2B payload = payload/64
    scales_fwd = scales_bwd = 0.0
    if dcfg.comm_precision != "bf16":
        scales_fwd = gathered / 64.0
        scales_bwd = (gathered + pending_rs) / 64.0

    # interleaved saved-state entries are chunk-granular: each covers only
    # L_stage/virtual layers (in_flight_microbatches counts entries)
    layers_per_entry = ctx.L_stage // max(1, ctx.virtual)

    out = []
    for si in range(ctx.n_stages):
        inflight = in_flight_microbatches(dcfg, si, ctx.n_stages,
                                          ctx.microbatches, ctx.virtual)
        saved = layers_per_entry * per_layer_saved * inflight

        host = 0.0
        if offload_opt:
            host += opt_b
            opt_dev = 0.0
        else:
            opt_dev = opt_b
        if offload_residuals:
            # segment-boundary residuals (the per-layer inputs) stream to
            # host; a double-buffered 2-layer staging window stays on device
            boundary = layers_per_entry * act_scale \
                * prof.segments[0].input_bytes * inflight
            boundary = min(boundary, saved)
            keep = min(boundary, 2.0 * act_scale
                       * prof.segments[0].input_bytes)
            host += boundary - keep
            saved = saved - boundary + keep

        candidates = {
            "forward": {
                "params": params_b, "opt_state": opt_dev,
                "saved_residuals": saved, "gathered": gathered,
                "other_stacks": ctx.other_gather,
                "stage_extras": ctx.extras[si],
                "ring_kv": ctx.ring_kv_b,
                "quant_scales": scales_fwd,
            },
            "backward": {
                "params": params_b, "grads": grads_b, "opt_state": opt_dev,
                "saved_residuals": saved, "gathered": gathered,
                "pending_rs": pending_rs, "workspace": workspace,
                "other_stacks": ctx.other_gather,
                "stage_extras": ctx.extras[si],
                "ring_kv": ctx.ring_kv_bwd_b,
                "w_queue": w_queue_b,
                "quant_scales": scales_bwd,
            },
        }
        point, parts = max(candidates.items(),
                           key=lambda kv: sum(kv[1].values()))
        out.append(MemoryBreakdown(
            stage=si, parts=parts, peak_bytes=sum(parts.values()),
            peak_point=point, host_bytes=host))
    return out


def simulate_peak(model, dcfg: DistConfig, batch_shape,
                  policies: tuple[str, ...] | None = None,
                  bucket_plans=None, stage=None, microbatches: int = 0,
                  stats: BlockStats | None = None,
                  offload_opt: bool = False,
                  offload_residuals: bool = False,
                  act_scale: float = 1.0) -> list[MemoryBreakdown]:
    """Walk the executed schedule and return the modeled per-device peak of
    every pipeline stage (one entry at pp=1).

    `policies` is the per-segment remat vector for the main block stack
    (resolved from ``dcfg.remat`` when omitted); `act_scale` is a
    calibration factor that scales every activation-derived term (1.0 =
    the pure analytic model).  One-shot
    convenience over `make_context` + `context_peaks` — sweeps (the
    planner) build the context once and iterate the arithmetic."""
    ctx = make_context(model, dcfg, batch_shape, bucket_plans=bucket_plans,
                       stage=stage, microbatches=microbatches, stats=stats)
    return context_peaks(ctx, policies=policies, offload_opt=offload_opt,
                         offload_residuals=offload_residuals,
                         act_scale=act_scale)


def _owner(stage, key: str):
    """StageSpec.owner with the pp=1 convention (everything on stage 0 and
    the last stage at once)."""
    if stage is None:
        return "all"
    try:
        return stage.owner(key)
    except KeyError:
        return "all"
