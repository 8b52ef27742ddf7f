"""ServePlan (the serving analogue of ParallelPlan) + continuous batching
(port of `repro.core.serving.scheduler`: host code).

Everything latency-shaped is resolved ONCE at plan time from the hw.py
roofline and the cache-arena budget — page size, pool capacity, decode
slot count, the chunked-prefill chunk size (sized so one interleaved
chunk never stalls decode past the SLO), and the prefill/decode service
rates the router projects with.  The runtime scheduler then only executes
the plan: admission, slot assignment, chunked prefill interleaved with
decode, page allocation/eviction, preemption.

The scheduler is HOST code driving device steps it does not own: a caller
translates each `next_action()` into one `train/serve.py` paged-step call
and feeds the result back through `on_prefill` / `on_decode` (with the
measured `wall_s` when it has one).  A virtual clock advanced by the plan's
modeled step costs gives deterministic p50/p99 numbers alongside the
wall-clock measurements its callers record.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core import hw
from repro_torch.core.serving.pages import PagePool


# ---------------------------------------------------------------------------
# ServePlan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServePlan:
    arch: str
    family: str
    page: int                 # tokens per KV page
    n_pages: int              # pool capacity per data shard (excl. scratch)
    max_pages_per_seq: int    # page-table width
    max_batch: int            # decode slots per data shard
    prefill_chunk: int        # tokens per interleaved prefill chunk
    interleave: int           # decode steps drained between prefill chunks
    codec: str | None         # KV page storage codec (kernels/quant)
    kv_token_bytes: int       # per-device cache bytes per token (all layers)
    weight_bytes: int         # per-device serving param bytes
    arena_bytes: int          # kv_token_bytes * page * n_pages
    decode_step_s: float      # modeled decode step at max_batch, full ctx
    prefill_tok_s: float      # modeled prefill throughput (chunked)
    cp_prefill: int           # recommended ring-attention degree for
                              # prompts that overflow the chunk SLO; 1 = off.
                              # Modeled only: the port has no ring-attention
                              # prefill (core/api raises on a ctx axis), so
                              # nothing runs a value above 1

    @property
    def tmax(self) -> int:
        return self.max_pages_per_seq * self.page

    def decode_step_time(self, batch: int, ctx_tokens: float) -> float:
        """Roofline one-token step: stream all weights + the live context
        KV once; MXU side is 2*P flops per sequence."""
        ctx_bytes = batch * ctx_tokens * self.kv_token_bytes
        return hw.compute_time_s(2.0 * self.weight_bytes * batch,
                                 self.weight_bytes + ctx_bytes)

    def modeled_decode_tok_s(self, batch: int, ctx_tokens: float,
                             paged: bool = True) -> float:
        """Tokens/sec at `batch` live sequences with mean context
        `ctx_tokens`.  The DENSE cache streams the full allocated window
        (tmax) per sequence regardless of occupancy; pages stream only
        the allocated context — that gap is the paged win at equal
        batch."""
        ctx = ctx_tokens if paged else float(self.tmax)
        return batch / self.decode_step_time(batch, ctx)

    def prefill_time(self, n_tokens: int) -> float:
        return max(n_tokens, 1) / self.prefill_tok_s


def _weight_bytes(model, dcfg) -> int:
    from repro_torch.core.meta import ParamMeta, named_leaves
    it = dcfg.param_dtype.itemsize
    total = 0
    metas = model.metas(dcfg)
    for k in metas:
        for _, m in named_leaves(metas[k]):
            if isinstance(m, ParamMeta):
                total += m.numel_local(dcfg) * it
    return total


def _kv_token_bytes(model, dcfg) -> int:
    """Per-device cache bytes per token, summed over layers: derived from
    the family's own cache abstracts so codec/scale overheads and grouped-KV
    layouts are priced exactly once."""
    import math

    from repro_torch.core.serving.pages import kv_leaves
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train.serve import cache_abstract
    B, T = 2, 2 * 8
    total = 0
    for lf in kv_leaves(cache_abstract(
            model, ShapeConfig("plan", T, B, "decode"), dcfg)):
        # leaves are (L, B, T, *rest); heads shard over tp
        per_tok = lf.shape[0] * math.prod(lf.shape[3:]) * lf.element_size()
        total += per_tok // max(1, dcfg.tp_size)
    return int(total)


def plan_serve(model, dcfg, *, arena_bytes: int, max_batch: int,
               max_seq: int, page: int = 16, slo_decode_ms: float = 30.0,
               interleave: int = 4) -> ServePlan:
    """Freeze the serving plan from the roofline + arena budget.

    slo_decode_ms bounds the decode stall one interleaved prefill chunk
    may add: the chunk is the largest power of two whose modeled prefill
    time fits under it.  Prompts so long that even chunked prefill blows
    the time-to-first-token budget get a ring-attention prefill
    recommendation when the family supports cp (the reference's dense
    family does; the port runs no ring attention yet, so the field is a
    recommendation only)."""
    cfg = model.cfg
    if not getattr(model, "paged_kv", False):
        raise ValueError(
            f"{cfg.name} (family={cfg.family}) has no paged KV serving "
            f"path: recurrent state (xlstm/zamba) and the encdec dual "
            f"cache serve through the dense steps (ROADMAP serving "
            f"follow-ups)")
    kv_tok = _kv_token_bytes(model, dcfg)
    weights = _weight_bytes(model, dcfg)
    n_pages = int(arena_bytes // (kv_tok * page))
    if n_pages < max_batch:
        need = max_batch * page * kv_tok
        raise ValueError(
            f"arena budget {arena_bytes/2**20:.1f} MiB holds {n_pages} "
            f"pages of {page} tokens ({kv_tok} B/token) — fewer than "
            f"max_batch={max_batch} sequences need; raise the budget to "
            f">= {need/2**20:.1f} MiB or shrink page/max_batch")
    max_pages_per_seq = min(-(-max_seq // page), n_pages)

    # prefill rate: MXU-bound chunk forward (2*P flops/token) with the
    # weight stream amortized over the chunk
    def chunk_time(c):
        return hw.compute_time_s(2.0 * weights * c, weights + c * kv_tok)

    chunk = page
    while (chunk * 2 <= max_seq
           and chunk_time(chunk * 2) <= slo_decode_ms / 1e3):
        chunk *= 2
    prefill_tok_s = chunk / chunk_time(chunk)

    # long-context prefill: if a full prompt would take > 2s even chunked,
    # recommend ring-attention prefill over cp shards (time/cp, + ring
    # hops priced by hw.ring_hop_time_s — negligible next to the MXU term)
    cp = 1
    if getattr(model, "cp_supported", False):
        while (cp < 8 and max_seq / prefill_tok_s / cp > 2.0
               and max_seq // (2 * cp) >= page):
            cp *= 2

    plan = ServePlan(
        arch=cfg.name, family=cfg.family, page=page, n_pages=n_pages,
        max_pages_per_seq=max_pages_per_seq, max_batch=max_batch,
        prefill_chunk=chunk, interleave=interleave, codec=dcfg.kv_codec,
        kv_token_bytes=kv_tok, weight_bytes=weights,
        arena_bytes=n_pages * page * kv_tok,
        decode_step_s=hw.compute_time_s(
            2.0 * weights * max_batch,
            weights + max_batch * max_pages_per_seq * page * kv_tok),
        prefill_tok_s=prefill_tok_s, cp_prefill=cp)
    return plan


# ---------------------------------------------------------------------------
# Requests / sequences
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    rid: int
    prompt: tuple
    max_new: int
    arrival: float = 0.0


class _Seq:
    def __init__(self, req: Request, slot: int):
        self.req = req
        self.slot = slot
        self.table: list[int] = []      # local page ids, logical order
        self.shared: int = 0            # leading table entries owned by
                                        # the prefix cache (refcounted)
        self.pos = 0                    # tokens materialized in the cache
        self.out: list[int] = []
        self.prefill_done = False
        self.t_first: float | None = None
        self.t_done: float | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)


def _pages_through(pos: int, page: int) -> int:
    """Pages required to back logical positions [0, pos]."""
    return -(-(pos + 1) // page)


# ---------------------------------------------------------------------------
# Continuous batcher
# ---------------------------------------------------------------------------
class ContinuousBatcher:
    """Continuous batching over `plan.max_batch` decode slots.

    Policy (all constants from the frozen plan):
      * admission in arrival order, gated on a free slot + pages for the
        first prefill chunk (prefix-cache hits skip straight past their
        shared full pages);
      * chunked prefill interleaved with decode — after each chunk, up to
        `plan.interleave` decode steps drain before the next chunk, so
        decode latency stays bounded while prefill still makes progress;
      * page-boundary allocation during decode; when the pool runs dry
        the YOUNGEST running sequence is preempted (pages released,
        request requeued at the front) — LIFO preemption wastes the
        least completed work;
      * a virtual clock priced by the plan gives deterministic latency
        accounting next to the caller's wall measurements.
    """

    def __init__(self, plan: ServePlan, prefix_cache=None, registry=None):
        self.plan = plan
        self.pool = PagePool(plan.n_pages)
        self.prefix = prefix_cache
        self.slots: list[_Seq | None] = [None] * plan.max_batch
        self.waiting: deque[Request] = deque()
        self.pending: list[Request] = []    # not yet arrived (virtual time)
        self.done: list[_Seq] = []
        self.vtime = 0.0
        self._since_prefill = plan.interleave
        self.stats = {"decode_steps": 0, "prefill_chunks": 0,
                      "preemptions": 0, "prefix_hit_tokens": 0,
                      "prefix_lookup_tokens": 0, "peak_pages": 0}
        # observability (core/obs): optional MetricsRegistry + trace event
        # log.  `decode_ewma` is the measured per-step decode time the
        # Router's posterior feeds on; `decode_ratio` its scale-free form
        # (measured / plan roofline at the SAME batch+context, EWMA).
        self.registry = registry
        self.events: list[tuple] | None = None
        self.decode_ewma: float | None = None
        self.decode_ratio: float | None = None
        self._ewma_alpha = 0.2

    def enable_trace(self) -> None:
        """Start logging (kind, vtime...) events for
        `core/obs.trace.serving_lanes` — admission, prefill chunks,
        decode windows, preemptions, finishes, all stamped by the same
        virtual clock that prices the latency metrics."""
        self.events = []

    # -------------------------------------------------------------- admit --
    def submit(self, req: Request) -> None:
        self.pending.append(req)
        self.pending.sort(key=lambda r: r.arrival)

    def _admit_arrivals(self) -> None:
        while self.pending and self.pending[0].arrival <= self.vtime:
            self.waiting.append(self.pending.pop(0))

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _start(self, req: Request, slot: int) -> _Seq | None:
        seq = _Seq(req, slot)
        if self.prefix is not None:
            hit_pages = self.prefix.lookup(req.prompt, self.pool,
                                           self.plan.page)
            # shared pages are read-only — fast-forward must stop BEFORE
            # the last prompt token so the resumed prefill (which computes
            # the first output logits) writes only into fresh pages
            keep = min(len(hit_pages),
                       (seq.prompt_len - 1) // self.plan.page)
            for pid in hit_pages[keep:]:
                self.pool.release(pid)
            seq.table = list(hit_pages[:keep])
            seq.shared = keep
            seq.pos = keep * self.plan.page
            self.stats["prefix_hit_tokens"] += seq.pos
            self.stats["prefix_lookup_tokens"] += seq.prompt_len
        self.slots[slot] = seq
        if self.events is not None:
            self.events.append(("admit", self.vtime, req.rid))
        if self.registry is not None:
            self.registry.counter("serving/admitted").inc()
            self.registry.gauge("serving/queue_depth").set(len(self.waiting))
        return seq

    # ------------------------------------------------------------- paging --
    def _ensure_pages(self, seq: _Seq, through_pos: int) -> bool:
        """Back positions [0, through_pos] with pages, allocating (and
        preempting if needed) at boundaries.  False = could not."""
        need = _pages_through(through_pos, self.plan.page) - len(seq.table)
        while need > 0:
            ids = self.pool.alloc(need)
            if ids is None:
                # reclaim idle prefix-cache pages before evicting live work
                if (self.prefix is not None
                        and self.prefix.reclaim(self.pool, need) > 0):
                    continue
                if not self._preempt_someone(but=seq):
                    return False
                continue
            seq.table.extend(ids)
            need = 0
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pool.used)
        return True

    def _preempt_someone(self, but: _Seq) -> bool:
        """Evict the youngest running sequence (≠ `but`) and requeue it."""
        victims = [s for s in self.slots
                   if s is not None and s is not but]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.req.arrival)
        self._release_seq(victim)
        self.slots[victim.slot] = None
        # requeue at the front, reset to re-prefill (prefix cache keeps
        # any full pages it owns, so the re-run may fast-forward)
        req = victim.req
        self.waiting.appendleft(dataclasses.replace(
            req, prompt=tuple(req.prompt) + tuple(victim.out),
            max_new=req.max_new - len(victim.out)))
        self.stats["preemptions"] += 1
        if self.events is not None:
            self.events.append(("preempt", self.vtime, req.rid))
        if self.registry is not None:
            self.registry.counter("serving/preemptions").inc()
        return True

    def _release_seq(self, seq: _Seq) -> None:
        for j, pid in enumerate(seq.table):
            self.pool.release(pid)    # shared pages just drop one ref
        seq.table = []

    # ------------------------------------------------------------- policy --
    def next_action(self):
        """-> ("prefill", seq, start, tokens) | ("decode", [seqs]) | None.

        None with work still pending means the virtual clock advanced to
        the next arrival; call again.  None with nothing pending = done.
        """
        self._admit_arrivals()
        active = [s for s in self.slots if s is not None and s.prefill_done]
        prefilling = [s for s in self.slots
                      if s is not None and not s.prefill_done]

        want_prefill = (self._since_prefill >= self.plan.interleave
                        or not active)
        if want_prefill:
            # continue a partially-prefilled resident first
            seq = prefilling[0] if prefilling else None
            if seq is None and self.waiting:
                slot = self._free_slot()
                if slot is not None:
                    seq = self._start(self.waiting.popleft(), slot)
            if seq is not None:
                start = seq.pos
                n = min(self.plan.prefill_chunk, seq.prompt_len - start)
                if n > 0 and self._ensure_pages(seq, start + n - 1):
                    toks = seq.req.prompt[start:start + n]
                    self._since_prefill = 0
                    return ("prefill", seq, start, tuple(toks))
                if n <= 0:   # fully cached by prefix hits: decode-ready
                    seq.prefill_done = True
                    if self._ensure_pages(seq, seq.pos):
                        active.append(seq)
        if active:
            ok = []
            for s in active:
                # `active` is a snapshot: an ensure above (or earlier in
                # this loop) may have preempted s — allocating pages to an
                # evicted seq would leak them
                if self.slots[s.slot] is not s:
                    continue
                if self._ensure_pages(s, s.pos):
                    ok.append(s)
            ok = [s for s in ok if self.slots[s.slot] is s]
            if ok:
                self._since_prefill += 1
                return ("decode", ok)
        if self.pending:
            self.vtime = max(self.vtime, self.pending[0].arrival)
            return None
        if self.waiting or any(s is not None for s in self.slots):
            # blocked on pages with nothing preemptible — drain decode
            self._since_prefill = self.plan.interleave
            return None
        return None

    # ------------------------------------------------------------ results --
    def on_prefill(self, seq: _Seq, n_tokens: int,
                   wall_s: float | None = None) -> None:
        t0 = self.vtime
        seq.pos += n_tokens
        self.vtime += (wall_s if wall_s is not None
                       else self.plan.prefill_time(n_tokens))
        self.stats["prefill_chunks"] += 1
        if self.events is not None:
            self.events.append(("prefill", t0, self.vtime, seq.req.rid,
                                n_tokens))
        if self.registry is not None:
            self.registry.histogram("serving/prefill_chunk_s").observe(
                self.vtime - t0)
        if seq.pos >= seq.prompt_len:
            seq.prefill_done = True

    def on_decode(self, seqs, tokens, wall_s: float | None = None) -> None:
        """One decode step completed: `tokens[i]` sampled for seqs[i]."""
        t0 = self.vtime
        modeled = self.plan.decode_step_time(
            len(seqs), sum(s.pos for s in seqs) / len(seqs))
        dt = wall_s if wall_s is not None else modeled
        self.vtime += dt
        self.stats["decode_steps"] += 1
        # measured decode EWMA: the posterior signal the Router's
        # projection consumes (ROADMAP serving follow-up (d)); on the
        # virtual clock dt == modeled and the ratio stays 1.0, so the
        # roofline prior is recovered exactly
        a = self._ewma_alpha
        self.decode_ewma = dt if self.decode_ewma is None \
            else a * dt + (1.0 - a) * self.decode_ewma
        ratio = dt / modeled if modeled > 0 else 1.0
        self.decode_ratio = ratio if self.decode_ratio is None \
            else a * ratio + (1.0 - a) * self.decode_ratio
        if self.events is not None:
            self.events.append(("decode", t0, self.vtime, len(seqs)))
        if self.registry is not None:
            self.registry.gauge("serving/decode_step_s").set(dt)
            self.registry.gauge("serving/decode_batch").set(len(seqs))
        for s, t in zip(seqs, tokens):
            if s.t_first is None:
                s.t_first = self.vtime
            s.out.append(int(t))
            s.pos += 1
            if len(s.out) >= s.req.max_new:
                self._finish(s)

    def _finish(self, seq: _Seq) -> None:
        seq.t_done = self.vtime
        if self.events is not None:
            self.events.append(("finish", self.vtime, seq.req.rid))
        if self.prefix is not None:
            self.prefix.insert(seq.req.prompt, seq.table, self.pool,
                               self.plan.page)
        self._release_seq(seq)
        self.slots[seq.slot] = None
        self.done.append(seq)

    # ------------------------------------------------------------ metrics --
    def finished(self) -> bool:
        return (not self.pending and not self.waiting
                and all(s is None for s in self.slots))

    def metrics(self) -> dict:
        lats = [s.t_done - s.req.arrival for s in self.done]
        firsts = [s.t_first - s.req.arrival for s in self.done]
        toks = sum(len(s.out) for s in self.done)
        out = dict(self.stats)
        out.update(
            requests=len(self.done), gen_tokens=toks,
            virtual_s=self.vtime,
            tok_s=toks / self.vtime if self.vtime else 0.0,
            p50_s=_pct(lats, 50), p99_s=_pct(lats, 99),
            p50_first_s=_pct(firsts, 50), p99_first_s=_pct(firsts, 99),
            arena_util=self.stats["peak_pages"] / self.plan.n_pages,
            prefix_hit_rate=(
                self.stats["prefix_hit_tokens"]
                / max(1, self.stats["prefix_lookup_tokens"])))
        if self.registry is not None:
            r = self.registry
            r.gauge("serving/p50_s").set(out["p50_s"])
            r.gauge("serving/p99_s").set(out["p99_s"])
            r.gauge("serving/prefix_hit_rate").set(out["prefix_hit_rate"])
            r.gauge("serving/arena_util").set(out["arena_util"])
            r.gauge("serving/tok_s").set(out["tok_s"])
        return out


def _pct(xs, q) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, int(round((q / 100) * (len(ys) - 1))))
    return float(ys[i])


def run_virtual(plan: ServePlan, requests, prefix_cache=None,
                gen_token: int = 7, registry=None,
                trace: bool = False) -> ContinuousBatcher:
    """Execute the batcher against a stub executor: no device in the
    loop, every latency priced by the plan's virtual clock — the
    deterministic path the bench assertions and scheduler tests use.
    `registry`/`trace` feed core/obs (metrics + serving_lanes)."""
    b = ContinuousBatcher(plan, prefix_cache=prefix_cache,
                          registry=registry)
    if trace:
        b.enable_trace()
    for r in requests:
        b.submit(r)
    idle = 0
    while not b.finished():
        act = b.next_action()
        if act is None:
            idle += 1
            assert idle < 100_000, "scheduler stalled"
            continue
        idle = 0
        if act[0] == "prefill":
            _, seq, start, toks = act
            b.on_prefill(seq, len(toks))
        else:
            _, seqs = act
            b.on_decode(seqs, [gen_token] * len(seqs))
    return b


# ---------------------------------------------------------------------------
# Static-batch baseline (virtual time): the pre-PR serving loop — admit a
# full batch, prefill everything (padded to the longest prompt, blocking),
# decode until EVERY sequence hits max_new, repeat.
# ---------------------------------------------------------------------------
def static_schedule(plan: ServePlan, requests) -> dict:
    reqs = sorted(requests, key=lambda r: r.arrival)
    vtime = 0.0
    lats, firsts, toks = [], [], 0
    decode_steps = 0
    i = 0
    while i < len(reqs):
        batch = reqs[i:i + plan.max_batch]
        i += len(batch)
        vtime = max(vtime, max(r.arrival for r in batch))
        pad_len = max(len(r.prompt) for r in batch)
        vtime += plan.prefill_time(pad_len * len(batch))
        firsts += [vtime - r.arrival for r in batch]
        steps = max(r.max_new for r in batch)
        for step in range(steps):
            # dense static cache: every slot streams the padded window
            vtime += plan.decode_step_time(len(batch), plan.tmax)
            decode_steps += 1
            for r in batch:
                if step == r.max_new - 1:
                    lats.append(vtime - r.arrival)
                    toks += r.max_new
    return dict(requests=len(reqs), gen_tokens=toks, virtual_s=vtime,
                tok_s=toks / vtime if vtime else 0.0,
                p50_s=_pct(lats, 50), p99_s=_pct(lats, 99),
                p50_first_s=_pct(firsts, 50), p99_first_s=_pct(firsts, 99),
                decode_steps=decode_steps)
