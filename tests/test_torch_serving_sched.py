"""The serving scheduler of the PyTorch port against the JAX reference on the
CPU: host math, held EXACTLY.

  * `plan_serve`'s `ServePlan`, field for field, under the reference's
    TPU v5e profile (`hw.use_profile(hw.TPU_V5E)`) for qwen3, gemma2 and
    qwen2-moe at meshes (1,1) and (2,2), with and without a KV codec; its
    refusals (zamba2 has no paged KV, a tiny arena) with the reference's
    messages;
  * `run_virtual(...).metrics()`, the finished sequences, `static_schedule`,
    `synthetic_trace`, `simulate_trace` / `Router` and the `serving_lanes`
    events and trace JSON on the reference tests' traces and seeds, prefix
    cache and preemption included;
  * the batcher driving real paged steps (qwen3 SMOKE, fp32): the
    scheduler's contract (one paged-step call an action, then `on_prefill`
    / `on_decode`), under page pressure that preempts and with a prefix
    cache that hits; every logit the run produced held at TOL32 against a
    teacher-forced dense prefill + decode of the request's own tokens.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import plan_parallel as jplan_parallel
from repro.core.dist import DistConfig as JDistConfig
from repro.core.obs import MetricsRegistry as JMetricsRegistry
from repro.core.obs import trace as jtrace
from repro.core.serving import PrefixCache as JPrefixCache
from repro.core.serving import Request as JRequest
from repro.core.serving import Router as JRouter
from repro.core.serving import ServePlan as JServePlan
from repro.core.serving import plan_serve as jplan_serve
from repro.core.serving import run_virtual as jrun_virtual
from repro.core.serving import simulate_trace as jsimulate_trace
from repro.core.serving import static_schedule as jstatic_schedule
from repro.core.serving import synthetic_trace as jsynthetic_trace
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import hw
from repro_torch.core.api import plan_parallel
from repro_torch.core.dist import DistConfig, single_device_config
from repro_torch.core.obs import MetricsRegistry
from repro_torch.core.obs import trace
from repro_torch.core.serving import (ContinuousBatcher, PrefixCache,
                                      Request, Router, ServePlan,
                                      plan_serve, run_virtual,
                                      simulate_trace, static_schedule,
                                      synthetic_trace)
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as SV

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def reference_profile():
    """Every test prices with the reference's TPU v5e profile: the plan's
    methods (and so the batcher's virtual clock and the router) read the
    active profile when they are called, as the reference reads its
    constants."""
    with hw.use_profile(hw.TPU_V5E):
        yield


def _dcfgs(mesh, codec, dtype="float32"):
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=mesh,
                     param_dtype=getattr(jnp, dtype),
                     reduce_dtype=jnp.float32, kv_cache_codec=codec)
    d = DistConfig(mesh_shape=mesh, param_dtype=getattr(torch, dtype),
                   kv_cache_codec=codec)
    return jd, d


def _plans(arch="qwen3_1_7b", mesh=(1, 1), codec=None, dtype="float32",
           smoke=True, **kw):
    """(the port's plan, the reference's) under the reference's profile."""
    kw.setdefault("arena_bytes", 64 << 20)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 128)
    kw.setdefault("page", 16)
    jd, d = _dcfgs(mesh, codec, dtype)
    _, jmodel = jax_get_arch(arch, smoke=smoke)
    _, model = get_arch(arch, smoke=smoke)
    return plan_serve(model, d, **kw), jplan_serve(jmodel, jd, **kw)


def _same_plan(mine: ServePlan, ref: JServePlan):
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "gemma2_27b",
                                  "qwen2_moe_a2_7b"])
def test_plan_serve_equals_reference(arch, mesh, codec):
    mine, ref = _plans(arch, mesh, codec)
    _same_plan(mine, ref)
    assert mine.tmax == ref.tmax
    for b, ctx in ((1, 16.0), (4, 100.0)):
        assert mine.decode_step_time(b, ctx) == ref.decode_step_time(b, ctx)
        for paged in (True, False):
            assert mine.modeled_decode_tok_s(b, ctx, paged) == \
                ref.modeled_decode_tok_s(b, ctx, paged)
    assert mine.prefill_time(77) == ref.prefill_time(77)


@pytest.mark.parametrize("kw", [
    dict(codec="fp8", dtype="bfloat16", max_batch=8, max_seq=4096),
    dict(arch="gemma2_27b", codec="fp8", page=8, interleave=2,
         slo_decode_ms=0.01),
    dict(arena_bytes=5 << 20, max_seq=1 << 20, page=32),
    dict(arch="llama3_8b", smoke=False, dtype="bfloat16",
         arena_bytes=8 << 30, max_batch=8, max_seq=1 << 20),
], ids=["fp8-bf16", "gemma2-tight-slo", "long-seq", "llama3-ring"])
def test_plan_serve_equals_reference_more(kw):
    mine, ref = _plans(**kw)
    _same_plan(mine, ref)
    if kw.get("arch") == "llama3_8b":
        # a million-token prompt takes seconds even chunked: both plans
        # recommend a ring-attention prefill (the dense family's flag)
        assert mine.cp_prefill > 1


def test_plan_serve_full_width_llama3_h100():
    """The chip run's plan: llama3-8b bf16 under the H100 profile with a
    1 GiB arena is 131,072 bytes a token, 512 pages of 16 tokens, and the
    same plan as the reference's code under the same numbers."""
    _, model = get_arch("llama3_8b")
    d = single_device_config(param_dtype=torch.bfloat16)
    kw = dict(arena_bytes=1 << 30, max_batch=8, max_seq=2304, page=16)
    with hw.use_profile(hw.H100):
        plan = plan_serve(model, d, **kw)
    assert plan.kv_token_bytes == 131072 and plan.n_pages == 512
    assert plan.max_pages_per_seq == 144
    _same_plan(plan_serve(model, d, **kw),
               jplan_serve(jax_get_arch("llama3_8b")[1],
                           _dcfgs((1, 1), None, "bfloat16")[0], **kw))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_plan_serve_refusals_equal_reference():
    jd, d = _dcfgs((1, 1), None)
    _, jz = jax_get_arch("zamba2_1_2b", smoke=True)
    _, z = get_arch("zamba2_1_2b", smoke=True)
    kw = dict(arena_bytes=1 << 20, max_batch=2, max_seq=64)
    got = _message(lambda: plan_serve(z, d, **kw))
    assert "no paged KV" in got
    assert got == _message(lambda: jplan_serve(jz, jd, **kw))
    got = _message(lambda: _plans(arena_bytes=1024))
    assert "arena budget" in got
    _, jm = jax_get_arch("qwen3_1_7b", smoke=True)
    assert got == _message(lambda: jplan_serve(
        jm, jd, arena_bytes=1024, max_batch=4, max_seq=128, page=16))


# ---------------------------------------------------------------------------
# batcher, static schedule, router: the reference tests' traces
# ---------------------------------------------------------------------------
def _stub_plans(**kw):
    f = dict(n_pages=16, max_batch=4, page=4, chunk=8, interleave=2)
    f.update(kw)
    fields = dict(
        arch="stub", family="dense", page=f["page"], n_pages=f["n_pages"],
        max_pages_per_seq=min(8, f["n_pages"]), max_batch=f["max_batch"],
        prefill_chunk=f["chunk"], interleave=f["interleave"], codec=None,
        kv_token_bytes=1024, weight_bytes=1 << 20,
        arena_bytes=f["n_pages"] * f["page"] * 1024, decode_step_s=1e-3,
        prefill_tok_s=1e5, cp_prefill=1)
    return ServePlan(**fields), JServePlan(**fields)


def _reqs(n, prompt_len=10, max_new=6, spacing=0.0):
    def mk(cls):
        return [cls(rid=i, prompt=tuple(range(3, 3 + prompt_len)),
                    max_new=max_new, arrival=i * spacing) for i in range(n)]
    return mk(Request), mk(JRequest)


def _same_run(b, jb):
    """Two batchers that ran the same trace: metrics, stats, the finished
    sequences, the pools and the trace events all equal."""
    assert b.metrics() == jb.metrics()
    assert b.vtime == jb.vtime and b.stats == jb.stats
    got = [(s.req.rid, s.req.prompt, s.req.max_new, s.out, s.t_first,
            s.t_done, s.slot) for s in b.done]
    want = [(s.req.rid, s.req.prompt, s.req.max_new, s.out, s.t_first,
             s.t_done, s.slot) for s in jb.done]
    assert got == want
    assert (b.pool.used, b.pool.available) == (jb.pool.used,
                                               jb.pool.available)
    assert (b.decode_ewma, b.decode_ratio) == (jb.decode_ewma,
                                               jb.decode_ratio)
    assert b.events == jb.events


def _pair(plan_kw=None, reqs_kw=None, prefix=False, plan=None):
    p, jp = plan if plan is not None else _stub_plans(**(plan_kw or {}))
    r, jr = _reqs(**reqs_kw)
    pc, jpc = (PrefixCache(), JPrefixCache()) if prefix else (None, None)
    b = run_virtual(p, r, prefix_cache=pc, trace=True)
    jb = jrun_virtual(jp, jr, prefix_cache=jpc, trace=True)
    return b, jb, pc, jpc


@pytest.mark.parametrize("plan_kw,reqs_kw,prefix", [
    ({}, dict(n=10, spacing=1e-3), False),
    (dict(n_pages=8, max_batch=4), dict(n=8, prompt_len=12, max_new=8),
     False),
    (dict(interleave=2, chunk=4), dict(n=4, prompt_len=12, max_new=4),
     False),
    (dict(n_pages=32, chunk=4), dict(n=4, prompt_len=16, max_new=4,
                                     spacing=1.0), True),
    (dict(n_pages=10, max_batch=3, chunk=4), dict(n=9, prompt_len=14,
                                                  max_new=7, spacing=1e-4),
     True),
], ids=["completes", "preempts", "interleaves", "prefix", "prefix-preempt"])
def test_run_virtual_equals_reference(plan_kw, reqs_kw, prefix):
    b, jb, pc, jpc = _pair(plan_kw, reqs_kw, prefix)
    _same_run(b, jb)
    b.pool.check()
    if prefix:
        assert (pc.hits, pc.misses, len(pc)) == (jpc.hits, jpc.misses,
                                                 len(jpc))
        assert b.pool.used == len(pc)
    else:
        assert b.pool.used == 0


def test_preemption_and_prefix_hits_happen_where_the_reference_says():
    b, jb, _, _ = _pair(dict(n_pages=8, max_batch=4),
                        dict(n=8, prompt_len=12, max_new=8))
    assert b.stats["preemptions"] == jb.stats["preemptions"] > 0
    b, jb, _, _ = _pair(dict(n_pages=32, chunk=4),
                        dict(n=4, prompt_len=16, max_new=4, spacing=1.0),
                        prefix=True)
    assert b.metrics()["prefix_hit_rate"] == \
        jb.metrics()["prefix_hit_rate"] > 0.4


def _traces(n, **kw):
    mine = synthetic_trace(n, **kw)
    ref = jsynthetic_trace(n, **kw)
    assert [dataclasses.astuple(r) for r in mine] == \
        [dataclasses.astuple(r) for r in ref]
    return mine, ref


def test_continuous_and_static_equal_reference():
    plan, jplan = _plans(max_batch=4, max_seq=128)
    tr, jtr = _traces(24, seed=3, mean_interarrival_s=0.002,
                      prompt_lens=(32, 64), gen_lens=(16, 32))
    b, jb = run_virtual(plan, tr, trace=True), jrun_virtual(jplan, jtr,
                                                            trace=True)
    _same_run(b, jb)
    stat = static_schedule(plan, tr)
    assert stat == jstatic_schedule(jplan, jtr)
    assert b.metrics()["tok_s"] >= stat["tok_s"]


@pytest.mark.parametrize("n,seed,inter,gens,replicas,slo", [
    (40, 1, 2e-6, (64, 256), 2, None),
    (40, 2, 0.0005, (64, 128), 1, None),
    (40, 2, 0.0005, (64, 128), 4, None),
    (60, 4, 1e-5, (256,), 1, None),
    (60, 4, 1e-5, (256,), 1, 1e-3),
], ids=["balance", "one", "four", "open", "gated"])
def test_simulate_trace_equals_reference(n, seed, inter, gens, replicas,
                                         slo):
    plan, jplan = _plans(max_batch=2 if replicas != 2 else 4)
    tr, jtr = _traces(n, seed=seed, mean_interarrival_s=inter,
                      gen_lens=gens)
    got = simulate_trace([plan] * replicas, tr, admit_slo_s=slo)
    assert got == jsimulate_trace([jplan] * replicas, jtr, admit_slo_s=slo)
    if slo is not None:
        assert got["rejected"] > 0


def _obs_plans():
    return _plans(max_batch=4, max_seq=128, page=16)


def _obs_reqs():
    return _traces(16, seed=0, mean_interarrival_s=0.002,
                   prompt_lens=(16, 32, 64), gen_lens=(8, 16, 32))


def test_batcher_registry_and_serving_lanes_equal_reference():
    plan, jplan = _obs_plans()
    tr, jtr = _obs_reqs()
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    b = run_virtual(plan, tr, registry=reg, trace=True)
    jb = jrun_virtual(jplan, jtr, registry=jreg, trace=True)
    _same_run(b, jb)
    assert reg.snapshot() == jreg.snapshot()
    tb, jtb = trace.TraceBuilder(), jtrace.TraceBuilder()
    end = trace.serving_lanes(tb, b, t0=1e-3)
    assert end == jtrace.serving_lanes(jtb, jb, t0=1e-3) and end > 1e-3
    assert tb.to_json() == jtb.to_json()
    xs = [e for e in tb.to_doc()["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == sum(1 for e in b.events
                          if e[0] in ("prefill", "decode"))
    # without an event log: the reference's refusal
    plain = run_virtual(plan, tr)
    with pytest.raises(ValueError, match="enable_trace"):
        trace.serving_lanes(trace.TraceBuilder(), plain)


def test_plan_trace_with_batcher_equals_reference():
    """`plan_trace(..., batcher=)`: the plan's comm lanes and the batcher's
    serving lanes in one trace, byte for byte the reference's."""
    jcfg, jmodel = jax_get_arch("qwen3_1_7b", smoke=True)
    _, model = get_arch("qwen3_1_7b", smoke=True)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(8, 1),
                     param_dtype=jnp.bfloat16)
    d = DistConfig(mesh_shape=(8, 1), param_dtype=torch.bfloat16)
    shape, jshape = (ShapeConfig("t", 64, 8, "train"),
                     JShapeConfig("t", 64, 8, "train"))
    plan, jplan = _obs_plans()
    tr, jtr = _obs_reqs()
    b = run_virtual(plan, tr, trace=True)
    jb = jrun_virtual(jplan, jtr, trace=True)
    p = plan_parallel(model, d, shape)
    doc = trace.plan_trace(model, p, shape, batcher=b).to_json()
    jp = jplan_parallel(jmodel, jd, jshape)
    assert doc == jtrace.plan_trace(jmodel, jp, jshape,
                                    batcher=jb).to_json()
    assert '"serving (virtual clock)"' in doc


def test_router_feedback_equals_reference():
    plan, jplan = _obs_plans()
    tr, jtr = _obs_reqs()
    r = Router([plan, plan], registry=MetricsRegistry())
    jr = JRouter([jplan, jplan], registry=JMetricsRegistry())
    for _ in range(16):
        assert r.observe_decode(0, measured_step_s=2.0 * plan.decode_step_s) \
            == jr.observe_decode(0, measured_step_s=2.0 * jplan.decode_step_s)
    for req, jreq in zip(tr, jtr):
        assert r.route(req) == jr.route(jreq)
    b = run_virtual(plan, tr, trace=True)
    jb = jrun_virtual(jplan, jtr, trace=True)
    assert r.feed_from_batcher(1, b) == jr.feed_from_batcher(1, jb)
    assert r.registry.snapshot() == jr.registry.snapshot()


# ---------------------------------------------------------------------------
# the batcher driving real paged steps
# ---------------------------------------------------------------------------
def _drive(batcher, pstep, params, arena, max_pages, device="cpu"):
    """The scheduler's contract: each action is one paged-step call over
    the rows it names (a prefill chunk: its sequence's row at the chunk's
    true length; a decode step: the live rows), then `on_prefill` /
    `on_decode`.  A decode step writes each row's pending token (the argmax
    of its last logits) at its position, so `on_decode` reports the tokens
    it wrote.  Returns {rid: [(position, logits)]} for every logit row the
    run produced."""
    nxt, seen = {}, {}

    def table(seqs):
        t = torch.full((len(seqs), max_pages), -1, dtype=torch.int32)
        for i, s in enumerate(seqs):
            t[i, :len(s.table)] = torch.tensor(s.table, dtype=torch.int32)
        return t.to(device)

    idle = 0
    while not batcher.finished():
        act = batcher.next_action()
        if act is None:
            idle += 1
            assert idle < 10_000, "scheduler stalled"
            continue
        idle = 0
        if act[0] == "prefill":
            _, seq, start, toks = act
            n = len(toks)
            logits, arena = pstep(
                params, arena, table([seq]),
                torch.tensor([toks], device=device),
                torch.arange(start, start + n, device=device)[None])
            if start + n == seq.prompt_len:
                nxt[seq.req.rid] = int(logits[0].argmax())
                seen.setdefault(seq.req.rid, []).append(
                    (start + n - 1, logits[0].cpu()))
            batcher.on_prefill(seq, n)
        else:
            _, seqs = act
            toks = [nxt[s.req.rid] for s in seqs]
            logits, arena = pstep(
                params, arena, table(seqs),
                torch.tensor(toks, device=device)[:, None],
                torch.tensor([s.pos for s in seqs], device=device)[:, None])
            for i, s in enumerate(seqs):
                nxt[s.req.rid] = int(logits[i].argmax())
                seen[s.req.rid].append((s.pos, logits[i].cpu()))
            batcher.on_decode(seqs, toks)
        batcher.pool.check()
    return seen


def test_batcher_drives_real_paged_steps():
    cfg, model = get_arch("qwen3_1_7b", smoke=True)
    d = single_device_config(param_dtype=torch.float32)
    params = SV.init_serve_params(model, d, torch.Generator().manual_seed(0),
                                  "cpu")
    page, max_pages = 4, 10
    # 9 pages for 3 slots: the run preempts once, and the two late
    # requests find request 0's full pages in the prefix cache (the asserts
    # below hold it to both)
    plan = ServePlan(
        arch=cfg.name, family=cfg.family, page=page, n_pages=9,
        max_pages_per_seq=max_pages, max_batch=3, prefill_chunk=8,
        interleave=2, codec=None, kv_token_bytes=1024, weight_bytes=1 << 20,
        arena_bytes=9 * page * 1024, decode_step_s=1e-3, prefill_tok_s=1e4,
        cp_prefill=1)
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(3, cfg.vocab, 12))
    reqs = []
    for i, (plen, gen) in enumerate([(14, 6), (9, 5), (17, 4), (6, 7),
                                     (11, 5), (13, 3)]):
        prompt = tuple(int(t) for t in rng.integers(3, cfg.vocab, plen))
        reqs.append(Request(rid=i, prompt=prompt, max_new=gen,
                            arrival=i * 1e-4))
    # two late requests share request 0's first 12 tokens (3 full pages)
    reqs += [Request(rid=6 + j, prompt=shared[:12] + (5 + j, 7), max_new=3,
                     arrival=1.0 + j) for j in range(2)]
    reqs[0] = dataclasses.replace(reqs[0], prompt=shared + reqs[0].prompt[12:])
    prefix = PrefixCache()
    batcher = ContinuousBatcher(plan, prefix_cache=prefix)
    for r in reqs:
        batcher.submit(r)
    arena = SV.alloc_arena(model, d, page=page, n_pages_local=plan.n_pages,
                           device="cpu")
    pstep = SV.make_paged_step(
        model, d, ShapeConfig("d", max_pages * page, plan.max_batch,
                              "decode"),
        page=page, n_pages_local=plan.n_pages, max_pages=max_pages,
        chunk=plan.prefill_chunk)
    seen = _drive(batcher, pstep, params, arena, max_pages)

    m = batcher.metrics()
    assert m["requests"] == len(reqs)
    assert m["preemptions"] >= 1 and m["prefix_hit_tokens"] > 0
    assert batcher.pool.used == len(prefix)
    # every logit row against a teacher-forced dense run of the request's
    # own tokens (a preempted request is re-prefilled: its rows repeat)
    for s in batcher.done:
        orig = reqs[s.req.rid]
        toks = list(s.req.prompt) + s.out
        assert toks[:len(orig.prompt)] == list(orig.prompt)
        assert len(toks) == len(orig.prompt) + orig.max_new
        p0 = len(orig.prompt)
        want = {}
        pf = SV.make_prefill_step(model, d, ShapeConfig("p", p0, 1,
                                                        "prefill"))
        want[p0 - 1], _ = pf(params, {"tokens": torch.tensor([toks[:p0]])})
        t_all = len(toks)
        pf_all = SV.make_prefill_step(model, d, ShapeConfig(
            "p", t_all, 1, "prefill"))
        dec = SV.make_decode_step(model, d, ShapeConfig("d", t_all, 1,
                                                        "decode"))
        padded = torch.tensor([toks[:p0] + [3] * (t_all - p0)])
        _, cache = pf_all(params, {"tokens": padded})
        for pos in range(p0, t_all):
            want[pos], cache = dec(params, cache, torch.tensor([toks[pos]]),
                                   torch.tensor([pos]))
        rows = seen[s.req.rid]
        assert {p for p, _ in rows} == set(range(p0 - 1, t_all))
        for pos, got in rows:
            np.testing.assert_allclose(got.numpy(), want[pos][0].numpy(),
                                       **TOL32, err_msg=f"r{s.req.rid}@{pos}")
