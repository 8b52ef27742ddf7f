"""The bucket planners of the PyTorch port (`core/hw`, `core/irgraph`,
`core/bucketing`, `core/autowrap`) against the JAX reference: host math
only, on the CPU.

  * plans: `plan_parallel` of every ported arch (smoke and full configs) at
    dp-only meshes of 1, 8, 64 and 256 ranks x bucket_mode in {none, block,
    auto, auto_dp} x comm_precision in {bf16, fp8_ef, auto} x reorder on /
    off, priced with the reference's TPU v5e profile: every group,
    precision, field of `exposed_comm_time` and `ParallelPlan.describe()`
    EXACTLY equal (the planners sum floats in the reference's order);
  * the reference's planner properties (`tests/test_autowrap.py`,
    `tests/test_quant.py`), on the port: exposure(auto_dp) <=
    exposure(greedy) <= exposure(per-param), the DP against brute force,
    `auto_layer_group`'s single-counted memory cap, plan memoization, the
    joint precision DP never worse than all-bf16, precisions carried across
    a segment split;
  * every row of `benchmarks/results/BENCH_overlap.json` (llama3-8b,
    deepseek-coder-33b, qwen3-moe-30b-a3b; 16x16 mesh, analytic stats at
    (1, 4096)) reproduced exactly under the TPU profile (the file is read,
    never written);
  * the H100 profile is the default and prices differently;
  * the steps run the plan `plan_parallel` reports: the stack is handed
    it, and a memory-plan override without precisions (the per-param
    partition under comm_precision='auto') is reported with the
    precisions the reference's stack attaches when it runs it, which the
    error-feedback mask reads; a plan that takes host offload is refused.
"""

import itertools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autowrap as jaw
from repro.core import bucketing as jbk
from repro.core.api import plan_parallel as jplan_parallel
from repro.core.dist import DistConfig as JDistConfig
from repro.core.meta import ParamMeta as JParamMeta
from repro.models.common import BlockSegments as JBlockSegments
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import autowrap as aw
from repro_torch.core import bucketing as bk
from repro_torch.core import hw
from repro_torch.core.api import plan_parallel
from repro_torch.core.dist import AUTO_PRECISIONS, DistConfig
from repro_torch.core.irgraph import BlockStats, CommNode, wire_bytes
from repro_torch.core.meta import ParamMeta
from repro_torch.models.common import BlockSegments, ShapeConfig
from repro_torch.models.registry import PORTED, get_arch

ROOT = Path(__file__).resolve().parents[1]
# xlstm's plans are held in tests/test_torch_xlstm.py at SMOKE: over its
# 67-leaf superblock the joint precision DP (auto_dp with comm_precision
# auto) takes ~9 s a SMOKE plan and ~70 s a full-width plan on each side.
# seamless-m4t-large-v2 has no `blocks` group (two stacks, enc_blocks and
# dec_blocks, and no `block_metas`), which these cases read; both its
# stacks' plans, exposures, wire bytes and modeled step time are held in
# tests/test_torch_encdec.py
ARCHS = tuple(sorted(a for a in PORTED
                     if a not in ("xlstm_1_3b", "seamless_m4t_large_v2")))
DP_SIZES = (1, 8, 64, 256)
PRECISIONS = ("bf16", "fp8_ef", "auto")
MODES = ("none", "block", "auto", "auto_dp")
CFG2D = DistConfig(mesh_axes=("data", "model"), mesh_shape=(4, 2))
# the archs of benchmarks/results/BENCH_{overlap,memory}.json
BENCH_ARCHS = ("llama3_8b", "deepseek_coder_33b", "qwen3_moe_30b_a3b")
EXPOSURE_KEYS = ("exposed_s", "exposed_comm_s", "quant_overhead_s",
                 "total_comm_s", "compute_s", "n_buckets",
                 "comm_wire_bytes", "precisions")


def _shape(smoke, dp):
    return (16 if smoke else 2048), max(4, dp)


def _exposure(mod, plan, model, dcfg, shape, bkmod):
    """exposed_comm_time of the blocks' plan as the runtime executes it:
    the plan_parallel workload, segments only where the stack runs them."""
    metas = model.block_metas(dcfg)
    stats = model.block_stats(dcfg, (shape.global_batch // dcfg.batch_dp,
                                     shape.seq_len))
    segs = model.block_segments(dcfg) \
        if hasattr(model, "block_segments") else None
    segs, _ = bkmod._active_segments(metas, dcfg, segs)
    return mod.exposed_comm_time(plan, metas, dcfg, stats, segments=segs)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_exposure_equal_reference(arch, smoke, mode):
    """Exact: groups, precisions, every exposure field, describe()."""
    _, jmodel = jax_get_arch(arch, smoke=smoke)
    _, model = get_arch(arch, smoke=smoke)
    for dp, prec, reorder in itertools.product(DP_SIZES, PRECISIONS,
                                               (True, False)):
        seq, batch = _shape(smoke, dp)
        jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(dp, 1),
                         bucket_mode=mode, comm_precision=prec,
                         reorder=reorder)
        d = DistConfig(mesh_shape=(dp, 1), bucket_mode=mode,
                       comm_precision=prec, reorder=reorder)
        case = (dp, prec, reorder)
        jp = jplan_parallel(jmodel, jd, JShapeConfig("t", seq, batch,
                                                     "train"))
        shape = ShapeConfig("t", seq, batch, "train")
        with hw.use_profile(hw.TPU_V5E):
            p = plan_parallel(model, d, shape)
            got = _exposure(aw, p.bucket_plan("blocks"), model, d, shape,
                            bk)
        want = _exposure(jaw, jp.bucket_plan("blocks"), jmodel, jd, shape,
                         jbk)
        assert set(p.bucket_plans) == set(jp.bucket_plans), case
        for k, jplan in jp.bucket_plans.items():
            assert p.bucket_plans[k].groups == jplan.groups, (case, k)
            assert p.bucket_plans[k].precisions == jplan.precisions, \
                (case, k)
        for key in EXPOSURE_KEYS:
            assert got[key] == want[key], (case, key, got[key], want[key])
        assert p.describe() == jp.describe(), case


def _rand_nodes(n, seed):
    rng = np.random.RandomState(seed)
    return [
        CommNode(f"p{i}",
                 ag_bytes=int(rng.randint(1, 1 << 22)),
                 rs_bytes=int(rng.randint(1, 1 << 22)),
                 comp_flops=float(10.0 ** rng.uniform(3, 13)),
                 comp_bytes=float(rng.randint(1, 1 << 22)),
                 mem_bytes=float(rng.randint(1, 1 << 22)))
        for i in range(n)
    ]


@pytest.mark.parametrize("n,seed,mem_limit", [
    (1, 0, 1e6), (2, 1, 1e4), (5, 2, 1e22), (8, 3, 1 << 21),
    (11, 4, 1 << 23), (14, 5, 1e5), (9, 6, 1 << 22), (12, 7, 3 << 20)])
def test_planner_exposure_chain(n, seed, mem_limit):
    """exposure(dp) <= exposure(greedy) <= exposure(per-param); the DP's
    buckets never span a forced cut and fit the cap; the same partitions
    as the reference's planners (tests/test_autowrap.py:111)."""
    rng = np.random.RandomState((seed + 1) % (2 ** 31))
    nodes = _rand_nodes(n, seed)
    cuts = frozenset(int(i) for i in rng.choice(max(n - 1, 1),
                                                size=rng.randint(0, n),
                                                replace=False) + 1) \
        if n > 1 and rng.rand() < 0.5 else frozenset()
    with hw.use_profile(hw.TPU_V5E):
        dpb = aw.dp_buckets(nodes, CFG2D, mem_limit, cuts)
        grd = aw.greedy_partition(nodes, CFG2D, mem_limit, cuts)
        e_dp = aw.partition_exposure(dpb, CFG2D)
        e_gr = aw.partition_exposure(grd, CFG2D)
        e_pp = aw.partition_exposure(aw.per_param_partition(nodes), CFG2D)
    jcfg = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(4, 2))
    jnodes = [jaw.CommNode(**vars(nd)) for nd in nodes]
    names = lambda bks: [[nd.name for nd in b] for b in bks]  # noqa: E731
    assert names(dpb) == names(jaw.dp_buckets(jnodes, jcfg, mem_limit, cuts))
    assert names(grd) == names(
        jaw.greedy_partition(jnodes, jcfg, mem_limit, cuts))
    for b in dpb:
        lo = nodes.index(b[0])
        assert not any(lo < c < lo + len(b) for c in cuts)
        if len(b) > 1:
            assert sum(nd.mem_bytes for nd in b) <= mem_limit
    assert [nd.name for b in dpb for nd in b] == [nd.name for nd in nodes]
    assert e_dp <= e_gr + 1e-15 * max(1.0, e_gr)
    assert e_gr <= e_pp + 1e-15 * max(1.0, e_pp)


def test_dp_exact_on_small_instances():
    """The DP equals the brute-force minimum over all contiguous
    partitions (n <= 8; tests/test_autowrap.py:136)."""
    with hw.use_profile(hw.TPU_V5E):
        for seed in range(12):
            nodes = _rand_nodes(seed % 8 + 1, 100 + seed)
            n = len(nodes)
            m_max = [1 << 20, 1 << 23, 1e22][seed % 3]
            best = np.inf
            for mask in range(1 << max(0, n - 1)):
                cuts = [0] + [i + 1 for i in range(n - 1)
                              if (mask >> i) & 1] + [n]
                bks = [nodes[a:b] for a, b in zip(cuts, cuts[1:])]
                if any(len(b) > 1 and sum(x.mem_bytes for x in b) > m_max
                       for b in bks):
                    continue
                best = min(best, aw.partition_exposure(bks, CFG2D))
            e_dp = aw.partition_exposure(aw.dp_buckets(nodes, CFG2D, m_max),
                                         CFG2D)
            assert abs(e_dp - best) <= 1e-12 + 1e-9 * best


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_dp_beats_greedy_on_full_configs(arch):
    """exposure(auto_dp) <= exposure(greedy) <= exposure(per-param) on the
    full configs at a 256-rank dp mesh, under both profiles
    (tests/test_autowrap.py:167, whose production mesh needs tp)."""
    _, model = get_arch(arch)
    dcfg = DistConfig(mesh_shape=(256, 1))
    metas = model.block_metas(dcfg)
    stats = model.block_stats(dcfg, (1, 4096))
    segs = model.block_segments(dcfg) \
        if hasattr(model, "block_segments") else None
    for profile in (hw.TPU_V5E, hw.H100):
        with hw.use_profile(profile):
            e = {name: aw.exposed_comm_time(
                plan, metas, dcfg, stats, segments=segs)["exposed_s"]
                for name, plan in (
                    ("dp", aw.auto_dp_plan(metas, dcfg, stats, segs)),
                    ("greedy", aw.auto_plan(metas, dcfg, stats, segs)),
                    ("solo", bk.per_param_plan(metas)))}
        assert e["dp"] <= e["greedy"] + 1e-15, (profile.name, e)
        assert e["greedy"] <= e["solo"] + 1e-15, (profile.name, e)


def test_auto_layer_group_mem_single_counted():
    """A cap of exactly 4 layers' bytes with compute that hides everything
    gives 4 (tests/test_autowrap.py:192)."""
    node = CommNode("p", ag_bytes=1 << 10, rs_bytes=1 << 10,
                    comp_flops=1e13, comp_bytes=1.0, mem_bytes=1 << 20)
    assert aw.auto_layer_group([node], CFG2D, n_layers=8,
                               mem_limit=4 * (1 << 20)) == 4


def _metas():
    return {
        "attn": {"wq": ParamMeta("attn.wq", (8, 8), 1),
                 "wo": ParamMeta("attn.wo", (8, 8), 0)},
        "mlp": {"wu": ParamMeta("mlp.wu", (8, 16), 1)},
        "ln": ParamMeta("ln", (8,)),
    }


def test_plan_for_memoized():
    """Equal-valued inputs hit the cache; stats, cfg and the hardware
    profile are part of the key (tests/test_autowrap.py:211)."""
    bk.clear_plan_cache()
    cfg = CFG2D.with_(bucket_mode="auto_dp")
    stats = BlockStats({"attn/wq": 1e9}, {"attn/wq": 1e3})
    p1 = bk.plan_for(_metas(), cfg, stats)
    p2 = bk.plan_for(_metas(), cfg,
                     BlockStats({"attn/wq": 1e9}, {"attn/wq": 1e3}))
    assert p1 is p2 and len(bk._PLAN_CACHE) == 1
    bk.plan_for(_metas(), cfg, BlockStats({"attn/wq": 2e9}, {"attn/wq": 1e3}))
    assert len(bk._PLAN_CACHE) == 2
    assert bk.plan_for(_metas(), cfg.with_(bucket_mode="none"),
                       stats).n_buckets == 4
    assert len(bk._PLAN_CACHE) == 3
    with hw.use_profile(hw.TPU_V5E):
        bk.plan_for(_metas(), cfg, stats)
    assert len(bk._PLAN_CACHE) == 4
    covered = sorted(n for grp in p1.groups for n in grp)
    assert covered == ["attn/wo", "attn/wq", "ln", "mlp/wu"]
    bk.clear_plan_cache()


def test_auto_planner_never_worse_than_bf16():
    """The joint partition x precision DP's objective is <= the all-bf16
    DP's, every precision is in the lattice, and the plan equals the
    reference's (tests/test_quant.py:222)."""
    metas = {f"w{i}": ParamMeta(f"w{i}", (256, 256)) for i in range(6)}
    jmetas = {f"w{i}": JParamMeta(f"w{i}", (256, 256)) for i in range(6)}
    base = DistConfig(mesh_shape=(64, 1), bucket_mode="auto_dp")
    jbase = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(64, 1),
                        bucket_mode="auto_dp")
    auto, jauto = base.with_(comm_precision="auto"), \
        jbase.with_(comm_precision="auto")
    with hw.use_profile(hw.TPU_V5E):
        r_bf = aw.exposed_comm_time(aw.auto_dp_plan(metas, base), metas,
                                    base)
        plan = aw.auto_dp_plan(metas, auto)
        r_auto = aw.exposed_comm_time(plan, metas, auto)
    jplan = jaw.auto_dp_plan(jmetas, jauto)
    assert (plan.groups, plan.precisions) == (jplan.groups, jplan.precisions)
    assert r_auto == jaw.exposed_comm_time(jplan, jmetas, jauto)
    assert r_auto["exposed_s"] <= r_bf["exposed_s"] + 1e-12
    assert plan.precisions is not None
    assert set(plan.precisions) <= set(AUTO_PRECISIONS)
    assert plan.group_precisions(metas, auto) == list(plan.precisions)


def test_bucket_plan_precisions_split_at_segments():
    """A split bucket's pieces keep its precision; params the plan leaves
    out take bf16 (tests/test_quant.py:245)."""
    metas = {"a": ParamMeta("a", (128,)), "b": ParamMeta("b", (128,)),
             "c": ParamMeta("c", (128,))}
    segs = BlockSegments(names=("s0", "s1"),
                         param_globs=(("a",), ("b", "c")),
                         fns=(lambda *a: None, lambda *a: None))
    plan = bk.BucketPlan((("a", "b"),), precisions=("fp8_ef",))
    out = bk.split_plan_at_segments(plan, metas, segs)
    assert out.groups == (("a",), ("b",), ("c",))
    assert out.precisions == ("fp8_ef", "fp8_ef", "bf16")
    jmetas = {k: JParamMeta(k, (128,)) for k in "abc"}
    jsegs = JBlockSegments(names=("s0", "s1"),
                           fns=(lambda *a: None, lambda *a: None),
                           param_globs=(("a",), ("b", "c")))
    jout = jbk.split_plan_at_segments(
        jbk.BucketPlan((("a", "b"),), precisions=("fp8_ef",)), jmetas, jsegs)
    assert (out.groups, out.precisions) == (jout.groups, jout.precisions)
    assert bk.split_plan_at_segments(bk.BucketPlan((("a", "b"),)), metas,
                                     segs).precisions is None
    assert out.group_precisions(metas, DistConfig(comm_precision="auto")) \
        == ["fp8_ef", "fp8_ef", "bf16"]
    assert bk.BucketPlan((("a",),)).group_precisions(
        metas, DistConfig(comm_precision="int8_ag")) == ["int8_ag"] * 3


def test_manual_plan_and_wire_bytes_equal_reference():
    metas = _metas()
    jmetas = {"attn": {"wq": JParamMeta("attn.wq", (8, 8), 1),
                       "wo": JParamMeta("attn.wo", (8, 8), 0)},
              "mlp": {"wu": JParamMeta("mlp.wu", (8, 16), 1)},
              "ln": JParamMeta("ln", (8,))}
    lists = [["attn/*", "ln"], ["mlp/*"]]
    got, want = bk.manual_plan(metas, lists), jbk.manual_plan(jmetas, lists)
    assert (got.groups, got.precisions) == (want.groups, want.precisions)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(4, 2))
    assert bk.manual_plan(metas, lists).bucket_bytes(metas, CFG2D) == \
        jbk.manual_plan(jmetas, lists).bucket_bytes(jmetas, jd)
    assert wire_bytes(129, 2, "fp8") == 129 + 8
    assert wire_bytes(1 << 20, 2) == 2 << 20


@pytest.mark.parametrize("arch", BENCH_ARCHS)
def test_bench_overlap_llama3_rows_reproduced_under_the_tpu_profile(arch):
    """benchmarks/results/BENCH_overlap.json's rows of each of its archs
    (llama3-8b, deepseek-coder-33b, qwen3-moe-30b-a3b; 16x16 mesh, fsdp
    over data, analytic stats at (1, 4096)): exposed_s, total_comm_s,
    compute_s and n_buckets per mode, and every comm_precision row, EXACT.
    The port plans the tp = 16 metas as host math (its runtime still
    raises at tp > 1)."""
    doc = json.loads((ROOT / "benchmarks/results/BENCH_overlap.json")
                     .read_text())
    assert doc["mesh"] == "16x16"
    assert set(doc["archs"]) == set(BENCH_ARCHS)
    want = doc["archs"][arch]
    _, model = get_arch(arch)
    d = DistConfig(mesh_shape=(16, 16))
    metas, segs = model.block_metas(d), model.block_segments(d)
    stats = model.block_stats(d, (1, 4096))
    with hw.use_profile(hw.TPU_V5E):
        modes = (("none", bk.per_param_plan(metas)),
                 ("block", bk.whole_block_plan(metas)),
                 ("greedy", aw.auto_plan(metas, d, stats, segs)),
                 ("auto_dp", aw.auto_dp_plan(metas, d, stats, segs)))
        for name, plan in modes:
            r = aw.exposed_comm_time(plan, metas, d, stats, segments=segs)
            for key in ("exposed_s", "total_comm_s", "compute_s",
                        "n_buckets"):
                assert r[key] == want["modes"][name][key], (name, key)
        for q, row in want["comm_precision"].items():
            dq = d.with_(comm_precision=q)
            r = aw.exposed_comm_time(aw.auto_dp_plan(metas, dq, stats, segs),
                                     metas, dq, stats, segments=segs)
            for key, v in row.items():
                got = list(r[key]) if key == "precisions" else r[key]
                assert got == v, (q, key, got, v)


def test_h100_profile_is_the_default_and_prices_differently():
    assert hw.active() is hw.H100
    with hw.use_profile(hw.TPU_V5E):
        assert hw.active() is hw.TPU_V5E
        t_tpu = hw.collective_time_s(1 << 30, {"data": 8}, ("data",))
        c_tpu = hw.compute_time_s(1e12, 1e9)
    assert hw.active() is hw.H100
    assert hw.collective_time_s(1 << 30, {"data": 8}, ("data",)) < t_tpu
    assert hw.compute_time_s(1e12, 1e9) < c_tpu
    # 'pod' rides the slower between-node network on both profiles
    for p in (hw.H100, hw.TPU_V5E):
        with hw.use_profile(p):
            assert hw.axis_bandwidth("pod").bytes_per_s \
                < hw.axis_bandwidth("data").bytes_per_s
    prev = hw.set_measured_axis_bandwidth("data", hw.AxisBandwidth(1e9, 0))
    try:
        assert hw.ring_hop_time_s(1e9, "data") == 1.0
    finally:
        hw.set_measured_axis_bandwidth("data", prev)
    assert hw.ring_hop_time_s(0.0, "data") == hw.H100.intra_alpha_s


def test_world_size_one_prices_no_collective():
    """At one rank every collective costs 0: auto precision picks bf16 and
    the plan's exposure is 0 (why the card's mixed-precision phase plans
    for a modeled mesh)."""
    _, model = get_arch("qwen3_1_7b")
    p = plan_parallel(model, DistConfig(bucket_mode="auto_dp",
                                        comm_precision="auto"),
                      ShapeConfig("t", 2048, 4, "train"))
    plan = p.bucket_plan("blocks")
    assert set(plan.precisions) == {"bf16"}
    d = DistConfig(bucket_mode="auto_dp", comm_precision="auto")
    r = aw.exposed_comm_time(plan, model.block_metas(d), d,
                             model.block_stats(d, (4, 2048)),
                             segments=model.block_segments(d))
    assert r["total_comm_s"] == 0.0 and r["exposed_s"] == 0.0
    assert torch.bfloat16.itemsize == jnp.dtype(jnp.bfloat16).itemsize


@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_plans_with_the_stats_plan_parallel_reports(arch):
    """The stack resolves its plan from the same BlockStats plan_parallel
    priced, so the executed plan is the reported one.  (The reference's
    zamba2 runs its stacks without block_stats: under comm_precision=
    'auto' at dp 8 its auto_dp plan reports bf16 and executes fp8_ef.)"""
    from repro_torch.core import stack
    from repro_torch.core.api import parallelize
    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.models import dense, zamba2

    cfg, model = get_arch(arch, smoke=True)
    seq = 40 if arch == "zamba2_1_2b" else 16
    shape = ShapeConfig("t", seq, 4, "train")
    d = DistConfig(param_dtype=torch.float32, bucket_mode="auto_dp",
                   comm_precision="auto")
    seen = []

    plans = []

    def spy(*a, **kw):
        seen.append(kw["block_stats"].cache_key())
        plans.append(kw["plan"])
        return stack.apply_stack(*a, **kw)

    mod = zamba2 if arch == "zamba2_1_2b" else dense
    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "apply_stack", spy)
    try:
        par = parallelize(model, d, shape, device="cpu")
        storage = par.init_storage(torch.Generator().manual_seed(0))
        batch = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                       global_batch=4)).batch(0)
        par.loss_step()(storage, batch)
    finally:
        mp.undo()
    want = model.block_stats(d, (4, seq)).cache_key()
    assert seen and all(k == want for k in seen)
    # the stack is handed the reported plan; it resolves none of its own
    assert all(p is par.plan.bucket_plan("blocks") for p in plans)
    # and the plan those stats resolve is the one the plan reports
    assert bk.plan_for(model.block_metas(d), d,
                       model.block_stats(d, (4, seq)),
                       segments=getattr(model, "block_segments",
                                        lambda _: None)(d)) \
        == par.plan.bucket_plan("blocks")


# budgets at which the search keeps the per-param partition (and takes
# optimizer offload) at 8 ranks, B8, under the TPU profile
OVERRIDE_BUDGETS = {"qwen3_1_7b": "auto:0.00035", "llama3_8b": "auto:0.0004",
                    "zamba2_1_2b": "auto:0.00089",
                    "qwen3_moe_30b_a3b": "auto:0.00058",
                    "qwen2_moe_a2_7b": "auto:0.00076",
                    "deepseek_coder_33b": "auto:0.00048",
                    "phi3_medium_14b": "auto:0.00054",
                    "gemma2_27b": "auto:0.00064"}


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_override_is_reported_as_it_runs(arch):
    """dp 8, auto_dp + auto + auto:<GB>, where the memory plan keeps the
    per-param partition: the MemoryPlan equals the reference's (its
    override carries no precisions); the blocks' reported plan is that
    partition with the precisions the reference's stack attaches when it
    runs it (`plan_for` on exec_dcfg with the per-device stats), so
    describe() is the reference's with them shown; the error-feedback
    mask is `endswith('_ef')` of those precisions; and parallelize refuses
    the plan, because it takes offload that no step executes."""
    from types import SimpleNamespace
    from repro_torch.core.api import parallelize
    from repro_torch.core.meta import leaves
    from repro_torch.train.train_step import ef_mask
    _, jmodel = jax_get_arch(arch, smoke=True)
    _, model = get_arch(arch, smoke=True)
    seq = 40 if arch == "zamba2_1_2b" else 16
    remat = OVERRIDE_BUDGETS[arch]
    d = DistConfig(mesh_shape=(8, 1), bucket_mode="auto_dp",
                   comm_precision="auto", remat=remat)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(8, 1),
                     bucket_mode="auto_dp", comm_precision="auto",
                     remat=remat)
    jp = jplan_parallel(jmodel, jd, JShapeConfig("t", seq, 8, "train"))
    with hw.use_profile(hw.TPU_V5E):
        p = plan_parallel(model, d, ShapeConfig("t", seq, 8, "train"))
    jmem, mem = jp.memory, p.memory
    assert jmem.bucket_plan is not None and jmem.bucket_plan.precisions \
        is None and jp.bucket_plan("blocks").precisions is None
    assert (mem.policy_spec, mem.peak_bytes, mem.offload_opt_state,
            mem.bucket_plan.groups, mem.bucket_plan.precisions) == \
        (jmem.policy_spec, jmem.peak_bytes, jmem.offload_opt_state,
         jmem.bucket_plan.groups, None)
    jmetas = jmodel.block_metas(jp.exec_dcfg)
    want = jbk.plan_for(jmetas, jp.exec_dcfg,
                        jmodel.block_stats(jp.exec_dcfg, (1, seq)))
    got = p.bucket_plan("blocks")
    assert (got.groups, got.precisions) == (want.groups, want.precisions)
    assert any(q.endswith("_ef") for q in got.precisions)
    shown = ",".join(sorted(set(want.precisions)))
    assert p.describe() == jp.describe().replace(
        " comm=auto ", f" comm=auto({shown}) ")
    mask = ef_mask(SimpleNamespace(plan=p, model=model))
    metas = model.block_metas(p.exec_dcfg)
    flags = [False] * len(leaves(metas))
    for grp, q in zip(got.index_groups(metas),
                      got.group_precisions(metas, p.exec_dcfg)):
        for i in grp:
            flags[i] = q.endswith("_ef")
    assert leaves(mask["blocks"]) == flags
    assert not any(leaves({k: v for k, v in mask.items() if k != "blocks"}))
    with pytest.raises(NotImplementedError, match="planned but not "
                       "executed"):
        parallelize(model, d, ShapeConfig("t", seq, 8, "train"),
                    device="cpu")
