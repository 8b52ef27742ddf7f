"""The memory plan of the PyTorch port (`core/memory`, `core/remat`'s
budgeted form, `core/api`'s exec_dcfg) against the JAX reference: host
math, on the CPU.

  * `plan_memory` of every ported arch (smoke and full) at dp 1 and 64,
    reorder on / off, for remat none, fsdp_only, save_dots, full, a named
    per-segment vector and auto:<GB> at three budgets (loose, between the
    uniform policies' peaks, infeasible), priced with the reference's TPU
    v5e profile: policies, policy_spec, peak_bytes, cost_s, the offload
    flags, the bucket override and every MemoryBreakdown (parts,
    peak_point, host_bytes) EXACTLY equal; the infeasible budget and the
    unsegmented model's named vector raise the same message;
  * the reference's memory tests (`tests/test_memory.py`) where they apply
    at pp = cp = 1, on the port: the remat grammar and its pointed errors,
    the segment_prefetch collapse, offload, the budget respected, a
    non-uniform vector that beats every uniform policy, exec_dcfg;
  * every row of `benchmarks/results/BENCH_memory.json` (llama3-8b,
    deepseek-coder-33b, qwen3-moe-30b-a3b; 16x16,
    (1, 4096)): policy_spec, peak_bytes and the offload flags exact;
    cost_s exactly the reference's current `plan_memory`, and within a
    relative 1e-12 of the file (the file's last bits predate a reordering
    of the reference's own float sums);
  * per-segment remat vectors train to the same loss and gradients as the
    uniform policy (rtol 1e-6 / 2e-5, atol 1e-6: the reference's bound);
  * the offload helpers raise where they cannot pin (never a silent no-op).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory as JMEM
from repro.core.dist import DistConfig as JDistConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import hw
from repro_torch.core import memory as MEM
from repro_torch.core.api import parallelize, plan_parallel
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.core.remat import (POLICIES, parse_policy_vector,
                                    parse_remat, resolve_segment_policies,
                                    whole_block_policy)
from repro_torch.data.pipeline import DataConfig, SyntheticC4, adapt_batch
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import PORTED, get_arch

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tuple(sorted(PORTED))
GIB = 1024**3
PROD = DistConfig(mesh_shape=(16, 16))       # planned as host math only
BSHAPE = (1, 4096)
FIXED = ("none", "fsdp_only", "save_dots", "full", "attn=full,mlp=none")


def _breakdowns_equal(got, want, case):
    assert len(got) == len(want), case
    for g, w in zip(got, want):
        assert (g.stage, g.peak_bytes, g.peak_point, g.host_bytes) == \
            (w.stage, w.peak_bytes, w.peak_point, w.host_bytes), case
        assert g.parts == w.parts, case
        assert g.describe() == w.describe(), case


def _plans_equal(got, want, case):
    for f in ("main_key", "segment_names", "policies", "policy_spec",
              "offload_opt_state", "offload_residuals", "budget_bytes",
              "peak_bytes", "cost_s"):
        assert getattr(got, f) == getattr(want, f), (case, f)
    if want.bucket_plan is None:
        assert got.bucket_plan is None, case
    else:
        assert (got.bucket_plan.groups, got.bucket_plan.precisions) == \
            (want.bucket_plan.groups, want.bucket_plan.precisions), case
    _breakdowns_equal(got.breakdown, want.breakdown, case)
    assert got.describe() == want.describe(), case


def _both(model, jmodel, d, jd, remat, bshape):
    """(port, reference) plan_memory results, or their error messages."""
    out = []
    for fn, m, cfg in ((None, model, d), (JMEM.plan_memory, jmodel, jd)):
        try:
            if fn is None:
                with hw.use_profile(hw.TPU_V5E):
                    out.append(MEM.plan_memory(m, cfg.with_(remat=remat),
                                               batch_shape=bshape))
            else:
                out.append(fn(m, cfg.with_(remat=remat), batch_shape=bshape))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("dp", [1, 64])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_memory_equals_reference(arch, smoke, dp):
    _, jmodel = jax_get_arch(arch, smoke=smoke)
    _, model = get_arch(arch, smoke=smoke)
    bshape = (2, 16) if smoke else (1, 2048)
    for reorder in (True, False):
        d = DistConfig(mesh_shape=(dp, 1), reorder=reorder)
        jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(dp, 1),
                         reorder=reorder)
        peaks = {}
        for remat in FIXED:
            got, want = _both(model, jmodel, d, jd, remat, bshape)
            case = (reorder, remat)
            if isinstance(want, str):
                # a named vector on an unsegmented block: the same error
                assert got == want, case
                continue
            _plans_equal(got, want, case)
            peaks[remat] = want.peak
        lo, hi = peaks["full"], peaks["none"]
        outcomes = []
        for b in (hi * 1.5, (lo + hi) / 2, lo * 0.01):
            remat = f"auto:{b / GIB:.9f}"
            got, want = _both(model, jmodel, d, jd, remat, bshape)
            case = (reorder, remat)
            if isinstance(want, str):
                assert got == want and "no plan fits" in want, case
            else:
                _plans_equal(got, want, case)
            outcomes.append(isinstance(want, str))
        assert outcomes == [False, False, True], outcomes


def test_parse_remat_forms():
    assert parse_remat("fsdp_only") == ("fsdp_only", None)
    kind, budget = parse_remat("auto:12.5")
    assert kind == "auto" and budget == 12.5 * 1024**3
    assert parse_remat("attn=full,mlp=fsdp_only")[0] == "vector"
    assert parse_policy_vector("full,none") == ((None, "full"),
                                                (None, "none"))


@pytest.mark.parametrize("bad,msg", [
    ("auto", "needs an HBM budget"),
    ("auto:", "needs an HBM budget"),
    ("auto:abc", "not a number"),
    ("auto:0", "finite GiB value > 0"),
    ("auto:-3", "finite GiB value > 0"),
    ("auto:nan", "finite GiB value > 0"),
    ("auto:inf", "finite GiB value > 0"),
    ("bogus", "unknown remat policy"),
    ("attn=bogus,mlp=full", "unknown policy"),
    ("attn=full,fsdp_only", "mix of named"),
    ("full,,none", "empty entry"),
])
def test_parse_remat_pointed_errors(bad, msg):
    with pytest.raises(ValueError, match=msg):
        parse_remat(bad)


def test_malformed_remat_fails_at_plan_time():
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", 32, 8, "train")
    small = DistConfig(param_dtype=torch.float32)
    for bad in ("auto:", "auto:x", "zzz"):
        with pytest.raises(ValueError):
            plan_parallel(model, small.with_(remat=bad), shape)
    with pytest.raises(ValueError, match="shape"):
        plan_parallel(model, small.with_(remat="auto:8"))


def test_resolve_segment_policies():
    assert resolve_segment_policies("full", ("attn", "mlp")) \
        == ("full", "full")
    assert resolve_segment_policies("attn=none,mlp=full",
                                    ("attn", "mlp")) == ("none", "full")
    assert resolve_segment_policies("none,full", ("attn", "mlp")) \
        == ("none", "full")
    with pytest.raises(ValueError, match="cover the block segments"):
        resolve_segment_policies("attn=none", ("attn", "mlp"))
    with pytest.raises(ValueError, match="3 entries for 2"):
        resolve_segment_policies("none,full,full", ("attn", "mlp"))
    with pytest.raises(ValueError, match="unresolved"):
        resolve_segment_policies("auto:8", ("attn", "mlp"))
    with pytest.raises(ValueError, match="unresolved"):
        whole_block_policy("auto:8")
    assert whole_block_policy("attn=none,mlp=full") == "full"
    assert whole_block_policy("save_dots") == "save_dots"
    assert whole_block_policy("attn=save_dots,mlp=fsdp_only") == "save_dots"
    assert whole_block_policy("attn=none,mlp=fsdp_only") == "fsdp_only"


@pytest.mark.parametrize("arch", ARCHS)
def test_simulator_policy_monotonicity(arch):
    """peak(full) <= peak(save_dots) <= peak(fsdp_only) <= peak(none) on
    both schedules, under both profiles (peaks do not depend on rates)."""
    _, model = get_arch(arch)
    for reorder in (True, False):
        d = PROD.with_(reorder=reorder)
        peaks = {}
        for pol in ("full", "save_dots", "fsdp_only", "none"):
            bk = MEM.simulate_peak(model, d.with_(remat=pol), BSHAPE)
            with hw.use_profile(hw.TPU_V5E):
                tpu = MEM.simulate_peak(model, d.with_(remat=pol), BSHAPE)
            assert len(bk) == 1 and bk[0].peak_bytes > 0
            assert tpu[0].peak_bytes == bk[0].peak_bytes
            peaks[pol] = bk[0].peak_bytes
        assert peaks["full"] <= peaks["save_dots"] \
            <= peaks["fsdp_only"] <= peaks["none"], (arch, reorder, peaks)


def test_segment_prefetch_off_models_the_executed_collapse():
    _, model = get_arch("qwen3_1_7b")
    off = PROD.with_(segment_prefetch=False)
    bk = MEM.simulate_peak(model, off.with_(remat="attn=full,mlp=none"),
                           BSHAPE)
    ref = MEM.simulate_peak(model, off.with_(remat="full"), BSHAPE)
    assert bk[0].peak_bytes == ref[0].peak_bytes
    mp = MEM.plan_memory(model, off.with_(remat="auto:8"),
                         batch_shape=BSHAPE)
    assert mp.segment_names == ("block",) and len(mp.policies) == 1
    mpv = MEM.plan_memory(
        model, off.with_(reorder=False, remat="attn=full,mlp=none"),
        batch_shape=BSHAPE)
    assert mpv.policies == ("full", "none")


def test_simulator_offload_reduces_device_peak():
    _, model = get_arch("llama3_8b")
    base = MEM.simulate_peak(model, PROD, BSHAPE)[0]
    off = MEM.simulate_peak(model, PROD, BSHAPE, offload_opt=True)[0]
    assert off.peak_bytes < base.peak_bytes and off.host_bytes > 0
    with pytest.raises(NotImplementedError, match="not yet ported"):
        MEM.simulate_peak(model, PROD.with_(mesh_axes=("data", "ctx"),
                                            mesh_shape=(1, 2)), BSHAPE)


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_budget_satisfied_every_arch(arch):
    _, model = get_arch(arch)
    mp = MEM.plan_memory(model, PROD.with_(remat="auto:8"),
                         batch_shape=BSHAPE)
    assert mp.budget_bytes == 8.0 * 1024**3
    assert mp.peak <= mp.budget_bytes, mp.describe()
    assert all(p in POLICIES for p in mp.policies)
    resolve_segment_policies(
        mp.policy_spec,
        mp.segment_names if mp.segment_names != ("block",) else ())
    with pytest.raises(ValueError, match="no plan fits .* budget"):
        MEM.plan_memory(model, PROD.with_(remat="auto:0.01"),
                        batch_shape=BSHAPE)


def test_auto_nonuniform_beats_every_uniform_policy():
    """For some ported arch and budget the chosen vector is non-uniform,
    takes no offload, and strictly beats every uniform policy that fits
    (tests/test_memory.py:205)."""
    found = None
    for arch in ("llama3_8b", "qwen3_1_7b"):
        _, model = get_arch(arch)
        d = PROD.with_(reorder=False)
        uni = {}
        for pol in POLICIES:
            mp = MEM.plan_memory(model, d.with_(remat=pol),
                                 batch_shape=BSHAPE)
            uni[pol] = (mp.peak, mp.cost_s)
        peaks = sorted(p for p, _ in uni.values())
        for i in range(len(peaks) - 1):
            budget = (peaks[i] + peaks[i + 1]) / 2 / 1024**3
            try:
                mp = MEM.plan_memory(
                    model, d.with_(remat=f"auto:{budget:.6f}"),
                    batch_shape=BSHAPE)
            except ValueError:
                continue
            if len(set(mp.policies)) > 1 and not mp.offload_opt_state \
                    and not mp.offload_residuals:
                for pol, (peak, cost) in uni.items():
                    if peak <= mp.budget_bytes:
                        assert mp.cost_s < cost, (arch, mp.policies, pol)
                found = (arch, mp.policies, budget)
                break
        if found:
            break
    assert found, "no ported arch produced a winning non-uniform vector"


def test_auto_prefers_cheapest_when_budget_is_loose():
    _, model = get_arch("qwen3_1_7b")
    mp = MEM.plan_memory(model, PROD.with_(remat="auto:16"),
                         batch_shape=BSHAPE)
    assert set(mp.policies) == {"none"}
    assert not mp.offload_opt_state and not mp.offload_residuals


def test_plan_parallel_resolves_auto_into_exec_dcfg():
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", 32, 8, "train")
    small = DistConfig(param_dtype=torch.float32)
    plan = plan_parallel(model, small.with_(remat="auto:8"), shape)
    assert plan.memory is not None and plan.remat == "auto:8"
    assert parse_remat(plan.exec_dcfg.remat)[0] != "auto"
    assert plan.memory.peak <= 8 * 1024**3
    assert "mem[" in plan.describe()
    fixed = plan_parallel(model, small, shape)
    assert fixed.memory is not None
    assert fixed.memory.policy_spec == small.remat
    assert fixed.exec_dcfg == small


@pytest.mark.parametrize("arch", ("llama3_8b", "deepseek_coder_33b",
                                  "qwen3_moe_30b_a3b"))
def test_bench_memory_llama3_rows_reproduced_under_the_tpu_profile(arch):
    """Each arch's rows of benchmarks/results/BENCH_memory.json (16x16,
    analytic stats at (1, 4096)): policy, peak and offload EXACT, cost_s
    equal to the reference's code and to the file within 1e-12."""
    doc = json.loads((ROOT / "benchmarks/results/BENCH_memory.json")
                     .read_text())
    assert doc["mesh"] == "16x16"
    want = doc["archs"][arch]["modes"]
    _, model = get_arch(arch)
    _, jmodel = jax_get_arch(arch)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(16, 16))
    jstats = jmodel.block_stats(jd, BSHAPE)
    for mode in ("none", "save_dots", "fsdp_only", "full",
                 f"auto:{doc['budget_gb']:g}"):
        with hw.use_profile(hw.TPU_V5E):
            mp = MEM.plan_memory(model, PROD.with_(remat=mode),
                                 batch_shape=BSHAPE)
        row = want["auto" if mode.startswith("auto") else mode]
        assert mp.policy_spec == row["policy_spec"], mode
        assert mp.peak == row["peak_bytes"], mode
        assert mp.offload_opt_state == row["offload_opt_state"], mode
        assert mp.offload_residuals == row["offload_residuals"], mode
        jmp = JMEM.plan_memory(jmodel, jd.with_(remat=mode),
                               batch_shape=BSHAPE, stats=jstats)
        assert mp.cost_s == jmp.cost_s, mode
        assert mp.cost_s == pytest.approx(row["cost_s"], rel=1e-12), mode


def test_per_segment_vector_parity_single_device():
    """Per-segment remat vectors give the uniform policy's loss and grads
    on both schedules (tests/test_memory.py:274)."""
    cfg, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", 32, 4, "train")
    ds = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    base = DistConfig(param_dtype=torch.float32)
    batch = adapt_batch(ds.batch(0), model.input_specs(shape, base), 0)

    def run(**kw):
        par = parallelize(model, base.with_(**kw), shape, device="cpu")
        storage = par.init_storage(torch.Generator().manual_seed(0))
        return par.loss_step()(storage, batch)

    ref_l, ref_g = run(reorder=False, remat="fsdp_only")
    for kw in (dict(reorder=False, remat="attn=full,mlp=fsdp_only"),
               dict(reorder=False, remat="attn=none,mlp=save_dots"),
               dict(reorder=True, remat="attn=full,mlp=save_dots")):
        loss, grads = run(**kw)
        np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-6,
                                   err_msg=str(kw))
        for (n, a), (_, b) in zip(named_leaves(grads), named_leaves(ref_g)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=1e-6, err_msg=f"{kw} {n}")


def test_offload_raises_where_it_cannot_pin(monkeypatch):
    tree = {"a": torch.ones(4), "b": {"c": torch.zeros(2, 2)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not MEM.host_offload_supported()
    with pytest.raises(RuntimeError, match="pinned host memory"):
        MEM.to_host(tree)
    back = MEM.to_device(tree, "cpu")
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert jnp.dtype(jnp.float32).itemsize == torch.float32.itemsize


def test_trainer_memory_report_on_cpu(tmp_path):
    """The report carries the modeled peak, the resolved spec and the
    per-stage breakdown; the measured peak is the card's alone."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _, model = get_arch("qwen3_1_7b", smoke=True)
    tr = Trainer(model, DistConfig(param_dtype=torch.float32,
                                   remat="auto:1"),
                 ShapeConfig("t", 16, 4, "train"), AdamWConfig(),
                 TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path)),
                 device="cpu")
    rep = tr.memory_report()
    mem = tr.plan.memory
    assert rep["modeled_peak_bytes"] == mem.peak
    assert rep["policy_spec"] == mem.policy_spec == tr.plan.exec_dcfg.remat
    assert rep["per_stage"] == [b.describe() for b in mem.breakdown]
    assert "measured_peak_bytes" not in rep
