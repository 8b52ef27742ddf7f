"""The profile -> calibrate -> replan loop of the PyTorch port
(`core/obs/profile`, `core/obs/calibrate`, the Trainer's replan hook)
against the JAX reference, on the CPU.

  * one hand-built `MeasuredProfile` JSON given to both packages, priced
    with the reference's TPU v5e profile: `calibrated_block_stats`, plans
    under `calibration` (int8 picked on measured rates, fp8 back after),
    `calibrated_step_time`, `replan`'s delta and `measured_overlay`'s
    trace EXACTLY equal.  One named departure: the port pins the analytic
    activation footprint while calibrated stats are installed (the
    reference's calibrated memory plan scales activations with compute
    time), so the replanned plan's modeled peak is compared apart;
  * the port's own `profile_step` at smoke size: span categories, wall
    step, closure within 2%, a JSON round trip through both packages,
    and a failing codec or device raises instead of falling back;
  * two gloo ranks: a bandwidth per FSDP axis, per-rank rows of both
    ranks, one profile on both, and a Trainer whose ranks drift apart
    still replans on both at the same step;
  * the Trainer's replan hook, deterministic: step times are injected
    (StepTimer patched), not read from the CPU's clock.
"""

import dataclasses
import re

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import autowrap as jaw
from repro.core import irgraph as jirgraph
from repro.core.api import plan_parallel as jplan_parallel
from repro.core.dist import DistConfig as JDistConfig
from repro.core.obs import calibrate as jcal
from repro.core.obs import profile as jprofile
from repro.core.obs import trace as jtrace
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import autowrap as aw
from repro_torch.core import hw, irgraph
from repro_torch.core.api import plan_parallel
from repro_torch.core.bucketing import assign_segments
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.core.obs import calibrate as cal
from repro_torch.core.obs import profile as prof_mod
from repro_torch.core.obs import trace
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.launch import dryrun
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.train_step import step_wire_metrics

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

DENSE = ("llama3_8b", "qwen3_1_7b")
PEAK = re.compile(r"peak=[0-9.]+GiB")


def _profile_json(seg_scales=None):
    """A profile as `profile_step` would write it, every field filled:
    uneven segment scales, a measured data-axis bandwidth, int8 ten times
    faster than fp8, collective and codec spans, two ranks."""
    _, model = get_arch("qwen3_1_7b", smoke=True)
    d = DistConfig()
    segs = model.block_segments(d)
    names = [n for n, _ in named_leaves(model.block_metas(d))]
    seg_of = assign_segments(names, segs.param_globs, segs.names)
    return prof_mod.MeasuredProfile(
        meta={"plan": "hand-built", "seg_names": ["attn", "mlp"],
              "backend": "cpu", "steps": 2},
        wall_step_s=0.25,
        spans=({"name": "compute[attn]", "cat": "compute", "dur_s": 1e-3,
                "modeled_s": 4e-4, "segment": "attn"},
               {"name": "AG[bucket 0]", "cat": "all_gather", "dur_s": 3e-4,
                "modeled_s": 1e-4, "bytes": 1 << 20, "bucket": 0},
               {"name": "RS[bucket 0]", "cat": "reduce_scatter",
                "dur_s": 2e-4, "modeled_s": 1e-4, "bytes": 1 << 20,
                "bucket": 0},
               {"name": "quant[fp8 n=4096]", "cat": "quant", "dur_s": 2e-5,
                "bytes": 8192, "codec": "fp8"}),
        seg_scales=seg_scales or {"attn": 3.0, "mlp": 0.5},
        param_segment={n: segs.names[s] for n, s in zip(names, seg_of)},
        comm_bandwidth={"data": {"bytes_per_s": 2.5e10, "alpha_s": 4e-5}},
        quant_rates={"fp8": 2.0e10, "int8": 2.0e11},
        rank_step_s={"0": 0.25, "1": 0.27}).to_json()


def _pair(arch, smoke, dp, prec, mode, remat="fsdp_only"):
    seq, batch = (16, max(4, dp)) if smoke else (2048, max(4, dp))
    _, jmodel = jax_get_arch(arch, smoke=smoke)
    _, model = get_arch(arch, smoke=smoke)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(dp, 1),
                     bucket_mode=mode, comm_precision=prec, remat=remat)
    d = DistConfig(mesh_shape=(dp, 1), bucket_mode=mode,
                   comm_precision=prec, remat=remat)
    shape = ShapeConfig("t", seq, batch, "train")
    jp = jplan_parallel(jmodel, jd, JShapeConfig("t", seq, batch, "train"))
    with hw.use_profile(hw.TPU_V5E):
        p = plan_parallel(model, d, shape)
    return jmodel, jp, model, p, shape


# ---------------------------------------------------------------------------
# the hand-built profile through both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_calibrated_block_stats_equal_reference(arch, smoke):
    s = _profile_json()
    _, jmodel = jax_get_arch(arch, smoke=smoke)
    _, model = get_arch(arch, smoke=smoke)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(8, 1))
    d = DistConfig(mesh_shape=(8, 1))
    jbase = jmodel.block_stats(jd, (4, 64))
    base = model.block_stats(d, (4, 64))
    got = cal.calibrated_block_stats(base,
                                     prof_mod.MeasuredProfile.from_json(s))
    want = jcal.calibrated_block_stats(
        jbase, jprofile.MeasuredProfile.from_json(s))
    for f in ("param_flops", "param_bytes", "act_bytes", "source",
              "seg_act_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.source == "calibrated" and got.cache_key() != base.cache_key()
    empty = prof_mod.MeasuredProfile.empty()
    assert cal.calibrated_block_stats(base, empty) is base
    assert cal.calibrated_block_stats(base, None) is base
    assert cal.calibrated_block_stats(None, empty) is None


def test_calibration_installs_restores_and_picks_int8_as_reference():
    """Measured codec rates move the precision DP from fp8 to int8 in
    both packages alike, and the priors come back on exit."""
    _, jmodel = jax_get_arch("qwen3_1_7b", smoke=True)
    _, model = get_arch("qwen3_1_7b", smoke=True)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(256, 1),
                     comm_precision="auto")
    d = DistConfig(mesh_shape=(256, 1), comm_precision="auto")
    jnodes = jirgraph.build_nodes(jmodel.block_metas(jd), jd,
                                  jmodel.block_stats(jd, (8, 64)))
    s = _profile_json()
    p = prof_mod.MeasuredProfile.from_json(s)
    with hw.use_profile(hw.TPU_V5E):
        nodes = irgraph.build_nodes(model.block_metas(d), d,
                                    model.block_stats(d, (8, 64)))
        before = aw.dp_buckets_precision(nodes, d)
        analytic_bw = hw.axis_bandwidth("data")
        with cal.calibration(p):
            assert hw.axis_bandwidth("data") == hw.AxisBandwidth(2.5e10,
                                                                 4e-5)
            assert irgraph.quant_codec_rate("int8") == 2.0e11
            got = aw.dp_buckets_precision(nodes, d)
        assert hw.axis_bandwidth("data") == analytic_bw
        assert irgraph.quant_codec_rate("int8") == \
            hw.TPU_V5E.hbm_bandwidth / 2.0
        after = aw.dp_buckets_precision(nodes, d)
    with jcal.calibration(jprofile.MeasuredProfile.from_json(s)):
        want = jaw.dp_buckets_precision(jnodes, jd)
    jbefore = jaw.dp_buckets_precision(jnodes, jd)

    def names(r):
        return [[n.name for n in b] for b in r[0]], r[1]
    assert names(got) == names(want)
    assert names(before) == names(after) == names(jbefore)
    assert any(q.startswith("int8") for q in got[1])
    assert not any(q.startswith("int8") for q in before[1])
    assert any(q.startswith("fp8") for q in before[1])


@pytest.mark.parametrize("mode", ("block", "auto_dp"))
@pytest.mark.parametrize("prec", ("bf16", "auto"))
@pytest.mark.parametrize("dp", (1, 8))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_step_time_replan_and_overlay_equal_reference(arch, smoke, dp,
                                                      prec, mode):
    """Exact: calibrated_step_time, the replan delta (the replanned
    plan's modeled peak apart: the port's stays the analytic one) and the
    overlay trace's bytes."""
    jmodel, jp, model, p, shape = _pair(arch, smoke, dp, prec, mode)
    s = _profile_json()
    jprof = jprofile.MeasuredProfile.from_json(s)
    prof = prof_mod.MeasuredProfile.from_json(s)
    with hw.use_profile(hw.TPU_V5E):
        got_t = cal.calibrated_step_time(model, p, shape, prof)
        new_p, delta = cal.replan(model, p, shape, prof)
        doc = trace.plan_trace(model, p, shape, profile=prof).to_json()
        analytic_peak = p.memory.peak
    assert got_t == jcal.calibrated_step_time(jmodel, jp, shape, jprof)
    _, jdelta = jcal.replan(jmodel, jp, shape, jprof)
    assert doc == jtrace.plan_trace(jmodel, jp, shape,
                                    profile=jprof).to_json()
    assert new_p.memory.peak == analytic_peak
    delta["after"] = PEAK.sub("peak=*", delta["after"])
    jdelta["after"] = PEAK.sub("peak=*", jdelta["after"])
    jdelta["changed"] = jdelta["after"] != PEAK.sub("peak=*",
                                                    jdelta["before"])
    assert delta["changed"] == (delta["after"] != PEAK.sub(
        "peak=*", delta["before"]))
    assert delta == jdelta
    assert new_p.dcfg is p.dcfg


@pytest.mark.parametrize("scale", (1.0, 40.0))
def test_calibrated_memory_plan_keeps_analytic_activations(scale):
    """The departure, shown: scaling a segment's bytes to scale its time
    scales the reference's modeled activations with it; the port's
    installed stats pin the analytic footprint, so its replanned peak is
    the analytic one whatever the scales."""
    jmodel, jp, model, p, shape = _pair("qwen3_1_7b", False, 8, "bf16",
                                        "block", remat="none")
    s = _profile_json({"attn": scale, "mlp": scale})
    with hw.use_profile(hw.TPU_V5E):
        new_p, _ = cal.replan(model, p, shape,
                              prof_mod.MeasuredProfile.from_json(s))
    jnew, _ = jcal.replan(jmodel, jp, shape,
                          jprofile.MeasuredProfile.from_json(s))
    assert new_p.memory.peak == p.memory.peak == jp.memory.peak
    if scale == 1.0:
        assert jnew.memory.peak == jp.memory.peak
    else:
        assert jnew.memory.peak > 1.5 * jp.memory.peak


def test_zamba2_has_no_installed_stats_in_either_package():
    """zamba2 has no `measured_stats`: calibration moves only the hw
    rates, in both packages."""
    jmodel, jp, model, p, shape = _pair("zamba2_1_2b", True, 8, "auto",
                                        "auto_dp")
    s = _profile_json()
    prof = prof_mod.MeasuredProfile.from_json(s)
    with cal._installed_stats(model, p, shape, prof) as st:
        assert st is None
    with hw.use_profile(hw.TPU_V5E):
        got = cal.calibrated_step_time(model, p, shape, prof)
    assert got == jcal.calibrated_step_time(
        jmodel, jp, shape, jprofile.MeasuredProfile.from_json(s))
    assert prof_mod._profile_segments(model, p.dcfg, (4, 16), 1, [],
                                      torch.device("cpu")) == ({}, {}, [])


# ---------------------------------------------------------------------------
# the port's own profiler, on the CPU
# ---------------------------------------------------------------------------
def test_profile_step_on_cpu(monkeypatch):
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    d = DistConfig(param_dtype=torch.float32, bucket_mode="auto",
                   comm_precision="fp8_ef")
    p = plan_parallel(model, d, shape)
    before = (quant_ops.quant_launches, quant_ops.dequant_launches)
    prof = prof_mod.profile_step(model, p, shape, steps=2, device="cpu")
    assert (quant_ops.quant_launches, quant_ops.dequant_launches) == before
    assert {sp["cat"] for sp in prof.spans} == {"compute", "quant", "wall"}
    assert len([sp for sp in prof.spans if sp["cat"] == "wall"]) == 2
    assert prof.wall_step_s > 0.0
    assert set(prof.seg_scales) == {"attn", "mlp"}
    assert all(v > 0.0 for v in prof.seg_scales.values())
    assert set(prof.quant_rates) == {"fp8"} and prof.comm_bandwidth == {}
    assert prof.rank_step_s == {"0": prof.wall_step_s}
    assert prof.meta["backend"] == "cpu" and prof.meta["closure_factor"] > 0
    assert prof.meta["seg_names"] == ["attn", "mlp"]
    s = prof.to_json()
    assert prof_mod.MeasuredProfile.from_json(s) == prof
    assert jprofile.MeasuredProfile.from_json(s).to_json() == s
    given = prof_mod.profile_step(model, p, shape, steps=1,
                                  wall_step_s=0.5, device="cpu")
    assert given.wall_step_s == 0.5 and given.spans[-1]["cat"] == "wall"
    # the closure on fixed measurements: the segment and codec timings a
    # loaded machine takes vary, and a codec time near the measured wall
    # leaves the segment scales nothing to close on (the closure scales
    # only them), so the 2% check runs on given segment scales, codec rate
    # and wall, through profile_step
    fixed = ({"attn": 1.0e5, "mlp": 1.0e4}, dict(prof.param_segment),
             ["attn", "mlp"])
    monkeypatch.setattr(prof_mod, "_profile_segments",
                        lambda *a, **k: fixed)
    monkeypatch.setattr(prof_mod, "_profile_quant",
                        lambda *a, **k: {"fp8": 1.0e8})
    pinned = prof_mod.profile_step(model, p, shape, steps=1,
                                   wall_step_s=0.2, device="cpu")
    assert pinned.meta["closure_factor"] > 0 and pinned.wall_step_s == 0.2
    closed = cal.calibrated_step_time(model, p, shape, pinned)
    assert abs(closed - pinned.wall_step_s) <= 0.02 * pinned.wall_step_s


def test_profile_step_raises_instead_of_falling_back(monkeypatch):
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    p = plan_parallel(model, DistConfig(param_dtype=torch.float32,
                                        comm_precision="auto"), shape)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prof_mod.profile_step(model, p, shape, wall_step_s=0.1)

    def broken(x, codec, stochastic=False, out=None):
        raise RuntimeError("codec launch failed")
    monkeypatch.setattr(quant_ops, "roundtrip", broken)
    with pytest.raises(RuntimeError, match="codec launch failed"):
        prof_mod.profile_step(model, p, shape, wall_step_s=0.1,
                              device="cpu")
    with pytest.raises(RuntimeError, match="codec launch failed"):
        dryrun.harvest_quant_timing([1 << 12], device="cpu")


def test_harvest_quant_timing_on_cpu():
    q = dryrun.harvest_quant_timing([1 << 14, 1 << 16, 300], codec="int8",
                                    iters=2, device="cpu")
    assert q["codec"] == "int8" and q["rate_bytes_per_s"] > 0.0
    assert [s["n_elems"] for s in q["samples"]] == [256, 1 << 14, 1 << 16]
    for s in q["samples"]:
        assert s["t_us"] > 0.0 and s["bytes"] == 2 * s["n_elems"]
    assert dryrun.harvest_quant_timing([0], device="cpu") is None


# ---------------------------------------------------------------------------
# the Trainer's replan hook, with injected step times
# ---------------------------------------------------------------------------
class _FixedTimer:
    """StepTimer whose step takes `dt` seconds, whatever the clock says."""
    dt_s = 1.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dt = type(self).dt_s
        return False


def _trainer(tmp_path, apply, total=4, dcfg=None, **kw):
    _, model = get_arch("qwen3_1_7b", smoke=True)
    tcfg = trainer_mod.TrainerConfig(
        total_steps=total, ckpt_every=100, log_every=1, warmup=1,
        ckpt_dir=str(tmp_path), replan_threshold=0.5, replan_patience=2,
        replan_apply=apply, replan_profile_steps=1, **kw)
    return trainer_mod.Trainer(
        model, dcfg or DistConfig(param_dtype=torch.float32),
        ShapeConfig("t", 16, 4, "train"), AdamWConfig(lr=1e-3), tcfg,
        device="cpu")


@pytest.mark.parametrize("apply", [True, False], ids=["apply", "log"])
def test_trainer_replan_hook(tmp_path, monkeypatch, apply):
    """A 0.5 s step (the smoke plan models microseconds) trips the streak
    at step `replan_patience`; the replan re-anchors the promise on the injected
    wall (the memory plan's cost moves, so the plan changes); applied, the
    loop restarts onto it through a checkpoint and no second replan arms."""
    monkeypatch.setattr(trainer_mod, "StepTimer", _FixedTimer)
    tr = _trainer(tmp_path, apply, metrics_jsonl=str(tmp_path / "m.jsonl"))
    modeled0 = tr._modeled_step_s
    _FixedTimer.dt_s = 0.5
    tr.run()
    assert [d["step"] for d in tr.replans] == ([2] if apply else [2, 4])
    delta = tr.replans[0]
    assert delta["changed"] and delta["applied"] == apply
    assert delta["wall_step_s"] == pytest.approx(_FixedTimer.dt_s)
    assert tr.profile is not None and tr.profile.wall_step_s == \
        delta["wall_step_s"]
    r = tr.registry
    assert r.counter("replan/count").value == len(tr.replans)
    assert r.counter("train/steps").value == 4
    wire = step_wire_metrics(tr.model, tr.plan)["by_precision"]
    assert {k: r.counter(f"train/wire_bytes/{k}").value for k in wire} == \
        {k: 4 * v for k, v in wire.items()}
    rows = tr.drift.records["step_time"]
    assert [row["modeled"] for row in rows[:2]] == [modeled0] * 2
    if apply:
        assert tr.plan.describe() == delta["after"]
        assert (tmp_path / "step_00000002").exists()
        assert abs(rows[-1]["rel"]) <= 0.02
        assert tr._modeled_step_s == cal.calibrated_step_time(
            tr.model, tr.plan, tr.shape, tr.profile)
    else:
        assert tr.plan.describe() == delta["before"]
        assert tr._modeled_step_s == modeled0
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 4


def test_trainer_keeps_a_replanned_plan_it_cannot_run(tmp_path,
                                                      monkeypatch):
    """A replan whose memory plan takes host offload (which no step
    executes) is recorded, not applied."""
    monkeypatch.setattr(trainer_mod, "StepTimer", _FixedTimer)
    tr = _trainer(tmp_path, True, total=2)
    _FixedTimer.dt_s = 0.5
    real = trainer_mod.obs_replan

    def offloading(model, plan, shape, profile):
        new, delta = real(model, plan, shape, profile)
        mem = dataclasses.replace(new.memory, offload_residuals=True)
        return dataclasses.replace(new, memory=mem), delta
    monkeypatch.setattr(trainer_mod, "obs_replan", offloading)
    before = tr.plan
    tr.run()
    (delta,) = tr.replans
    assert delta["changed"] and not delta["applied"]
    assert "host offload" in delta["not_applied"] and tr.plan is before


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------
def _worker(rank, tmp):
    torch.set_num_threads(1)        # two ranks beside the other test workers
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                            rank=rank, world_size=2)
    try:
        _, model = get_arch("qwen3_1_7b", smoke=True)
        shape = ShapeConfig("t", 16, 4, "train")
        d = DistConfig(mesh_shape=(2, 1), param_dtype=torch.float32,
                       bucket_mode="auto")
        p = plan_parallel(model, d, shape)
        prof = prof_mod.profile_step(model, p, shape, steps=1,
                                     wall_step_s=0.1 * (rank + 1),
                                     device="cpu")
        # the ranks drift apart: rank 1's steps take what the plan
        # models, rank 0's 0.5 s; both must replan at step 1
        trainer_mod.StepTimer = _FixedTimer
        tr = _trainer(f"{tmp}/ckpt", True, total=3, dcfg=d.with_(
            bucket_mode="block"))
        tr.tcfg.replan_patience = 1
        _FixedTimer.dt_s = 0.5 if rank == 0 else tr._modeled_step_s
        tr.run()
        torch.save({"profile": prof.to_json(),
                    "replans": [(x["step"], x["applied"], x["after"])
                                for x in tr.replans],
                    "plan": tr.plan.describe(),
                    "steps": tr.registry.counter("train/steps").value},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_profile_and_replan_together(tmp_path):
    mp.spawn(_worker, args=(str(tmp_path),), nprocs=2, join=True)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
              for r in (0, 1))
    prof = prof_mod.MeasuredProfile.from_json(r0["profile"])
    assert r0["profile"] == r1["profile"]           # rank 0's, on both
    assert prof.rank_step_s == {"0": 0.1, "1": 0.2}
    bw = prof.comm_bandwidth["data"]
    assert set(prof.comm_bandwidth) == {"data"}
    assert bw["bytes_per_s"] > 0.0 and bw["alpha_s"] >= 0.0
    cats = [sp["cat"] for sp in prof.spans]
    assert cats.count("all_gather") == cats.count("reduce_scatter") >= 1
    assert r0["replans"] == r1["replans"] and r0["replans"][0][:2] == \
        (1, True)
    assert r0["plan"] == r1["plan"] == r0["replans"][-1][2]
    assert r0["steps"] == r1["steps"] == 3
