"""Observability of the PyTorch port (`core/obs`: metrics, drift, trace)
against the JAX reference: host math only, on the CPU.

  * the registry's snapshot, JSONL lines and `record_peak` line, and the
    drift monitor's summary and report, for the same sequence of calls;
  * `modeled_step_time`, `step_wire_metrics` and `plan_trace(...).to_json()`
    for the three ported archs (smoke and full configs) at dp 1 and 8 x
    bf16 / fp8_ef / auto x block / auto / auto_dp, priced with the
    reference's TPU v5e profile: every number and every trace byte EXACTLY
    equal; and the trace invariant, `nonoverlapped_comm_s` read back from
    the JSON against `exposed_comm_time`'s `exposed_s`, to a relative
    1e-12 (the trace's microsecond timestamps round in the last bits; the
    reference's own test allows 1%);
  * `ring_lanes` on dicts from the reference's `core/context.ring_cost`;
  * what the port does not run yet raises (pipeline lanes, a ctx axis),
    serving lanes of a batcher without an event log raise as the
    reference's do (their parity is in tests/test_torch_serving_sched.py),
    and a span named for a CUDA device synchronizes it at both ends.
"""

import json
import math

import jax.numpy as jnp
import pytest
import torch

from repro.core.api import plan_parallel as jplan_parallel
from repro.core.context import ring_cost as jring_cost
from repro.core.dist import DistConfig as JDistConfig
from repro.core.obs import drift as jdrift
from repro.core.obs import metrics as jmetrics
from repro.core.obs import trace as jtrace
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.train.train_step import step_wire_metrics as jstep_wire_metrics

from repro_torch.core import hw
from repro_torch.core.api import plan_parallel
from repro_torch.core.autowrap import exposed_comm_time
from repro_torch.core.dist import DistConfig
from repro_torch.core.obs import drift, metrics, trace
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import PORTED, get_arch
from repro_torch.train.train_step import step_wire_metrics

# xlstm's plans are held in tests/test_torch_xlstm.py at SMOKE: over its
# 67-leaf superblock the joint precision DP (auto_dp with comm_precision
# auto) takes ~9 s a SMOKE plan and ~70 s a full-width plan on each side.
# seamless-m4t-large-v2 has no `blocks` group (two stacks, enc_blocks and
# dec_blocks, and no `block_metas`), which these cases read; both its
# stacks' plans, exposures, wire bytes and modeled step time are held in
# tests/test_torch_encdec.py
ARCHS = tuple(sorted(a for a in PORTED
                     if a not in ("xlstm_1_3b", "seamless_m4t_large_v2")))


# ---------------------------------------------------------------------------
# registry + drift monitor: the same calls, the same records
# ---------------------------------------------------------------------------
def _drive(mod_metrics, mod_drift, path):
    """One fixed sequence of registry and drift calls; returns what a
    caller reads back."""
    reg = mod_metrics.MetricsRegistry(ewma_alpha=0.3)
    mon = mod_drift.DriftMonitor(reg)
    for i in range(1, 6):
        reg.counter("train/steps").inc()
        reg.counter("train/wire_bytes/fp8_ef").inc(1.5e6 * i)
        reg.gauge("train/step_time_s").set(0.1 + 0.01 * i)
        reg.histogram("serve/latency_s", window=3).observe(0.02 * i)
        mon.record("step_time", 0.08, 0.1 + 0.01 * i, step=i)
        reg.dump_jsonl(str(path), step=i, phase="t")
    mon.record("peak_memory", 2.0e9, 2.4e9)
    mon.record("bubble", 0.0, 0.1)                 # NaN sentinel
    line = reg.record_peak("train", 3.5 * 2**30, 3.1 * 2**30,
                           budget_bytes=16 * 2**30, note="remat=full")
    with pytest.raises(TypeError, match="one name binds one type"):
        reg.gauge("train/steps")
    assert "train/steps" in reg
    return (reg.snapshot(), reg.names(), path.read_text(), line,
            mon.summary(), mon.report(), mon.worst(),
            mon.residuals("bubble"))


def test_registry_and_drift_equal_reference(tmp_path):
    got = _drive(metrics, drift, tmp_path / "port.jsonl")
    want = _drive(jmetrics, jdrift, tmp_path / "ref.jsonl")
    for g, w in zip(got[:-1], want[:-1]):
        assert g == w
    assert math.isnan(got[-1][0]) and math.isnan(want[-1][0])
    assert len(got[2].splitlines()) == 5
    assert drift.SUBSYSTEMS == jdrift.SUBSYSTEMS
    assert metrics.default_registry() is metrics.default_registry()


# ---------------------------------------------------------------------------
# modeled step time, wire bytes, trace JSON: every ported arch
# ---------------------------------------------------------------------------
def _shape(smoke, dp):
    return (16 if smoke else 2048), max(4, dp)


@pytest.mark.parametrize("mode", ("block", "auto", "auto_dp"))
@pytest.mark.parametrize("prec", ("bf16", "fp8_ef", "auto"))
@pytest.mark.parametrize("dp", (1, 8))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_time_wire_and_trace_equal_reference(arch, smoke, dp, prec,
                                                  mode):
    """Exact under TPU v5e: the plan's modeled step time, its wire bytes
    by precision and the trace's bytes; the trace's non-overlapped comm
    against exposed_comm_time's exposed_s to float rounding."""
    _, jmodel = jax_get_arch(arch, smoke=smoke)
    _, model = get_arch(arch, smoke=smoke)
    seq, batch = _shape(smoke, dp)
    jp = jplan_parallel(jmodel, JDistConfig(
        mesh_axes=("data", "model"), mesh_shape=(dp, 1), bucket_mode=mode,
        comm_precision=prec), JShapeConfig("t", seq, batch, "train"))
    shape = ShapeConfig("t", seq, batch, "train")
    d = DistConfig(mesh_shape=(dp, 1), bucket_mode=mode,
                   comm_precision=prec)
    with hw.use_profile(hw.TPU_V5E):
        p = plan_parallel(model, d, shape)
        got_t = drift.modeled_step_time(model, p, shape)
        doc = trace.plan_trace(model, p, shape, repeats=2).to_json()
        metas = model.block_metas(d)
        segs = model.block_segments(d) \
            if hasattr(model, "block_segments") else None
        exposed = exposed_comm_time(
            p.bucket_plan("blocks"), metas, d,
            model.block_stats(d, (batch // dp, seq)),
            segments=segs)["exposed_s"]
    want_t = jdrift.modeled_step_time(jmodel, jp, shape)
    assert got_t is not None and got_t == want_t
    assert step_wire_metrics(model, p) == jstep_wire_metrics(jmodel, jp)
    assert p.describe() == jp.describe()
    assert doc == jtrace.plan_trace(jmodel, jp, shape, repeats=2).to_json()
    with hw.use_profile(hw.TPU_V5E):
        one = trace.plan_trace(model, p, shape).to_doc()
    assert math.isclose(trace.nonoverlapped_comm_s(one), exposed,
                        rel_tol=1e-12, abs_tol=1e-18)
    assert (exposed > 0.0) == (dp > 1 or prec == "fp8_ef")
    assert trace.nonoverlapped_comm_s(json.loads(doc)) == \
        jtrace.nonoverlapped_comm_s(json.loads(doc))


@pytest.mark.parametrize("cp,window", [(2, None), (4, None), (8, None),
                                       (4, 256), (8, 128)])
def test_ring_lanes_equal_reference(cp, window):
    """The ring-lane layout of a reference `ring_cost` dict, byte for
    byte (the ring cost itself is context parallelism, not ported)."""
    jcfg, _ = jax_get_arch("qwen3_1_7b")
    jd = JDistConfig(mesh_axes=("data", "ctx", "model"),
                     mesh_shape=(1, cp, 1), cp_axis="ctx",
                     fsdp_axes=("data", "ctx"), param_dtype=jnp.bfloat16)
    ring = jring_cost(jcfg, jd, (1, 4096 // cp), window=window)
    tb, jtb = trace.TraceBuilder(), jtrace.TraceBuilder()
    end = trace.ring_lanes(tb, ring, t0=1e-3)
    assert end == jtrace.ring_lanes(jtb, ring, t0=1e-3) and end > 1e-3
    assert tb.to_json() == jtb.to_json()
    assert len(trace.lane_spans(tb.to_doc(), trace.PID_MODELED,
                                trace.TID_RING_COMM)) == cp - 1


def test_unported_lanes_raise():
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    p = plan_parallel(model, DistConfig(), shape)
    tb = trace.TraceBuilder()
    with pytest.raises(NotImplementedError, match="core/pipeline"):
        trace.pipeline_lanes(tb, 4, 2, "1f1b")
    # serving lanes are ported: a batcher without an event log is the
    # reference's ValueError, not a missing module
    with pytest.raises(ValueError, match="enable_trace"):
        trace.serving_lanes(tb, object())
    with pytest.raises(ValueError, match="enable_trace"):
        trace.plan_trace(model, p, shape, batcher=object())

    class Pipelined:
        pipelined = True
    with pytest.raises(NotImplementedError, match="pipelined"):
        drift.modeled_step_time(model, Pipelined(), shape)


def test_measured_span_synchronizes_a_cuda_device(monkeypatch):
    """The span covers the device's work: a CUDA device is synchronized
    before the span opens and before it closes; the CPU never is."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    tb = trace.TraceBuilder()
    with tb.measured_span("step", device="cuda:0"):
        assert len(calls) == 1
    with tb.measured_span("cpu step", tid=1, device="cpu"):
        pass
    with tb.measured_span("host", tid=2):
        pass
    assert calls == [torch.device("cuda:0")] * 2
    doc = tb.to_doc()
    for tid in (0, 1, 2):
        spans = trace.lane_spans(doc, trace.PID_MEASURED, tid)
        assert len(spans) == 1 and spans[0][1] >= 0.0
