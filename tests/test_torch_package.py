"""Package-level contracts of the PyTorch port: it imports without JAX or
the reference, never runs on the CPU unless asked, keeps CPU tensors away
from the kernel build, and its launchers (serve and train) run end to end
on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.dist import DistConfig, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.cross_entropy import ops as xent_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models.common import ShapeConfig
from repro_torch.models.dense import DenseLM
from repro_torch.models.registry import ARCH_IDS, PORTED, get_arch
from repro_torch.train import serve as SV

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(code_or_args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, *code_or_args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_neither_jax_nor_the_reference():
    """Every module of the port, and chip_smoke.py, import without JAX."""
    code = (
        f"import sys; sys.path.insert(0, {str(SRC.parent)!r})\n"
        "import pkgutil, importlib, repro_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert 'repro_torch.kernels.rmsnorm.ops' in mods, mods\n"
        "assert 'repro_torch.kernels.flash_attention.ops' in mods, mods\n"
        "for m in ('kernels.cross_entropy.ops', 'kernels.adamw.ops',\n"
        "          'kernels.quant.ops', 'kernels.quant.ref',\n"
        "          'kernels.ssd.ops', 'kernels.ssd.ref', 'models.zamba2',\n"
        "          'models.xlstm', 'configs.zamba2_1_2b',\n"
        "          'core.collectives', 'core.stack', 'core.api',\n"
        "          'core.hw', 'core.irgraph', 'core.autowrap',\n"
        "          'core.bucketing', 'core.memory', 'core.memory.simulator',\n"
        "          'core.memory.planner', 'core.memory.offload',\n"
        "          'train.trainer', 'launch.train', 'checkpoint.checkpointer',\n"
        "          'core.obs', 'core.obs.metrics', 'core.obs.drift',\n"
        "          'core.obs.trace', 'core.obs.calibrate', 'core.obs.profile',\n"
        "          'launch.dryrun', 'core.serving', 'core.serving.pages',\n"
        "          'core.serving.prefix', 'core.serving.scheduler',\n"
        "          'core.serving.router',\n"
        "          'data.pipeline', 'ft.failures', 'optim.adamw'):\n"
        "    assert 'repro_torch.' + m in mods, m\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 40


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model = get_arch("llama3_8b", smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SV.init_serve_params(model, dcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SV.alloc_cache(model, ShapeConfig("d", 8, 2, "decode"), dcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--smoke"])
    assert resolve_device("cpu").type == "cpu"


def test_launcher_runs_end_to_end_on_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--smoke", "--device",
              "cpu", "--gen", "3"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("generated:")
    assert any(l.startswith("steady:") for l in lines)


def test_cpu_tensors_never_touch_the_kernel_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before = (rms_ops.launches, flash_ops.launches)
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        "qwen3_1_7b", True, 2, 5, 3, device="cpu")
    padded = launch.make_prompts(cfg, 2, 5, 3, torch.device("cpu"))
    tokens, _ = launch.generate(params, prefill, decode, padded, 5, 3)
    assert tokens.shape == (2, 3)
    assert (rms_ops.launches, flash_ops.launches) == before


def test_registry_ports_two_archs_and_names_the_rest():
    """Each ported arch builds its family's model class; the other one
    raises "not yet ported"."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.moe import MoELM
    from repro_torch.models.xlstm import XLSTMLM
    from repro_torch.models.zamba2 import Zamba2LM
    want = {"llama3_8b": ("dense", DenseLM), "qwen3_1_7b": ("dense", DenseLM),
            "deepseek_coder_33b": ("dense", DenseLM),
            "phi3_medium_14b": ("dense", DenseLM),
            "gemma2_27b": ("dense", DenseLM),
            "qwen3_moe_30b_a3b": ("moe", MoELM),
            "qwen2_moe_a2_7b": ("moe", MoELM),
            "zamba2_1_2b": ("zamba", Zamba2LM),
            "xlstm_1_3b": ("xlstm", XLSTMLM),
            "seamless_m4t_large_v2": ("encdec", EncDecLM)}
    assert set(PORTED) == set(want)
    for arch in PORTED:
        for smoke in (True, False):
            cfg, model = get_arch(arch, smoke=smoke)
            family, cls = want[arch]
            assert cfg.family == family and type(model) is cls, arch
    assert len(set(ARCH_IDS) - set(PORTED)) == 1
    for arch in set(ARCH_IDS) - set(PORTED):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_arch(arch)
    with pytest.raises(KeyError):
        get_arch("no_such_arch")


def test_unported_variants_and_meshes_raise():
    cfg, model = get_arch("llama3_8b", smoke=True)
    # gemma2's variants build (pairs need an even layer count); an FFN
    # the reference does not have raises
    for kw in (dict(post_norms=True), dict(local_global_alternate=True),
               dict(gated_mlp="geglu"), dict(gated_mlp="gelu")):
        DenseLM(dataclasses.replace(cfg, **kw))
    with pytest.raises(ValueError, match="whole local/global pairs"):
        DenseLM(dataclasses.replace(cfg, n_layers=3,
                                    local_global_alternate=True))
    with pytest.raises(NotImplementedError, match="reglu"):
        DenseLM(dataclasses.replace(cfg, gated_mlp="reglu"))
    dcfg = DistConfig(mesh_shape=(1, 2), param_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="one device"):
        SV.make_prefill_step(model, dcfg, ShapeConfig("p", 8, 2, "prefill"))
    with pytest.raises(NotImplementedError, match="one device"):
        SV.alloc_cache(model, ShapeConfig("d", 8, 2, "decode"), dcfg,
                       device="cpu")


def test_full_width_llama3_layout_and_size():
    """The full config's head layout needs no padding, and its parameter
    count is the published 8.03B."""
    cfg, model = get_arch("llama3_8b")
    assert cfg.gqa_layout(1) == dict(mode="grouped", hq=32, kvp=8, g=4,
                                     g_real=4)
    assert round(cfg.n_params() / 1e9, 2) == 8.03
    dcfg = DistConfig(param_dtype=torch.bfloat16)
    m = model.metas(dcfg)
    assert m["blocks"]["attn"]["wk"].global_shape == (1024, 4096)
    assert m["head"].global_shape == (4096, 128_256)


def test_train_launcher_runs_end_to_end_on_cpu(tmp_path):
    r = _run(["-m", "repro_torch.launch.train", "--smoke", "--no-reorder",
              "--device", "cpu", "--steps", "2", "--seq", "16", "--batch",
              "2", "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("plan: mesh[data=1xmodel=1]")
    assert [l.split()[:2] for l in lines if l.startswith("step ")] == \
        [["step", "1"], ["step", "2"]]
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_train_launcher_runs_the_planners_on_cpu(tmp_path):
    """--bucket-mode auto_dp, --comm-precision auto and --remat auto:<GB>
    resolve and train 3 steps: the printed plan shows the per-bucket
    precisions and the memory plan."""
    r = _run(["-m", "repro_torch.launch.train", "--smoke", "--device",
              "cpu", "--steps", "3", "--seq", "16", "--batch", "4",
              "--dtype", "float32", "--bucket-mode", "auto_dp",
              "--comm-precision", "auto", "--remat", "auto:0.5",
              "--ckpt-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    plan = r.stdout.splitlines()[0]
    assert plan.startswith("plan: mesh[data=1xmodel=1]")
    # at one rank every candidate costs 0, so the memory plan keeps the
    # per-param partition (the smallest gathered peak), as the reference;
    # it is shown with the precisions it runs at (the reference's
    # describe() omits them)
    assert " remat=auto:0.5 buckets[blocks:11] comm=auto(bf16) " in plan
    assert " mem[remat[" in plan and "budget=0.50GiB" in plan
    losses = [float(l.split()[3]) for l in r.stdout.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_train_launcher_refuses_what_is_not_ported(monkeypatch, tmp_path):
    base = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    for extra, match in ((["--no-reorder", "--pp", "2"], "pipeline"),
                         (["--no-reorder", "--cp", "2"], "context"),
                         (["--no-reorder", "--mesh", "1,2"], "tp=2")):
        with pytest.raises(NotImplementedError, match=match):
            launch_train.main(base + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--no-reorder", "--ckpt-dir",
                           str(tmp_path)])


def test_cpu_training_never_touches_the_kernel_build(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    counts = lambda: (rms_ops.launches, flash_ops.launches,  # noqa: E731
                      xent_ops.fwd_launches, xent_ops.bwd_launches,
                      adamw_ops.launches)
    before = counts()
    trainer, hist = launch_train.main([
        "--smoke", "--no-reorder", "--device", "cpu", "--steps", "1",
        "--seq", "8", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 1 and counts() == before


def test_quantized_prefetch_training_runs_on_cpu_without_the_build(
        monkeypatch, tmp_path):
    """The launcher's default schedule (the prefetch stack) with quantized
    collectives, error feedback and a bf16 reduce-scatter trains on the
    CPU through the plain codec, never reaching the kernel build."""
    from repro_torch.kernels.quant import ops as quant_ops

    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before = (quant_ops.quant_launches, quant_ops.dequant_launches)
    trainer, hist = launch_train.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--seq", "8",
        "--batch", "2", "--dtype", "float32", "--comm-precision", "fp8_ef",
        "--grad-compression", "--ckpt-dir", str(tmp_path)])
    assert trainer.dcfg.reorder and trainer.dcfg.grad_compression
    assert " comm=fp8_ef mem[remat[fsdp_only] " in trainer.plan.describe()
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert (quant_ops.quant_launches, quant_ops.dequant_launches) == before
    assert (tmp_path / "step_00000002" / "ef__blocks__mlp__wg.npy").exists()


def test_train_launcher_obs_flags_write_their_files(tmp_path):
    """--metrics-jsonl, --trace-out, --profile-out and --replan-threshold /
    --replan-patience / --replan-apply on the CPU: a registry line a step,
    the profile JSON, the trace, the drift report and the replan line."""
    out = {k: tmp_path / f"{k}" for k in ("m.jsonl", "p.json", "t.json")}
    r = _run(["-m", "repro_torch.launch.train", "--smoke", "--device",
              "cpu", "--steps", "4", "--seq", "16", "--batch", "4",
              "--dtype", "float32", "--ckpt-dir", str(tmp_path / "ck"),
              "--metrics-jsonl", str(out["m.jsonl"]),
              "--profile-out", str(out["p.json"]),
              "--trace-out", str(out["t.json"]), "--replan-threshold", "0",
              "--replan-patience", "2", "--replan-apply"])
    assert r.returncode == 0, r.stderr
    rows = [json.loads(l) for l in out["m.jsonl"].read_text().splitlines()]
    assert [row["step"] for row in rows] == [1, 2, 3, 4]
    m = rows[-1]["metrics"]
    assert m["train/steps"]["value"] == 4 and m["replan/count"]["value"] >= 1
    prof = json.loads(out["p.json"].read_text())
    assert prof["wall_step_s"] > 0 and set(prof["seg_scales"]) == \
        {"attn", "mlp"}
    doc = json.loads(out["t.json"].read_text())
    assert {e["pid"] for e in doc["traceEvents"]} == {1, 2}   # + overlay
    lines = r.stdout.splitlines()
    assert any(l.startswith("drift report (4 observations)") for l in lines)
    assert any(l.startswith("replan: changed=True applied=True")
               for l in lines)
    assert any(l.startswith(f"profile: {out['p.json']}") for l in lines)
    assert any(l.startswith(f"trace: {out['t.json']}") and "overlay" in l
               for l in lines)


def test_paged_codec_serving_on_cpu_never_touches_the_kernel_build(
        monkeypatch):
    """An int8 / fp8 KV cache on the CPU goes through the plain codec: a
    paged decode step and the scheduler's plan never reach the kernel
    build, and the quant launch counters do not move."""
    from repro_torch.core.serving import dense_to_pages, plan_serve
    from repro_torch.kernels.quant import ops as quant_ops

    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before = (quant_ops.quant_launches, quant_ops.dequant_launches,
              rms_ops.launches)
    cfg, model = get_arch("qwen3_1_7b", smoke=True)
    for codec in ("int8", "fp8"):
        dcfg = DistConfig(param_dtype=torch.float32, kv_cache_codec=codec)
        plan = plan_serve(model, dcfg, arena_bytes=1 << 20, max_batch=2,
                          max_seq=16, page=4)
        assert plan.codec == codec
        params = SV.init_serve_params(model, dcfg, torch.Generator(), "cpu")
        pf = SV.make_prefill_step(model, dcfg,
                                  ShapeConfig("p", 16, 2, "prefill"))
        step = SV.make_paged_step(model, dcfg,
                                  ShapeConfig("d", 16, 2, "decode"), page=4,
                                  n_pages_local=8, max_pages=4)
        tokens = torch.randint(3, cfg.vocab, (2, 16))
        logits, cache = pf(params, {"tokens": tokens})
        arena, table, _ = dense_to_pages(cache, [16, 15], 4, 8, 4)
        logits, arena = step(params, arena, table, logits.argmax(-1)[:, None],
                             torch.tensor([[15], [15]]))
        assert torch.isfinite(logits).all()
    assert (quant_ops.quant_launches, quant_ops.dequant_launches,
            rms_ops.launches) == before
