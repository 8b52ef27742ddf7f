"""Serving parity: the PyTorch port against the JAX reference on CPU.

The reference's own seeded storage goes through its
`serve_params_from_storage`, crosses to the port as numpy arrays through
`serve_params_from_jax`, and both packages prefill the same padded batch and
greedy-decode 4 steps.  Held at the fp32 tolerance of tests/test_kernels.py
(TOL32: rtol 2e-4, atol 2e-5): both sides compute in fp32 and differ only
in summation order.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import single_device_config as jax_single_device_config
from repro.models import runtime as RT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import build_model, get_arch as jax_get_arch
from repro.train import serve as SV

from repro_torch.core.dist import single_device_config
from repro_torch.models.common import ShapeConfig
from repro_torch.models.dense import DenseLM
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as TSV

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
B, PROMPT, GEN = 2, 12, 4
T = PROMPT + GEN
# The attention flags the port's dense model threads through to the
# kernels (no ported config sets them yet).
VARIANT = dict(attn_softcap=50.0, final_softcap=30.0, sliding_window=8)


def _configs(arch, variant):
    jcfg, _ = jax_get_arch(arch, smoke=True)
    tcfg, _ = get_arch(arch, smoke=True)
    if variant:
        jcfg = dataclasses.replace(jcfg, **VARIANT)
        tcfg = dataclasses.replace(tcfg, **VARIANT)
    return build_model(jcfg), DenseLM(tcfg)


def _reference(jmodel, tokens):
    dcfg = jax_single_device_config(param_dtype=jnp.float32,
                                    reduce_dtype=jnp.float32)
    storage = RT.init_storage(jmodel, jax.random.PRNGKey(0), dcfg)
    params = SV.serve_params_from_storage(jmodel, storage, dcfg)
    pf, mesh = SV.make_prefill_step(jmodel, dcfg,
                                    JShapeConfig("p", T, B, "prefill"))
    dec, _ = SV.make_decode_step(jmodel, dcfg,
                                 JShapeConfig("d", T, B, "decode"), mesh=mesh)
    logits, cache = pf(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    return jax.tree.map(np.asarray, params), dec, params, logits, cache


@pytest.mark.parametrize("arch,variant", [
    ("llama3_8b", False), ("qwen3_1_7b", False), ("llama3_8b", True)])
def test_prefill_and_decode_match_reference(arch, variant):
    jmodel, tmodel = _configs(arch, variant)
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, jmodel.cfg.vocab, (B, PROMPT))
    tokens = np.pad(prompts, ((0, 0), (0, GEN)), constant_values=3)
    np_params, jdec, jparams, jlogits, jcache = _reference(jmodel, tokens)

    dcfg = single_device_config(param_dtype=torch.float32)
    params = TSV.serve_params_from_jax(np_params, tmodel, dcfg, device="cpu")
    pf = TSV.make_prefill_step(tmodel, dcfg, ShapeConfig("p", T, B, "prefill"))
    dec = TSV.make_decode_step(tmodel, dcfg, ShapeConfig("d", T, B, "decode"))
    logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)})

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL32)
    assert len(cache) == len(jcache) == 2
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)

    tok = logits.argmax(-1)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for i in range(GEN):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        pos = torch.full((B,), PROMPT + i, dtype=torch.int64)
        logits, cache = dec(params, cache, tok, pos)
        jlogits, jcache = jdec(jparams, jcache, jtok,
                               jnp.asarray(pos.numpy(), jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL32)
        tok = logits.argmax(-1)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_carry_over_rejects_a_layout_that_does_not_line_up():
    _, model = get_arch("llama3_8b", smoke=True)
    dcfg = single_device_config(param_dtype=torch.float32)
    params = TSV.init_serve_params(model, dcfg, torch.Generator(), "cpu")
    tree = jax.tree.map(lambda t: t.numpy(), params)
    tree["blocks"]["attn"]["wk"] = np.swapaxes(
        tree["blocks"]["attn"]["wk"], 1, 2)      # (d, kvp*hd): untransposed
    with pytest.raises(ValueError, match="attn.wk"):
        TSV.serve_params_from_jax(tree, model, dcfg, device="cpu")
    del tree["head"]
    with pytest.raises(ValueError, match="expected keys"):
        TSV.serve_params_from_jax(tree, model, dcfg, device="cpu")


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_1_7b"])
def test_init_serve_params_follows_the_reference_distributions(arch):
    _, model = get_arch(arch, smoke=True)
    dcfg = single_device_config(param_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    params = TSV.init_serve_params(model, dcfg, g, "cpu")
    metas = model.metas(dcfg)
    cfg = model.cfg
    # same tree, stacked shapes and dtype as the metas
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
    for k, m in metas.items():
        n = model.stacked_keys.get(k)
        want = jax.tree.map(
            lambda mm: ((n, *mm.global_shape) if n else mm.global_shape,
                        torch.bfloat16), m,
            is_leaf=lambda x: hasattr(x, "global_shape"))
        assert shapes[k] == want
    assert torch.all(params["final_norm"] == 1)
    assert torch.all(params["blocks"]["ln1"] == 1)
    std = lambda t: t.float().std().item()
    assert abs(std(params["embed"]) - 0.02) < 2e-3
    assert abs(std(params["blocks"]["attn"]["wq"]) - 0.02) < 2e-3
    scaled = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(std(params["blocks"]["mlp"]["wd"]) - scaled) < 0.1 * scaled
    if not cfg.tie_embeddings:
        assert abs(std(params["head"]) - scaled) < 0.1 * scaled


def test_launcher_int8_kv_and_metrics_jsonl_match_reference(tmp_path, capsys,
                                                           monkeypatch):
    """`--int8-kv` and `--metrics-jsonl` on the CPU: the port's launcher
    serves with the int8 cache and writes one registry line whose keys,
    `serve/*` gauges and their kinds are the reference launcher's.  Both
    run in this process, the reference's on its one CPU device (it reads
    sys.argv and prepends its device count to XLA_FLAGS, restored after)."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as launch
    mine, ref = tmp_path / "mine.jsonl", tmp_path / "ref.jsonl"
    common = ["--smoke", "--gen", "3", "--int8-kv"]
    launch.main([*common, "--device", "cpu", "--metrics-jsonl", str(mine)])
    out = capsys.readouterr().out
    assert "int8_kv=True" in out and f"metrics: {mine}" in out
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(sys, "argv", ["serve", *common, "--devices", "1",
                                      "--mesh", "1,1", "--metrics-jsonl",
                                      str(ref)])
    jlaunch.main()
    assert f"metrics: {ref}" in capsys.readouterr().out
    rows = [json.loads(p.read_text()) for p in (mine, ref)]
    assert all(len(p.read_text().splitlines()) == 1 for p in (mine, ref))
    got, want = rows
    assert set(got) == set(want)
    assert {k: got[k] for k in ("arch", "batch", "gen", "step")} == \
        {k: want[k] for k in ("arch", "batch", "gen", "step")}
    kinds = lambda row: {k: v["kind"] for k, v in row["metrics"].items()}
    assert kinds(got) == kinds(want)
    assert set(kinds(got)) == {"serve/prefill_compile_s",
                               "serve/decode_compile_s", "serve/prefill_s",
                               "serve/decode_step_s", "serve/decode_tok_s"}
    assert all(v["value"] > 0 for v in got["metrics"].values())


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_codec_prefill_and_decode_match_reference(codec):
    """The dense serving path under a KV codec: prefill logits, the
    dequantized cache and 4 decode steps against the reference, both fed
    the reference's greedy tokens.  Both quantize K/V that agree to fp32
    rounding, so a code may sit one step apart: logits held to 1e-3
    (the paged parity tests' TOL_CODEC_LOGITS), dequantized caches to one
    code step."""
    from repro_torch.core.serving import pages as PG
    tol = dict(rtol=1e-3, atol=1e-3)
    jmodel, tmodel = _configs("qwen3_1_7b", False)
    rng = np.random.default_rng(0)
    tokens = np.pad(rng.integers(3, jmodel.cfg.vocab, (B, PROMPT)),
                    ((0, 0), (0, GEN)), constant_values=3)
    jd = jax_single_device_config(param_dtype=jnp.float32,
                                  reduce_dtype=jnp.float32,
                                  kv_cache_codec=codec)
    storage = RT.init_storage(jmodel, jax.random.PRNGKey(0), jd)
    jparams = SV.serve_params_from_storage(jmodel, storage, jd)
    jpf, mesh = SV.make_prefill_step(jmodel, jd,
                                     JShapeConfig("p", T, B, "prefill"))
    jdec, _ = SV.make_decode_step(jmodel, jd,
                                  JShapeConfig("d", T, B, "decode"),
                                  mesh=mesh)
    jlogits, jcache = jpf(jparams, {"tokens": jnp.asarray(tokens,
                                                          jnp.int32)})
    dcfg = single_device_config(param_dtype=torch.float32,
                                kv_cache_codec=codec)
    params = TSV.serve_params_from_jax(jax.tree.map(np.asarray, jparams),
                                       tmodel, dcfg, device="cpu")
    pf = TSV.make_prefill_step(tmodel, dcfg, ShapeConfig("p", T, B,
                                                         "prefill"))
    dec = TSV.make_decode_step(tmodel, dcfg, ShapeConfig("d", T, B,
                                                         "decode"))
    logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)})
    assert sorted(cache) == ["k", "ks", "v", "vs"]
    assert cache["k"].dtype == QCODEC_DTYPES[codec]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)

    def check_cache():
        for n in ("k", "v"):
            step = torch.repeat_interleave(cache[n + "s"], 128, -1)[
                ..., :cache[n].shape[-1]]
            got = cache[n].float() * step
            q = np.asarray(jcache[n]).astype(np.float32)
            want = torch.from_numpy(q) * torch.repeat_interleave(
                torch.from_numpy(np.array(jcache[n + "s"])), 128,
                -1)[..., :q.shape[-1]]
            assert bool(((got - want).abs() <= step * (1 + 1e-6)
                         + 2e-5).all()), n

    check_cache()
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for i in range(GEN):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int64)
        logits, cache = dec(params, cache,
                            torch.from_numpy(np.array(jtok)).long(), pos)
        jlogits, jcache = jdec(jparams, jcache, jtok,
                               jnp.asarray(pos.numpy(), jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **tol, err_msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    check_cache()
    assert PG.kv_leaves(cache)[0].shape == (tmodel.n_steps, B, T,
                                            tmodel.cfg.n_kv_heads,
                                            tmodel.cfg.head_dim)


QCODEC_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
