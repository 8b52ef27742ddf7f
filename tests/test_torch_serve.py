"""Serving parity: the PyTorch port against the JAX reference on CPU.

The reference's own seeded storage goes through its
`serve_params_from_storage`, crosses to the port as numpy arrays through
`serve_params_from_jax`, and both packages prefill the same padded batch and
greedy-decode 4 steps.  Held at the fp32 tolerance of tests/test_kernels.py
(TOL32: rtol 2e-4, atol 2e-5): both sides compute in fp32 and differ only
in summation order.
"""

import dataclasses

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
