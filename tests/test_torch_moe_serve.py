"""MoE family routing, FFN and serving parity at tp = 1: the PyTorch port's
`MoELM` against the JAX reference's (`repro.models.moe`) on the CPU, for
qwen3-moe-30b-a3b and qwen2-moe-a2.7b (the helpers, configs and numpy
weights of tests/test_torch_moe.py, which holds the training parity).

  * `_route`: expert ids EXACTLY equal, weights and the aux at TOL32 (rtol
    2e-4, atol 2e-5), with planted ties: all-zero rows (every real expert
    equally likely) and two equal router columns;
  * the dispatch's pos, keep and slot EXACTLY the reference's formulas on
    the reference's ids (its `_moe_ffn` does not return them);
  * `_moe_ffn` and its gradients at TOL32, at capacity_factor 1.0 (tokens
    ARE dropped) and router_aux_coef 1e-2;
  * prefill and decode logits against the reference's serve steps
    (SMOKE's capacity_factor 8 drops nothing);
  * the launchers serve both MoE archs on the CPU and raise without
    `--device cpu` when there is no card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.dist import single_device_config as jax_single_device_config
from repro.models.common import ShapeConfig as JShapeConfig
from repro.train import serve as JSV

from repro_torch.core.dist import single_device_config
from repro_torch.models.common import ShapeConfig
from repro_torch.models.moe import capacity
from repro_torch.train import serve as SV

from tests.test_torch_moe import (ARCHS, B, DROPPING, S, TOL32, _ffn_params_np,
                                  _full_np, _models, _tokens)

torch.set_num_threads(1)  # small tensors: spare the test workers' cores


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_route_ids_exact_and_ties_rank_by_index(arch):
    jmodel, model = _models(arch, **DROPPING)
    cfg = model.cfg
    rng = np.random.default_rng(1)
    x = _tokens(rng, 64, cfg.d_model, zero_rows=(3, 17))
    router = _ffn_params_np(jmodel, 2)["router"]
    router[:, 4] = router[:, 1]          # experts 1 and 4 always tie
    jw, jids, jaux = jmodel._route(jnp.asarray(x), jnp.asarray(router))
    w, ids, aux = model._route(torch.from_numpy(x), torch.from_numpy(router))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL32)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL32)
    k = cfg.n_experts_active
    # a zero row sees every real expert equally likely: the lowest k win
    for r in (3, 17):
        assert ids[r].tolist() == list(range(k))
    # where the tied pair is chosen, the lower index ranks first
    both = [r for r in range(64) if {1, 4} <= set(ids[r].tolist())]
    assert both and all(ids[r].tolist().index(1) < ids[r].tolist().index(4)
                        for r in both)
    # padded experts are never chosen
    assert int(ids.max()) < cfg.n_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_slots_exact(arch):
    """pos, keep and slot of the reference's `_moe_ffn` (its lines that
    compute them, on its own ids) against the port's `_dispatch`."""
    jmodel, model = _models(arch, **DROPPING)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    T = 64
    x = _tokens(rng, T, cfg.d_model)
    router = _ffn_params_np(jmodel, 4)["router"]
    _, jids, _ = jmodel._route(jnp.asarray(x), jnp.asarray(router))
    ep, k = router.shape[1], cfg.n_experts_active
    C = max(4, int(-(-T * k * cfg.capacity_factor // ep)))
    C = -(-C // 4) * 4
    flat_ids = jids.reshape(-1)
    onehot = jax.nn.one_hot(flat_ids, ep, dtype=jnp.int32)
    jpos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                               flat_ids[:, None], axis=1)[:, 0]
    jkeep = jpos < C
    jslot = jnp.where(jkeep, flat_ids * C + jpos, ep * C)

    assert capacity(cfg, T, ep) == C == 16
    pos, keep, slot = model._dispatch(torch.from_numpy(np.array(jids))
                                      .long(), C, ep)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert not bool(keep.all())              # tokens are dropped here


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_and_gradients_match_reference(arch):
    jmodel, model = _models(arch, **DROPPING)
    cfg = model.cfg
    jd, d = jax_single_device_config(), single_device_config()
    rng = np.random.default_rng(5)
    x = _tokens(rng, B * S, cfg.d_model).reshape(B, S, cfg.d_model)
    p = _ffn_params_np(jmodel, 6)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(xx, pp):
        def one(x1):     # vmap binds the TP axis name the shared MLP uses
            out, aux = jmodel._ffn_apply(pp, x1, jd)
            return out, aux["moe_aux"]
        out, aux = jax.vmap(one, axis_name=jd.tp_axis)(xx[None])
        return jnp.sum(out[0] * ct) + aux[0], (out[0], aux[0])

    (jl, (jout, jaux)), (jdx, jdp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))

    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out, aux = model._ffn_apply(pt, xt, d)
    loss = (out * torch.from_numpy(ct)).sum() + aux["moe_aux"]
    grads = torch.autograd.grad(loss, [xt, *pt.values()])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL32)
    drops = float(aux["moe_drops"])
    aux = float(aux["moe_aux"].detach())
    np.testing.assert_allclose(aux, float(jaux), **TOL32)
    assert aux > 0 and drops > 0
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), **TOL32)
    for (name, _), g in zip(pt.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jdp[name]),
                                   err_msg=name, **TOL32)
    assert float(grads[1 + list(pt).index("router")].abs().max()) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jmodel, model = _models(arch)
    prompt, gen = 12, 3
    T = prompt + gen
    jd = jax_single_device_config(param_dtype=jnp.float32,
                                  reduce_dtype=jnp.float32)
    metas = jmodel.metas(jd)
    full = _full_np(jmodel, seed=9)
    storage = {k: japi.shard_params(jax.tree.map(jnp.asarray, full[k]),
                                    metas[k], jd) for k in metas}
    jparams = JSV.serve_params_from_storage(jmodel, storage, jd)
    jpf, mesh = JSV.make_prefill_step(jmodel, jd,
                                      JShapeConfig("p", T, B, "prefill"))
    jdec, _ = JSV.make_decode_step(jmodel, jd,
                                   JShapeConfig("d", T, B, "decode"),
                                   mesh=mesh)
    rng = np.random.default_rng(0)
    tokens = np.pad(rng.integers(3, model.cfg.vocab, (B, prompt)),
                    ((0, 0), (0, gen)), constant_values=3)
    jlogits, jcache = jpf(jparams, {"tokens": jnp.asarray(tokens,
                                                          jnp.int32)})

    dcfg = single_device_config(param_dtype=torch.float32)
    params = SV.serve_params_from_jax(jax.tree.map(np.asarray, jparams),
                                      model, dcfg, device="cpu")
    pf = SV.make_prefill_step(model, dcfg, ShapeConfig("p", T, B, "prefill"))
    dec = SV.make_decode_step(model, dcfg, ShapeConfig("d", T, B, "decode"))
    logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL32)
    for i in range(gen):
        tok = logits.argmax(-1)
        assert np.array_equal(tok.numpy(), np.asarray(jlogits).argmax(-1))
        pos = torch.full((B,), prompt + i, dtype=torch.int64)
        logits, cache = dec(params, cache, tok, pos)
        jlogits, jcache = jdec(jparams, jcache,
                               jnp.asarray(tok.numpy(), jnp.int32),
                               jnp.asarray(pos.numpy(), jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"decode {i}", **TOL32)
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_moe_on_cpu_and_raise_without_cuda(arch, tmp_path,
                                                         capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert "generated:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--arch", arch, "--smoke"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--arch", arch, "--smoke", "--steps", "1",
                               "--ckpt-dir", str(tmp_path)])
