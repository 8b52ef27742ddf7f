"""gemma2 parity at pp = 1, tp = 1: the PyTorch port's `DenseLM` on
gemma2-27b's SMOKE config (one local/global pair, window 8, softcaps 50 /
30, GeGLU, sandwich norms with unit offset, tied embeddings, the sqrt(d)
embedding scale, query_pre_attn scaling) against the JAX reference's on
the CPU.  Weights are drawn with numpy from a seed; the training runs take
them through the plain-layout checkpoint the reference writes.

  * `mlp_apply` and its gradients for geglu and gelu (the tanh GELU, and
    gelu's missing gate matrix) at TOL32 (rtol 2e-4, atol 2e-5);
  * `embed_apply`'s scale rounded to param_dtype before it multiplies, bit
    for bit, at d 4608 (sqrt(4608) = 67.88 is 68.0 in bf16);
  * `_q_scale` (1/16 for gemma2, 1/sqrt(hd) elsewhere);
  * storage byte-equal to the reference's `shard_params`;
  * the loss and every storage gradient of the loss step at TOL32 on the
    vanilla stack (whole pairs, and a per-segment remat vector over the
    four pair segments) and the prefetch stack under block and auto_dp
    buckets, against the reference's `loss_local`;
  * 3 chained AdamW steps through the port's `Trainer` from the
    reference's step-0 checkpoint;
  * prefill and decode across the window (a 12-token prompt), logits and
    both caches, against `prefill_local` / `decode_local`;
  * at the full config, host math only: the parameter count and the head
    layout (the plans, exposures and memory plans of every ported arch,
    gemma2 included, are held in test_torch_planners.py,
    test_torch_memory_plan.py and test_torch_obs.py);
  * the launchers train and serve gemma2 on the CPU.
"""

import dataclasses
import functools
import math
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import api as japi
from repro.core.dist import single_device_config as jax_single_device_config
from repro.core.meta import ParamMeta as JParamMeta
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.models import layers as JLY
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig, init_opt_state
from repro.train import serve as JSV
from repro.train.train_step import default_schedule as jax_default_schedule

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import api
from repro_torch.core.dist import DistConfig, single_device_config
from repro_torch.core.meta import named_leaves
from repro_torch.models import layers as LY
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.dense import DenseLM
from repro_torch.models.registry import build_model, get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import serve as SV
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "gemma2_27b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
B, S, STEPS, WARMUP = 4, 16, 3, 1
# the four pair segments under four policies: the segmented vanilla layer
# carries the (x, aux) state between them
VECTOR = ("local.attn=full,local.mlp=none,global.attn=fsdp_only,"
          "global.mlp=save_dots")


def _models(**kw):
    """(reference model, port model) of the SMOKE config with `kw`."""
    jcfg, _ = jax_get_arch(ARCH, smoke=True)
    cfg, _ = get_arch(ARCH, smoke=True)
    from repro.models.registry import build_model as jax_build_model
    return (jax_build_model(dataclasses.replace(jcfg, **kw)),
            build_model(dataclasses.replace(cfg, **kw)))


def _full_np(jmodel, seed=0):
    """Full params from numpy: the unit-offset norms 0.1 N (scales near
    1), the rest 0.05 N."""
    rng = np.random.default_rng(seed)
    sk = jmodel.stacked_keys

    def one(m, n):
        shape = ((n,) if n else ()) + m.global_shape
        a = rng.standard_normal(shape).astype(np.float32)
        return 0.1 * a if len(m.global_shape) == 1 else 0.05 * a

    return {k: jax.tree.map(lambda m: one(m, sk.get(k)), v,
                            is_leaf=lambda x: isinstance(x, JParamMeta))
            for k, v in jmodel.metas(jax_single_device_config()).items()}


def _close(got_tree, want_tree, what):
    got, want = named_leaves(got_tree), named_leaves(want_tree)
    assert [n for n, _ in got] == [n for n, _ in want], what
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32),
                                   err_msg=f"{what} {n}", **TOL32)


def _tp_vmap(fn, dcfg):
    """fn of one rank, run under a one-rank vmap that binds the TP axis
    name the reference's layers gather and scatter over."""
    return lambda *a: jax.tree.map(lambda t: t[0], jax.vmap(
        fn, axis_name=dcfg.tp_axis)(*(jax.tree.map(lambda t: t[None], x)
                                      for x in a)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["geglu", "gelu"])
def test_mlp_variants_and_gradients_match_reference(variant):
    cfg, _ = get_arch(ARCH, smoke=True)
    cfg = dataclasses.replace(cfg, gated_mlp=variant)
    jcfg = dataclasses.replace(jax_get_arch(ARCH, smoke=True)[0],
                               gated_mlp=variant)
    jd, d = jax_single_device_config(), single_device_config()
    metas = LY.mlp_metas(cfg, d, torch.float32)
    assert ("wg" in metas) == (variant == "geglu")
    rng = np.random.default_rng(3)
    # unit-variance products: fan-in scaled weights
    p = {k: (rng.standard_normal(m.global_shape)
             / math.sqrt(m.global_shape[0])).astype(np.float32)
         for k, m in metas.items()}
    # inputs large enough that the tanh GELU and torch's default erf GELU
    # part by more than the tolerance
    x = (2 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(xx, pp):
        out = _tp_vmap(lambda a, b: JLY.mlp_apply(b, a, jcfg, jd), jd)(xx,
                                                                       pp)
        return jnp.sum(out * ct), out

    (_, jout), (jdx, jdp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out = LY.mlp_apply(pt, xt, cfg, d)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [xt, *pt.values()])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL32)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), **TOL32)
    for (name, _), g in zip(pt.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jdp[name]),
                                   err_msg=name, **TOL32)
    # the erf GELU is not the reference's
    h = torch.from_numpy(x) @ pt["wu" if variant == "gelu" else "wg"]
    assert (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(
        h, approximate="tanh")).abs().max() > 10 * TOL32["atol"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_embedding_scale_rounds_to_param_dtype(dtype):
    """At d 4608 (gemma2-27b's width), whose sqrt is no bf16 value: the
    port's scaled lookup equals the reference's bit for bit."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    cfg, _ = get_arch(ARCH, smoke=True)
    cfg = dataclasses.replace(cfg, d_model=4608, vocab=12)
    jcfg = dataclasses.replace(jax_get_arch(ARCH, smoke=True)[0],
                               d_model=4608, vocab=12)
    jd = jax_single_device_config(param_dtype=jdt)
    d = single_device_config(param_dtype=dtype)
    rng = np.random.default_rng(4)
    table = rng.standard_normal((12, 4608)).astype(np.float32)
    ids = np.array([[0, 5, 11, 12], [3, -1, 7, 7]])   # 12, -1 embed to 0
    scale = math.sqrt(4608)
    want = _tp_vmap(lambda t, i: JLY.embed_apply(t, i, jcfg, jd,
                                                 scale=scale), jd)(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32))
    got = LY.embed_apply(torch.from_numpy(table), torch.from_numpy(ids),
                         cfg, d, scale=scale)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    rounded = torch.tensor(scale, dtype=dtype).item()
    assert (rounded == 68.0) == (dtype == torch.bfloat16)
    assert torch.equal(got[0, 1], torch.from_numpy(table[5]).to(dtype)
                       * rounded)
    assert not got[1, 1].any() and not got[0, 3].any()


def test_q_scale_is_query_pre_attn_scalar_for_gemma2_only():
    for arch, want in ((ARCH, 1 / 16), ("llama3_8b", 1 / math.sqrt(128))):
        _, jmodel = jax_get_arch(arch)
        _, model = get_arch(arch)
        assert model._q_scale == jmodel._q_scale == pytest.approx(want)
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    # SMOKE's hd 16 would give 1/4: gemma2 scales by 256 ** -0.5 at any hd
    assert model._q_scale == jmodel._q_scale == 1 / 16


# ---------------------------------------------------------------------------
# training: storage, loss step, chained steps
# ---------------------------------------------------------------------------
def _batch(vocab, step=0):
    return SyntheticC4(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=0)).batch(step)


@functools.cache
def _reference():
    """The reference from numpy weights: (checkpoint dir with its step-0
    storage, loss-step loss and numpy grads, per-step metrics and final
    numpy storage / m / v of STEPS chained AdamW steps)."""
    jmodel, _ = _models()
    jd = jax_single_device_config(param_dtype=jnp.float32,
                                  reduce_dtype=jnp.float32, reorder=False)
    metas = jmodel.metas(jd)
    full = _full_np(jmodel)
    storage = {k: japi.shard_params(jax.tree.map(jnp.asarray, full[k]),
                                    metas[k], jd) for k in metas}
    opt = init_opt_state(storage)
    ckpt = tempfile.mkdtemp(prefix="gemma2_ref_")
    JCheckpointer(ckpt).save(0, storage, opt, jmodel, jd)
    par = japi.parallelize(jmodel, jd, JShapeConfig("t", S, B, "train"))
    loss, grads = par.loss_step()(storage, {
        k: jnp.asarray(v) for k, v in _batch(jmodel.cfg.vocab).items()})
    ocfg = JAdamWConfig()
    step_fn = par.train_step(ocfg, jax_default_schedule(ocfg, STEPS, WARMUP),
                             donate=False)
    hist = []
    for step in range(STEPS):
        storage, opt, m = step_fn(storage, opt, {
            k: jnp.asarray(v)
            for k, v in _batch(jmodel.cfg.vocab, step).items()})
        hist.append(jax.tree.map(float, m))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return dict(ckpt=ckpt, full=full, loss=float(loss), grads=to_np(grads),
                hist=hist, storage=to_np(storage), m=to_np(opt["m"]),
                v=to_np(opt["v"]))


def test_storage_is_byte_equal_to_reference():
    jmodel, model = _models()
    assert type(model) is DenseLM and model.layers_per_step == 2
    assert model.n_steps == jmodel.n_steps == 1
    jd = jax_single_device_config(reorder=False)
    jmetas = jmodel.metas(jd)
    full = _full_np(jmodel, seed=7)
    want = {k: japi.shard_params(jax.tree.map(jnp.asarray, full[k]),
                                 jmetas[k], jd) for k in full}
    dcfg = DistConfig(reorder=False)
    metas = model.metas(dcfg)
    got = {k: api.shard_params(jax.tree.map(torch.from_numpy, full[k]),
                               metas[k], dcfg) for k in full}
    got_l, want_l = named_leaves(got), named_leaves(
        jax.tree.map(np.asarray, want))
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    names = {n for n, _ in got_l}
    assert {"blocks/local/pn1", "blocks/global/pn2", "blocks/local/mlp/wg",
            "final_norm"} <= names and "head" not in full
    for (n, a), (_, b) in zip(got_l, want_l):
        assert tuple(a.shape) == b.shape and a.numpy().tobytes() == \
            b.tobytes(), n
    # the segments own the reference's params, in the reference's order
    segs, jsegs = model.block_segments(dcfg), jmodel.block_segments(jd)
    assert segs.names == jsegs.names == ("local.attn", "local.mlp",
                                         "global.attn", "global.mlp")
    assert segs.param_globs == jsegs.param_globs


def test_init_starts_unit_offset_norms_at_zero():
    _, model = get_arch(ARCH, smoke=True)
    d = DistConfig(param_dtype=torch.float32)
    p = model.init_full(torch.Generator().manual_seed(0), d, "cpu",
                        torch.float32)
    for k in ("ln1", "ln2", "pn1", "pn2"):
        for half in ("local", "global"):
            assert not p["blocks"][half][k].any(), (half, k)
    assert not p["final_norm"].any()
    assert "wg" in p["blocks"]["local"]["mlp"]


@pytest.mark.parametrize("case,kw", [
    ("vanilla", dict(reorder=False)),
    ("vanilla_vector", dict(reorder=False, remat=VECTOR)),
    ("prefetch_block", dict(reorder=True)),
    ("prefetch_auto_dp", dict(reorder=True, bucket_mode="auto_dp")),
])
def test_loss_and_grads_match_reference(case, kw):
    ref = _reference()
    _, model = _models()
    dcfg = DistConfig(param_dtype=torch.float32, **kw)
    par = api.parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                          device="cpu")
    storage, _, _ = Checkpointer(ref["ckpt"]).restore(0, model, dcfg)
    loss, grads = par.loss_step()(storage, _batch(model.cfg.vocab))
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL32)
    _close(grads, ref["grads"], f"{case} grad")
    # every leaf gets a gradient, the post norms' included
    assert all(float(g.abs().max()) > 0 for _, g in named_leaves(grads))


def test_chained_steps_from_reference_checkpoint(tmp_path):
    ref = _reference()
    _, model = _models()
    shutil.copytree(ref["ckpt"], tmp_path / "ckpt")
    trainer = Trainer(model, DistConfig(param_dtype=torch.float32),
                      ShapeConfig("t", S, B, "train"), AdamWConfig(),
                      TrainerConfig(total_steps=STEPS, log_every=1,
                                    warmup=WARMUP,
                                    ckpt_dir=str(tmp_path / "ckpt")),
                      device="cpu")
    storage, opt, hist = trainer.run()
    assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
    for h, want in zip(hist, ref["hist"]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[k], want[k], err_msg=k, **TOL32)
    whole = trainer.par.unshard
    _close(whole(storage), ref["storage"], "storage")
    _close(whole(opt["m"]), ref["m"], "m")
    _close(whole(opt["v"]), ref["v"], "v")


# ---------------------------------------------------------------------------
# serving across the window
# ---------------------------------------------------------------------------
def test_prefill_and_decode_across_the_window_match_reference():
    jmodel, model = _models()
    window = model.cfg.sliding_window
    prompt, gen = 12, 3
    assert prompt > window
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
    # one (k, v) pair a layer of the pair: local, then global
    assert len(cache) == len(jcache) == 2
    assert all(len(c) == 2 and c[0].shape == (1, B, T, 2, 16)
               for c in cache)
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
    for (got, want), what in zip(zip(jax.tree.leaves(cache),
                                     jax.tree.leaves(jcache)),
                                 ("local k", "local v", "global k",
                                  "global v")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **TOL32)

    # the window is engaged: without it the last decode step reads other
    # logits from the same cache
    _, model_nw = _models(sliding_window=None)
    dec_nw = SV.make_decode_step(model_nw, dcfg,
                                 ShapeConfig("d", T, B, "decode"))
    pos = torch.full((B,), T - 1, dtype=torch.int64)
    tok = logits.argmax(-1)
    a, _ = dec(params, [tuple(t.clone() for t in c) for c in cache], tok,
               pos)
    b, _ = dec_nw(params, [tuple(t.clone() for t in c) for c in cache],
                  tok, pos)
    assert float((a - b).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the full config (host math), the launchers
# ---------------------------------------------------------------------------
def test_full_config_sizes_and_layout():
    """The port sums the metas; the reference's formula counts two norms a
    layer and no final norm, so it leaves out gemma2's post norms (2 x 46
    x 4608) and the final norm (4608)."""
    cfg, model = get_arch(ARCH)
    jcfg, jmodel = jax_get_arch(ARCH)
    assert type(model) is DenseLM and model.layers_per_step == 2
    assert model.n_steps == jmodel.n_steps == 23
    assert cfg.n_params() == RT.n_params(model) == 27_227_128_320
    assert jcfg.n_params() == 27_226_699_776
    assert cfg.n_params() - jcfg.n_params() == (2 * 46 + 1) * 4608
    assert cfg.gqa_layout(1) == dict(mode="sharded", hq=32, kvp=16, g=2,
                                     g_real=2)
    d, jd = DistConfig(), jax_single_device_config()
    got = [(n, m.global_shape) for n, m in named_leaves(model.metas(d))]
    want = [(n, m.global_shape) for n, m in
            jax.tree_util.tree_flatten_with_path(
                jmodel.metas(jd),
                is_leaf=lambda x: isinstance(x, JParamMeta))[0]
            for n in [jax.tree_util.keystr(n, simple=True, separator="/")]]
    assert got == want
    # one pair, as the card trains it: 2,312,151,552 parameters
    pair = build_model(dataclasses.replace(cfg, n_layers=2))
    assert RT.n_params(pair) == 2_312_151_552


def test_launchers_train_and_serve_gemma2_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq", "16", "--batch", "2",
                       "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    steps = [l.split() for l in out.splitlines() if l.startswith("step ")]
    assert len(steps) == 2 and np.isfinite([float(s[3]) for s in steps]).all()
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    assert "generated:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--arch", ARCH, "--smoke"])
