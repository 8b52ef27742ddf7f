"""MoE family training parity at pp = 1, tp = 1: the PyTorch port's
`MoELM` against the JAX reference's (`repro.models.moe`) on the CPU, for
qwen3-moe-30b-a3b (top-8 of 128, renormalised, qk-norm; SMOKE: top-2 of 8)
and qwen2-moe-a2.7b (top-4 of 60 padded to 64, a gated shared expert;
SMOKE: top-2 of 6 padded to 8).  Weights are drawn with numpy from a seed;
the training runs take them through the plain-layout checkpoint the
reference writes.  Routing, the FFN and serving are held in
tests/test_torch_moe_serve.py, which shares this file's helpers.

  * the loss and every storage gradient of the loss step on the vanilla
    and the prefetch stack at TOL32 (the router's included), and that the
    aux's gradient reaches the router;
  * 3 chained AdamW steps through the port's `Trainer` from the
    reference's step-0 checkpoint: loss, grad norm, lr, storage and
    moments at TOL32, the aux and the drop count logged apart;
  * storage byte-equal to the reference's `shard_params`; the manual
    bucket units equal the reference's plan;
  * the parameter counts: the port sums the metas (padded experts, q/k
    norms, the shared gate, the final norm), the reference's formula
    does not;
  * the launcher trains qwen2-moe on the CPU; tp > 1 raises.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import api as japi
from repro.core import bucketing as jbk
from repro.core.dist import single_device_config as jax_single_device_config
from repro.core.meta import ParamMeta as JParamMeta
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig, init_opt_state
from repro.train.train_step import default_schedule as jax_default_schedule

from repro_torch.core import api
from repro_torch.core import bucketing as bk
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.models.common import ShapeConfig
from repro_torch.models import runtime as RT
from repro_torch.models.moe import MoELM, capacity, experts_padded
from repro_torch.models.registry import build_model, get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCHS = ("qwen3_moe_30b_a3b", "qwen2_moe_a2_7b")
TOL32 = dict(rtol=2e-4, atol=2e-5)
B, S, STEPS, WARMUP = 4, 16, 3, 1
# drops tokens at B*S = 64 (capacity 16 a padded expert) and puts the aux
# into the loss; the SMOKE configs have capacity_factor 8, coefficient 0
DROPPING = dict(capacity_factor=1.0, router_aux_coef=1e-2)


def _models(arch, **kw):
    """(reference model, port model) of the SMOKE config with `kw`."""
    jcfg, _ = jax_get_arch(arch, smoke=True)
    cfg, _ = get_arch(arch, smoke=True)
    return (jax_build_model(dataclasses.replace(jcfg, **kw)),
            build_model(dataclasses.replace(cfg, **kw)))


def _full_np(jmodel, seed=0):
    """Full params from numpy: norms 1 + 0.1 N, the rest 0.05 N."""
    rng = np.random.default_rng(seed)
    sk = jmodel.stacked_keys

    def one(m, n):
        shape = ((n,) if n else ()) + m.global_shape
        a = rng.standard_normal(shape).astype(np.float32)
        return 1 + 0.1 * a if len(m.global_shape) == 1 else 0.05 * a

    return {k: jax.tree.map(lambda m: one(m, sk.get(k)), v,
                            is_leaf=lambda x: isinstance(x, JParamMeta))
            for k, v in jmodel.metas(jax_single_device_config()).items()}


def _ffn_params_np(jmodel, seed):
    """One layer's FFN params (numpy) from the reference's metas."""
    rng = np.random.default_rng(seed)
    metas = jmodel._ffn_metas(jax_single_device_config(), jnp.float32)
    return {k: (0.3 * rng.standard_normal(m.global_shape)).astype(np.float32)
            for k, m in metas.items()}


def _close(got_tree, want_tree, what):
    got, want = named_leaves(got_tree), named_leaves(want_tree)
    assert [n for n, _ in got] == [n for n, _ in want], what
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32),
                                   err_msg=f"{what} {n}", **TOL32)


def _tokens(rng, n, d, zero_rows=()):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x


# ---------------------------------------------------------------------------
# training: storage, loss step, chained steps
# ---------------------------------------------------------------------------
def _batch(vocab, step=0):
    return SyntheticC4(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=0)).batch(step)


@functools.cache
def _reference(arch):
    """The reference at DROPPING from numpy weights: (checkpoint dir with
    its step-0 storage, loss-step loss and numpy grads, per-step metrics
    and final numpy storage / m / v of STEPS chained AdamW steps)."""
    import tempfile
    jmodel, _ = _models(arch, **DROPPING)
    jd = jax_single_device_config(param_dtype=jnp.float32,
                                  reduce_dtype=jnp.float32, reorder=False)
    metas = jmodel.metas(jd)
    full = _full_np(jmodel)
    storage = {k: japi.shard_params(jax.tree.map(jnp.asarray, full[k]),
                                    metas[k], jd) for k in metas}
    opt = init_opt_state(storage)
    ckpt = tempfile.mkdtemp(prefix=f"moe_ref_{arch}_")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_storage_is_byte_equal_to_reference(arch):
    jmodel, model = _models(arch)
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
    assert {"blocks/mlp/router", "blocks/mlp/we_g", "blocks/mlp/we_d"} \
        <= {n for n, _ in got_l}
    for (n, a), (_, b) in zip(got_l, want_l):
        assert tuple(a.shape) == b.shape and a.numpy().tobytes() == \
            b.tobytes(), n
    # the expert stacks are TP-indexed storage, the router replicated
    m = metas["blocks"]["mlp"]
    assert (m["we_g"].tp_dim, m["router"].tp_dim) == (0, None)
    assert m["we_g"].storage_shape(dcfg)[0] == 1
    # the manual bucket units plan the reference's groups
    bm, jbm = model.block_metas(dcfg), jmodel.block_metas(jd)
    assert bk.manual_plan(bm, model.bucket_units()).groups == \
        jbk.manual_plan(jbm, jmodel.bucket_units()).groups
    assert sum(len(g) for g in bk.manual_plan(
        bm, model.bucket_units()).groups) == len(named_leaves(bm))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reorder", [False, True], ids=["vanilla",
                                                        "prefetch"])
def test_loss_and_grads_match_reference(arch, reorder):
    ref = _reference(arch)
    _, model = _models(arch, **DROPPING)
    dcfg = DistConfig(param_dtype=torch.float32, reorder=reorder)
    par = api.parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                          device="cpu")
    from repro_torch.checkpoint.checkpointer import Checkpointer
    storage, _, _ = Checkpointer(ref["ckpt"]).restore(0, model, dcfg)
    batch = _batch(model.cfg.vocab)
    loss, grads = par.loss_step()(storage, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL32)
    _close(grads, ref["grads"], f"reorder={reorder} grad")

    # the aux's gradient reaches the router: without the aux term the
    # router's gradient changes; the last layer's experts' does not (the
    # aux reaches the layers below through the router's input)
    _, model0 = _models(arch, **dict(DROPPING, router_aux_coef=0.0))
    par0 = api.parallelize(model0, dcfg, ShapeConfig("t", S, B, "train"),
                           device="cpu")
    loss0, grads0 = par0.loss_step()(storage, batch)
    mlp, mlp0 = grads["blocks"]["mlp"], grads0["blocks"]["mlp"]
    assert float(loss - loss0) > 0
    assert float((mlp["router"] - mlp0["router"]).abs().max()) > 1e-6
    assert torch.equal(mlp["we_d"][-1], mlp0["we_d"][-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_chained_steps_from_reference_checkpoint(arch, tmp_path):
    ref = _reference(arch)
    _, model = _models(arch, **DROPPING)
    import shutil
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
        assert 0 < h["moe_aux"] < h["loss"]
        # (token, choice) pairs over capacity, summed over the 2 layers
        assert 0 < h["moe_drops"] < 2 * B * S * model.cfg.n_experts_active
    assert trainer.registry.gauge("train/moe_aux").value == \
        hist[-1]["moe_aux"]
    whole = trainer.par.unshard
    _close(whole(storage), ref["storage"], "storage")
    _close(whole(opt["m"]), ref["m"], "m")
    _close(whole(opt["v"]), ref["v"], "v")


# ---------------------------------------------------------------------------
# sizes, launcher, unported layouts
# ---------------------------------------------------------------------------
def test_full_config_sizes_and_layout():
    """The port counts the metas; the reference's formula counts the real
    experts only (60 of qwen2-moe's 64, and their router columns) and
    leaves out the q/k norms, the shared expert's gate and the final
    norm."""
    counts = {}
    for arch in ARCHS:
        cfg, model = get_arch(arch)
        jcfg, _ = jax_get_arch(arch)
        assert type(model) is MoELM
        assert cfg.n_params() == RT.n_params(model)
        counts[arch] = (cfg.n_params(), jcfg.n_params(),
                        cfg.n_params_active(), jcfg.n_params_active())
    assert counts["qwen3_moe_30b_a3b"] == (30_532_122_624, 30_532_108_288,
                                           3_353_032_704, 3_353_018_368)
    assert counts["qwen2_moe_a2_7b"] == (15_146_305_536, 14_315_585_536,
                                         2_689_222_656, 2_688_974_848)
    q3, _ = get_arch("qwen3_moe_30b_a3b")
    q2, m2 = get_arch("qwen2_moe_a2_7b")
    assert (experts_padded(q3, 1), experts_padded(q2, 1)) == (128, 64)
    mlp = m2.block_metas(DistConfig())["mlp"]
    assert mlp["we_u"].global_shape == (64, 2048, 1408)
    assert mlp["wg"].global_shape == (2048, 5632)
    assert mlp["shared_gate"].global_shape == (2048, 1)
    # the full-width training step's capacity: 640 slots an expert for the
    # 512 an expert routes on average
    assert capacity(q3, 4 * 2048, 128) == 640


def test_train_launcher_trains_moe_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "qwen2_moe_a2_7b", "--smoke", "--device",
                       "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
                       "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("plan: mesh[data=1xmodel=1]")
    steps = [l.split() for l in lines if l.startswith("step ")]
    assert len(steps) == 2 and np.isfinite([float(s[3]) for s in steps]).all()
    # SMOKE's coefficient is 0 and its capacity drops nothing
    assert all(s[-4:] == ["moe_aux", "0", "moe_drops", "0"] for s in steps)
    assert (tmp_path / "step_00000002" / "params__blocks__mlp__we_g.npy") \
        .exists()


def test_tp_above_one_raises_pointedly():
    _, model = get_arch("qwen3_moe_30b_a3b", smoke=True)
    with pytest.raises(NotImplementedError, match="tp=2"):
        api.parallelize(model, DistConfig(mesh_shape=(1, 2)),
                        ShapeConfig("t", S, B, "train"), device="cpu")
    p = {k: torch.from_numpy(v) for k, v in _ffn_params_np(
        _models("qwen3_moe_30b_a3b")[0], 0).items()}
    with pytest.raises(NotImplementedError, match="all_to_all"):
        model._moe_ffn(p, torch.zeros(8, model.cfg.d_model),
                       DistConfig(mesh_shape=(1, 2)))
