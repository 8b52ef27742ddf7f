"""vlm training parity at pp = 1: the PyTorch port against the JAX
reference on the CPU, on internvl2-26b's SMOKE config (2 layers, d 64, 4 q
heads on 2 kv heads of 16, d_ff 128, vocab 256, vit_dim 48, 8 image
tokens), at seq 40 (8 image positions + 32 text tokens), B 2.

  * the metas (names, shapes, tp_dim), block_stats, input_specs; the full
    config's size (19,918,755,840 parameters, the sum of the metas; the
    reference's `n_params` says 19,861,340,160: it leaves out proj_w1,
    proj_w2 and the final norm);
  * storage: the port's `shard_params` byte-equal to the reference's from
    the same full params; the reference's own `init_full` (projector
    included) carried over byte for byte as storage and as serve params;
    `Trainer`'s batches equal to the reference's `adapt_batch`, bit for
    bit;
  * loss and every storage gradient (proj_w1 and proj_w2 included, which
    get theirs through the image positions only) against the reference's
    `parallelize(...).loss_step()`, on the vanilla and the prefetch stack,
    fp32 at TOL32 (rtol 2e-4, atol 2e-5) under remat fsdp_only and full,
    bf16 at TOL (2e-2); the image positions leave the loss;
  * the prefetch stack under every Table-6 flag combination gives the
    vanilla stack's loss and gradients, bit for bit;
  * collectives per loss step;
  * 3 chained AdamW steps through the port's `Trainer` at TOL32, the
    reference's checkpoint after step 2 resumed by the port, and the
    port's own checkpoint of step 3 restored bit for bit;
  * the launcher trains the vlm on the CPU end to end;
  * the parts not ported yet raise.

The planners' plans and exposures and the memory plan of the vlm are held
against the reference's by the PORTED sweeps of tests/test_torch_planners.py,
tests/test_torch_obs.py and tests/test_torch_memory_plan.py.  Weights come
from a numpy seed at the reference init's scales, in the reference's
storage layout; the batch is SyntheticC4's fitted to `input_specs` by
`adapt_batch` (image embeddings synthesised, the token fields cropped to
the 32 text positions).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import api as japi
from repro.core.dist import single_device_config as jax_single_device_config
from repro.core.meta import named_leaves as jnamed_leaves
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticC4 as JSyntheticC4
from repro.data.pipeline import adapt_batch as jadapt_batch
from repro.models import runtime as JRT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig, init_opt_state
from repro.train import serve as JSV
from repro.train.train_step import default_schedule as jax_default_schedule

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import api
from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig, single_device_config
from repro_torch.core.meta import named_leaves
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.cross_entropy import ops as xent_ops
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.models.vlm import VLM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import serve as SV
from repro_torch.train.train_step import init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "internvl2_26b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, S, STEPS, WARMUP = 2, 40, 3, 1
N_IMG = 8
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
OUTSIDE = ("embed", "final_norm", "head", "proj_w1", "proj_w2")


def _batch(step=0):
    """SyntheticC4's batch at seq S fitted to the SMOKE train spec: image
    embeddings (B, 8, 48) synthesised from (seed, step), tokens cropped to
    the 32 text positions."""
    cfg, model = get_arch(ARCH, smoke=True)
    from repro_torch.data.pipeline import DataConfig, SyntheticC4, \
        adapt_batch
    base = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=0)).batch(step)
    return adapt_batch(base, model.input_specs(
        ShapeConfig("t", S, B, "train"), DistConfig()), step)


def _numpy_full(jmodel, dcfg, seed=0):
    """Full params in the reference's layout (blocks stacked) from a numpy
    seed, at its init's scales: N(0, 1) x 0.02 (the projector too), wo /
    wd / head x 0.02 / sqrt(2 L), norms 1 + 0.1 N(0, 1)."""
    cfg = jmodel.cfg
    rng = np.random.default_rng(seed)
    deep = 0.02 / np.sqrt(2 * cfg.n_layers)

    def tree(metas, n):
        if not hasattr(metas, "global_shape"):
            return {k: tree(v, n) for k, v in metas.items()}
        shape = (n, *metas.global_shape) if n else tuple(metas.global_shape)
        a = rng.standard_normal(shape)
        key = metas.name.split(".")[-1]
        a = 1 + 0.1 * a if len(metas.global_shape) == 1 else \
            (deep if key in ("wo", "wd", "head") else 0.02) * a
        return jnp.asarray(a.astype(np.float32))

    sk = jmodel.stacked_keys
    return {k: tree(v, sk.get(k)) for k, v in jmodel.metas(dcfg).items()}


@functools.cache
def _reference(dtype=torch.float32):
    """(numpy storage, batch, loss, numpy grads) of the JAX loss step."""
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=JAX_DTYPES[dtype],
                                    reduce_dtype=jnp.float32, reorder=False)
    full = _numpy_full(jmodel, dcfg)
    metas = jmodel.metas(dcfg)
    storage = {k: japi.shard_params(full[k], metas[k], dcfg) for k in full}
    batch = _batch()
    par = japi.parallelize(jmodel, dcfg, JShapeConfig("t", S, B, "train"))
    loss, grads = par.loss_step()(storage, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(storage), batch, float(loss), to_np(grads)


def _port(**kw):
    _, model = get_arch(ARCH, smoke=True)
    dcfg = DistConfig(param_dtype=kw.pop("dtype", torch.float32), **kw)
    par = api.parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                          device="cpu")
    return model, dcfg, par


def _close(got_tree, want_tree, what, tol=TOL32):
    got, want = named_leaves(got_tree), named_leaves(want_tree)
    assert [n for n, _ in got] == [n for n, _ in want], what
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().cpu().float().numpy(),
                                   np.asarray(b, np.float32),
                                   err_msg=f"{what} {n}", **tol)


# ---------------------------------------------------------------------------
# Layout, size, storage, batches
# ---------------------------------------------------------------------------
def test_metas_stats_and_size_match_reference():
    for smoke in (True, False):
        _, jmodel = jax_get_arch(ARCH, smoke=smoke)
        _, model = get_arch(ARCH, smoke=smoke)
        jl = dict(jnamed_leaves(jmodel.metas(jax_single_device_config())))
        tl = dict(named_leaves(model.metas(DistConfig())))
        assert list(tl) == list(jl)
        assert list(tl)[-2:] == ["proj_w1", "proj_w2"]
        for n, m in tl.items():
            assert (m.name, tuple(m.global_shape), m.tp_dim) == (
                jl[n].name, tuple(jl[n].global_shape), jl[n].tp_dim), n
        assert model.stacked_keys == jmodel.stacked_keys
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = model.block_stats(DistConfig(param_dtype=dt), (2, 2048))
            want = jmodel.block_stats(
                jax_single_device_config(param_dtype=jdt), (2, 2048))
            assert (got.param_flops, got.param_bytes, got.act_bytes) == \
                (want.param_flops, want.param_bytes, want.act_bytes)
        n_img = model.cfg.n_img_tokens
        for kind in ("train", "prefill", "decode"):
            got = model.input_specs(ShapeConfig("s", n_img + 24, 4, kind),
                                    DistConfig())
            want = jmodel.input_specs(JShapeConfig("s", n_img + 24, 4, kind),
                                      jax_single_device_config())
            assert list(got) == list(want)
            assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} \
                == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert model.cp_supported is jmodel.cp_supported is False
    cfg, model = get_arch(ARCH)
    jcfg, _ = jax_get_arch(ARCH)
    assert cfg.n_params() == RT.n_params(model) == 19_918_755_840
    assert jcfg.n_params() == 19_861_340_160
    assert cfg.n_params() - jcfg.n_params() == \
        cfg.vit_dim * cfg.d_model + cfg.d_model ** 2 + cfg.d_model
    assert cfg.gqa_layout(1) == dict(mode="grouped", hq=48, kvp=8, g=6,
                                     g_real=6)
    assert (cfg.n_img_tokens, cfg.vit_dim, cfg.vocab) == (1025, 3200, 92560)


def test_storage_batches_and_reference_init_carry_over_byte_for_byte():
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    jdcfg = jax_single_device_config(reorder=False)
    jmetas = jmodel.metas(jdcfg)
    full = _numpy_full(jmodel, jdcfg, seed=3)
    want = {k: japi.shard_params(full[k], jmetas[k], jdcfg) for k in full}
    model, dcfg, par = _port(reorder=False)
    metas = model.metas(dcfg)
    full_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), full)
    got = {k: api.shard_params(full_t[k], metas[k], dcfg) for k in full_t}
    got_leaves = named_leaves(got)
    want_leaves = named_leaves(jax.tree.map(np.asarray, want))
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    for (n, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        assert a.numpy().tobytes() == b.tobytes(), n
    # the reference's own init (its projector drawn from fold_in(key, 999))
    # carries over as storage and as serve params, byte for byte
    jstore = JRT.init_storage(jmodel, jax.random.PRNGKey(5), jdcfg)
    jleaves = named_leaves(jax.tree.map(np.asarray, jstore))
    carried = RT.storage_from_jax(jax.tree.map(np.asarray, jstore), model,
                                  dcfg, device="cpu")
    for (n, a), (_, b) in zip(named_leaves(carried), jleaves):
        assert a.numpy().tobytes() == b.tobytes(), n
    assert float(np.std(dict(jleaves)["proj_w1"])) == pytest.approx(
        0.02, rel=0.2)
    sdcfg = single_device_config(param_dtype=torch.float32)
    jserve = JSV.serve_params_from_storage(
        jmodel, jstore, jax_single_device_config(param_dtype=jnp.float32))
    params = SV.serve_params_from_jax(jax.tree.map(np.asarray, jserve),
                                      model, sdcfg, device="cpu")
    for (n, a), (_, b) in zip(named_leaves(params),
                              named_leaves(jax.tree.map(np.asarray,
                                                        jserve))):
        assert a.numpy().tobytes() == b.tobytes(), n
    # the port's own seeded init has the reference's layout and scales
    init = par.init_storage(torch.Generator().manual_seed(0))
    assert [(n, tuple(a.shape)) for n, a in named_leaves(init)] == \
        [(n, b.shape) for n, b in want_leaves]
    assert float(init["proj_w2"].std()) == pytest.approx(0.02, rel=0.2)
    # Trainer's batches are the reference's adapt_batch, bit for bit
    jcfg, _ = jax_get_arch(ARCH, smoke=True)
    trainer = Trainer(model, DistConfig(param_dtype=torch.float32),
                      ShapeConfig("t", S, B, "train"), AdamWConfig(),
                      TrainerConfig(total_steps=1), device="cpu")
    for step in (0, 1):
        jb = jadapt_batch(JSyntheticC4(JDataConfig(
            vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=0)).batch(
                step), jmodel.input_specs(JShapeConfig("t", S, B, "train"),
                                          jdcfg), step)
        tb = trainer._batch(step)
        assert set(tb) == set(jb) == {"tokens", "targets", "img_embeds",
                                      "valid"}
        assert tb["img_embeds"].shape == (B, N_IMG, 48)
        assert tb["tokens"].shape == (B, S - N_IMG)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and tb[k].tobytes() == \
                jb[k].tobytes(), (step, k)


# ---------------------------------------------------------------------------
# Loss and gradients against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reorder", [False, True],
                         ids=["vanilla", "prefetch"])
@pytest.mark.parametrize("dtype,remat", [
    (torch.float32, "fsdp_only"), (torch.float32, "full"),
    (torch.bfloat16, "fsdp_only")], ids=["fp32", "fp32-full", "bf16"])
def test_loss_and_grads_match_reference(reorder, dtype, remat):
    storage_np, batch, want_loss, want_grads = _reference(dtype)
    model, dcfg, par = _port(reorder=reorder, dtype=dtype, remat=remat)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    n = (flash_ops.launches, flash_ops.launches_f32, xent_ops.fwd_launches)
    loss, grads = par.loss_step()(storage, batch)
    assert (flash_ops.launches, flash_ops.launches_f32,
            xent_ops.fwd_launches) == n                    # CPU: plain
    tol = TOL32 if dtype == torch.float32 else TOL
    np.testing.assert_allclose(float(loss), want_loss, **tol)
    for k in ("proj_w1", "proj_w2"):      # the images reached the loss
        assert float(grads[k].abs().max()) > 0, k
    _close(grads, want_grads, f"reorder={reorder} {dtype} {remat} grad", tol)


def test_image_positions_leave_the_loss():
    """The loss is the masked mean over the text positions only: changing
    the image positions' would-be targets changes nothing, and the loss
    equals a plain per-token cross-entropy over the text logits."""
    storage_np, batch, want_loss, _ = _reference()
    model, dcfg, par = _port(reorder=False)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    x, aux = model.stage_blocks(storage, model.stage_pre(
        storage, batch, dcfg), dcfg)
    assert x.shape == (B, S, model.cfg.d_model)
    loss = model.stage_loss(storage, (x, aux), batch, dcfg)
    metas = model.metas(dcfg)
    full = {k: api.unshard_params(storage[k], metas[k], dcfg)
            for k in ("final_norm", "head")}
    h = torch.nn.functional.rms_norm(x[:, N_IMG:], (x.shape[-1],),
                                     full["final_norm"], model.cfg.norm_eps)
    logits = h @ full["head"]
    per = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.as_tensor(batch["targets"]).reshape(-1).long(),
        reduction="none")
    valid = torch.as_tensor(batch["valid"]).reshape(-1)
    np.testing.assert_allclose(float(loss), float(
        (per * valid).sum() / valid.sum()), **TOL32)
    np.testing.assert_allclose(float(loss), want_loss, **TOL32)


def test_prefetch_flags_give_the_vanilla_gradients():
    """The Table-6 flags reorder the prefetch stack's work, never its
    values: every combination gives the vanilla stack's loss and
    gradients, bit for bit."""
    storage_np, batch, _, _ = _reference()
    model, dcfg, par = _port(reorder=False)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    want_loss, want = par.loss_step()(storage, batch)
    for fwd, bwd, delay in itertools.product((False, True), repeat=3):
        _, _, p = _port(reorder=True, ag_before_wait_fwd=fwd,
                        ag_before_wait_bwd=bwd, rs_delay=delay)
        loss, grads = p.loss_step()(storage, batch)
        case = (fwd, bwd, delay)
        assert torch.equal(loss, want_loss), case
        for (n, a), (_, b) in zip(named_leaves(grads), named_leaves(want)):
            assert torch.equal(a, b), (case, n)


def test_collective_counts_per_step():
    """Per loss step, block buckets (one a layer): the layers gathered once
    on the vanilla stack under remat none and twice under fsdp_only (the
    recompute gathers again), and on the prefetch stack each layer's two
    segments (attention, FFN) twice; the five leaves outside the stack
    (embed, proj_w1, proj_w2, final_norm, head) once each; one
    reduce-scatter a bucket (or segment) and a leaf."""
    storage_np, batch, _, _ = _reference()
    for remat, reorder, gathers, scatters in (("none", False, 2, 2),
                                              ("fsdp_only", False, 4, 2),
                                              ("fsdp_only", True, 8, 4)):
        model, dcfg, par = _port(remat=remat, reorder=reorder)
        storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
        assert model.stacked_keys["blocks"] * par.plan.bucket_plan(
            "blocks").n_buckets == 2
        g0, r0 = coll.gathers, coll.reduce_scatters
        par.loss_step()(storage, batch)
        case = (remat, reorder)
        assert coll.gathers - g0 == gathers + len(OUTSIDE), case
        assert coll.reduce_scatters - r0 == scatters + len(OUTSIDE), case


# ---------------------------------------------------------------------------
# Steps, checkpoints, the launcher
# ---------------------------------------------------------------------------
def test_chained_steps_and_checkpoint_resume_match_reference(tmp_path):
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    jdcfg = jax_single_device_config(param_dtype=jnp.float32,
                                     reduce_dtype=jnp.float32, reorder=False)
    ocfg = JAdamWConfig()
    par = japi.parallelize(jmodel, jdcfg, JShapeConfig("t", S, B, "train"))
    step_fn = par.train_step(ocfg, jax_default_schedule(ocfg, STEPS, WARMUP),
                             donate=False)
    full = _numpy_full(jmodel, jdcfg, seed=1)
    metas = jmodel.metas(jdcfg)
    storage = {k: japi.shard_params(full[k], metas[k], jdcfg) for k in full}
    opt = init_opt_state(storage)
    init = jax.tree.map(np.asarray, storage)
    want = []
    for step in range(STEPS):
        if step == STEPS - 1:
            JCheckpointer(str(tmp_path)).save(step, storage, opt, jmodel,
                                              jdcfg)
        storage, opt, m = step_fn(storage, opt, {
            k: jnp.asarray(v) for k, v in _batch(step).items()})
        want.append(jax.tree.map(float, m))

    # the port's Trainer (the launcher's default schedule: the prefetch
    # stack), chained from the same initial storage on the same batches
    _, model = get_arch(ARCH, smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32)
    trainer = Trainer(model, dcfg, ShapeConfig("t", S, B, "train"),
                      AdamWConfig(), TrainerConfig(
                          total_steps=STEPS, log_every=1, warmup=WARMUP,
                          ckpt_dir=str(tmp_path)), device="cpu")
    tstore = RT.storage_from_jax(init, model, dcfg, device="cpu")
    topt = init_train_state(trainer.par, torch.Generator())[1]
    for step in range(STEPS):
        batch = trainer._batch(step)
        tstore, topt, m = trainer.step_fn(tstore, topt, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), want[step][k],
                                       err_msg=f"step {step} {k}", **TOL32)
    _close(tstore, storage, "storage")
    _close(topt["m"], opt["m"], "m")
    _close(topt["v"], opt["v"], "v")

    # the reference's checkpoint of step 2, the projector included, resumed
    rstore, ropt, hist = trainer.run()
    assert [h["step"] for h in hist] == [STEPS]
    np.testing.assert_allclose(hist[0]["loss"], want[-1]["loss"], **TOL32)
    _close(rstore, storage, "resumed storage")
    _close(ropt["v"], opt["v"], "resumed v")
    # the port's own checkpoint of the last step restores bit for bit
    back, bopt, _ = Checkpointer(str(tmp_path)).restore(STEPS, model, dcfg)
    for name, got, want_ in (("params", back, rstore), ("m", bopt["m"],
                             ropt["m"]), ("v", bopt["v"], ropt["v"])):
        for (n, a), (_, b) in zip(named_leaves(got), named_leaves(want_)):
            assert torch.equal(a, b), f"{name}/{n}"


def test_train_launcher_trains_the_vlm_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "internvl2-26b", "--smoke", "--device",
                       "cpu", "--steps", "2", "--seq", "24", "--batch", "2",
                       "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("plan: mesh[data=1xmodel=1]")
    losses = [float(l.split()[3]) for l in lines if l.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    for leaf in ("proj_w1", "proj_w2", "blocks__attn__wq"):
        assert (tmp_path / "step_00000002" / f"params__{leaf}.npy").exists()


def test_unported_parts_raise():
    cfg, model = get_arch(ARCH, smoke=True)
    assert isinstance(model, VLM) and model.family == cfg.family == "vlm"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.stage_spec(2)
    with pytest.raises(NotImplementedError, match="tp=2"):
        api.parallelize(model, DistConfig(mesh_shape=(1, 2)),
                        ShapeConfig("t", S, B, "train"), device="cpu")
    with pytest.raises(NotImplementedError, match="family=dense"):
        VLM(get_arch("qwen3_1_7b", smoke=True)[0])
    import dataclasses
    with pytest.raises(ValueError, match="vit_dim and n_img_tokens"):
        VLM(dataclasses.replace(cfg, n_img_tokens=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.parallelize(model, DistConfig(), ShapeConfig("t", S, B, "train"))
