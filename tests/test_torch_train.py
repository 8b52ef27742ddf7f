"""Training parity at pp = 1: the PyTorch port's FSDP loss step against the
JAX reference's `parallelize(...).loss_step()` on the CPU, the dense smoke
configs (llama3 and qwen3: GQA, qk-norm, tied embeddings; deepseek-coder
and phi3-medium: padded heads, masked).

  * storage: the port's `shard_params` is byte-equal to the reference's on
    the reference's own seeded full params;
  * loss and every storage gradient for remat in {none, fsdp_only, full}
    (plus save_dots and a per-segment vector) and bucket_mode in {none,
    block}, in fp32, at TOL32 (rtol 2e-4, atol 2e-5).  Remat and bucketing
    do not change the reference's numbers, so each arch's reference runs
    once (fsdp_only, block) and every port variant is held against it;
  * one bf16 case at TOL (rtol/atol 2e-2);
  * the gather / reduce-scatter counters per remat policy: the blocks'
    buckets are gathered twice per step under fsdp_only / full and once
    under none;
  * the bucket plans describe the reference's groups.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.dist import single_device_config as jax_single_device_config
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.models import runtime as JRT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import api
from repro_torch.core import collectives as coll
from repro_torch.core import hw
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, S = 4, 16
# deepseek pads its SMOKE q heads 6 -> 8, phi3 its q and kv heads 5 -> 8
ARCHS = ("llama3_8b", "qwen3_1_7b", "deepseek_coder_33b", "phi3_medium_14b")
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _batch(vocab):
    return SyntheticC4(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=0)).batch(0)


@functools.cache
def _reference(arch, dtype=torch.float32):
    """(numpy storage, batch, loss, numpy grads) of the JAX loss step."""
    jcfg, jmodel = jax_get_arch(arch, smoke=True)
    dcfg = jax_single_device_config(param_dtype=JAX_DTYPES[dtype],
                                    reduce_dtype=jnp.float32, reorder=False)
    storage = JRT.init_storage(jmodel, jax.random.PRNGKey(0), dcfg)
    batch = _batch(jcfg.vocab)
    par = japi.parallelize(jmodel, dcfg, JShapeConfig("t", S, B, "train"))
    loss, grads = par.loss_step()(storage, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(storage), batch, float(loss), to_np(grads)


def _port(arch, **kw):
    _, model = get_arch(arch, smoke=True)
    dcfg = DistConfig(param_dtype=kw.pop("dtype", torch.float32),
                      reorder=False, **kw)
    par = api.parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                          device="cpu")
    return model, dcfg, par


@pytest.mark.parametrize("arch", ARCHS)
def test_storage_is_byte_equal_to_reference(arch):
    jcfg, jmodel = jax_get_arch(arch, smoke=True)
    jdcfg = jax_single_device_config(reorder=False)
    full = jmodel.init_full(jax.random.PRNGKey(3), jdcfg)
    jmetas = jmodel.metas(jdcfg)
    want = {k: japi.shard_params(full[k], jmetas[k], jdcfg) for k in full}

    model, dcfg, par = _port(arch)
    metas = model.metas(dcfg)
    full_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), full)
    got = {k: api.shard_params(full_t[k], metas[k], dcfg) for k in full_t}
    got_leaves, want_leaves = named_leaves(got), named_leaves(
        jax.tree.map(np.asarray, want))
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    for (n, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        assert a.numpy().tobytes() == b.tobytes(), n
    # world size 1: the local shard is the whole storage; exact round trip
    local = par.shard(got)
    sk = model.stacked_keys
    for (n, a), (_, b) in zip(named_leaves(local), got_leaves):
        m = dict(named_leaves(metas))[n]
        lead = (sk[n.split("/")[0]],) if n.split("/")[0] in sk else ()
        assert tuple(a.shape) == lead + m.shard_shape(dcfg), n
        assert torch.equal(a, b)
    back = {k: api.unshard_params(got[k], metas[k], dcfg) for k in got}
    for (_, a), (_, b) in zip(named_leaves(back), named_leaves(full_t)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "fsdp_only", "full", "save_dots",
                                   "attn=full,mlp=fsdp_only"])
@pytest.mark.parametrize("bucket_mode", ["none", "block"])
def test_loss_and_grads_match_reference(arch, remat, bucket_mode):
    storage_np, batch, want_loss, want_grads = _reference(arch)
    model, dcfg, par = _port(arch, remat=remat, bucket_mode=bucket_mode)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    loss, grads = par.loss_step()(storage, batch)
    np.testing.assert_allclose(float(loss), want_loss, **TOL32)
    got, want = named_leaves(grads), named_leaves(want_grads)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32, n
        np.testing.assert_allclose(a.numpy(), b, err_msg=n, **TOL32)


def test_padded_head_layouts_are_masked():
    """deepseek's SMOKE pads its 6 q heads to 8 (kv 2, groups of 3 padded
    to 4), phi3's its 5 q and 5 kv heads to 8 each; the padded heads are
    masked out, so their weights get no gradient."""
    from repro_torch.models import layers as LY
    want = {"deepseek_coder_33b": (8, 2, 4, 3, 6), "phi3_medium_14b":
            (8, 8, 1, 1, 5)}
    storage_np, batch, _, _ = _reference("phi3_medium_14b")
    for arch, (hq, kvp, g, g_real, real) in want.items():
        cfg, _ = get_arch(arch, smoke=True)
        lay = cfg.gqa_layout(1)
        assert (lay["mode"], lay["hq"], lay["kvp"], lay["g"],
                lay["g_real"]) == ("grouped", hq, kvp, g, g_real)
        mask = LY.head_mask(cfg, DistConfig(), "cpu", torch.float32)
        assert int(mask.sum()) == real == cfg.n_heads
    model, dcfg, par = _port("phi3_medium_14b")
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    _, grads = par.loss_step()(storage, batch)
    hd = model.cfg.head_dim
    wk = grads["blocks"]["attn"]["wk"][..., :8 * hd * 64].reshape(
        2, 8, hd, 64)
    assert float(wk[:, 5:].abs().max()) == 0.0 < float(wk[:, :5].abs().max())


def test_bf16_logits_accumulate_in_fp32_like_the_reference():
    """The head product from bf16 operands is accumulated and returned in
    fp32, as the reference's ``preferred_element_type=float32``; a bf16
    product widened afterwards (the serving path before this slice) is a
    different function."""
    from repro.models import layers as JLY
    from repro_torch.models import layers as LY
    jcfg, _ = jax_get_arch("qwen3_1_7b", smoke=True)
    cfg, _ = get_arch("qwen3_1_7b", smoke=True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    want = np.asarray(JLY.head_logits(
        jnp.asarray(w.float().numpy(), jnp.bfloat16),
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jcfg,
        jax_single_device_config()))
    got = LY.logits_f32(x, w.t().contiguous(), cfg)   # tied: (V, D) table
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL32)
    rounded = torch.matmul(x, w).float().numpy()
    assert np.abs(rounded - want).max() > 1e-2


def test_carry_over_checks_every_key_and_shape():
    storage_np, _, _, _ = _reference("qwen3_1_7b")
    model, dcfg, _ = _port("qwen3_1_7b")
    missing = {k: v for k, v in storage_np.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="expected keys"):
        RT.storage_from_jax(missing, model, dcfg, device="cpu")
    bad = dict(storage_np, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        RT.storage_from_jax(bad, model, dcfg, device="cpu")
    with pytest.raises(ValueError, match="error feedback"):
        RT.opt_state_from_jax(dict(m=storage_np, v=storage_np, step=0,
                                   ef=storage_np), model, dcfg, device="cpu")


def test_bf16_loss_and_grads_match_reference():
    arch = "qwen3_1_7b"
    storage_np, batch, want_loss, want_grads = _reference(arch,
                                                          torch.bfloat16)
    model, dcfg, par = _port(arch, dtype=torch.bfloat16)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    loss, grads = par.loss_step()(storage, batch)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    for (n, a), (_, b) in zip(named_leaves(grads), named_leaves(want_grads)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=n, **TOL)


@pytest.mark.parametrize("remat,per_bucket", [("none", 1), ("fsdp_only", 2),
                                              ("full", 2)])
@pytest.mark.parametrize("bucket_mode", ["none", "block"])
def test_collective_counts_per_remat_policy(remat, per_bucket, bucket_mode):
    """Per loss step: each block bucket is gathered `per_bucket` times and
    reduce-scattered once; the embedding, final norm and (tied) head
    gathers outside the stack once each."""
    arch = "qwen3_1_7b"
    storage_np, batch, _, _ = _reference(arch)
    model, dcfg, par = _port(arch, remat=remat, bucket_mode=bucket_mode)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    buckets = par.plan.bucket_plan("blocks").n_buckets * model.n_steps
    outer = 3          # embed in, final norm, tied head
    g0, r0 = coll.gathers, coll.reduce_scatters
    par.loss_step()(storage, batch)
    assert coll.gathers - g0 == per_bucket * buckets + outer
    assert coll.reduce_scatters - r0 == buckets + outer


@pytest.mark.parametrize("bucket_mode", ["none", "block"])
def test_bucket_plans_match_reference(bucket_mode):
    """The plan, its memory record and describe() equal the reference's
    (priced with the reference's TPU profile)."""
    for arch in ARCHS:
        _, jmodel = jax_get_arch(arch, smoke=True)
        jplan = japi.plan_parallel(jmodel, jax_single_device_config(
            param_dtype=jnp.float32, reduce_dtype=jnp.float32,
            reorder=False, bucket_mode=bucket_mode),
            JShapeConfig("t", S, B, "train"))
        with hw.use_profile(hw.TPU_V5E):
            model, dcfg, par = _port(arch, bucket_mode=bucket_mode)
        assert par.plan.memory is not None
        assert par.plan.memory.peak_bytes == jplan.memory.peak_bytes
        assert par.plan.exec_dcfg == dcfg
        assert par.plan.bucket_plan("blocks").groups == \
            jplan.bucket_plan("blocks").groups
        assert par.plan.describe() == jplan.describe()


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "qwen3_moe_30b_a3b"])
@pytest.mark.parametrize("reorder", [False, True])
def test_a_step_and_a_restore_leave_no_reference_cycle(arch, reorder,
                                                       tmp_path):
    """A train step and a checkpoint restore free every tensor and array
    they made when they return: none waits in a reference cycle for
    Python's cycle collector.  (A recursive closure in `unflatten_like`
    held each step's gradient tree in a cycle, so a step could start with
    the previous step's gradients still allocated.)"""
    import gc
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state
    cfg, model = get_arch(arch, smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32, reorder=reorder)
    par = api.parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                          device="cpu")
    storage, opt = init_train_state(par, torch.Generator().manual_seed(0))
    step = par.train_step(AdamWConfig())
    batch = _batch(cfg.vocab)
    step(storage, opt, batch)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, storage, opt, model, dcfg)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step(storage, opt, batch)
        ckpt.restore(1, model, dcfg)
        gc.collect()
        held = [type(o).__name__ for o in gc.garbage
                if isinstance(o, (torch.Tensor, np.ndarray))]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []


def test_unported_layouts_raise_pointedly():
    """tp > 1 and pp > 1 raise; the bucket planners, the budgeted memory
    plan and per-bucket precision resolve."""
    _, model = get_arch("qwen3_1_7b", smoke=True)
    shape = ShapeConfig("t", S, B, "train")
    base = DistConfig(param_dtype=torch.float32, reorder=False)
    for kw, match in ((dict(mesh_shape=(1, 2)), "tp=2"),
                      (dict(mesh_axes=("pipe", "data", "model"),
                            mesh_shape=(2, 1, 1)), "pp>1")):
        with pytest.raises(NotImplementedError, match=match):
            api.parallelize(model, base.with_(**kw), shape, device="cpu")
    for kw in (dict(bucket_mode="auto"), dict(bucket_mode="auto_dp"),
               dict(remat="auto:12"), dict(comm_precision="auto")):
        plan = api.parallelize(model, base.with_(**kw), shape,
                               device="cpu").plan
        assert plan.memory is not None, kw
        if "remat" in kw:
            assert plan.exec_dcfg.remat != kw["remat"]
            assert plan.memory.budget_bytes == 12 * 1024**3
        if "comm_precision" in kw:
            assert plan.bucket_plan("blocks").precisions == ("bf16",)
