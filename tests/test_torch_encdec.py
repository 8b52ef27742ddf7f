"""encdec training parity at pp = 1: the PyTorch port against the JAX
reference on the CPU, on seamless-m4t-large-v2's SMOKE config (2 encoder
and 2 decoder layers, d 64, 4 heads of 16, a plain GELU FFN of 128,
frontend 32), at seq 32 (S_src = S_tgt = 16).

  * the metas (names, shapes, tp_dim), both stacks' lengths, block_stats,
    bucket_units, input_specs; the full config's size (1,633,183,744
    parameters, the sum of the metas; the reference's `n_params` says
    1,531,445,248);
  * storage: the port's `shard_params` byte-equal to the reference's from
    the same full params, both stacks included;
  * loss and every storage gradient (the encoder's leaves, front_proj and
    enc_norm included: they get theirs through the memory's cotangent,
    summed over the decoder layers) against the reference's
    `parallelize(...).loss_step()`, on the vanilla and the prefetch stack
    (whose carry is the structure {"h", "mem"}), fp32 at TOL32 (rtol 2e-4,
    atol 2e-5) under remat fsdp_only and full, bf16 at TOL (2e-2);
  * the prefetch stack under every Table-6 flag combination gives the
    vanilla stack's gradients; on 2 gloo ranks both schedules give the
    mean of the rows' single-rank loss steps;
  * both stacks' bucket plans, exposures and `describe()` equal to the
    reference's under the TPU v5e profile; the memory plan's main key
    (dec_blocks) and its bucket override; `step_wire_metrics`, the
    modeled step time (None: no `blocks` key) and `plan_trace` equal;
  * collectives per loss step;
  * 3 chained AdamW steps through the port's `Trainer` at TOL32, the
    reference's checkpoint after step 2 resumed by the port, and the
    port's own checkpoint of step 3 restored bit for bit;
  * the launcher trains encdec on the CPU end to end;
  * the parts not ported yet raise.

Weights come from a numpy seed at the reference init's scales, in the
reference's storage layout, and reach the port through `storage_from_jax`;
the batch is SyntheticC4's fitted to `input_specs` by `adapt_batch`
(frames synthesised, token fields cropped to S_tgt).
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
from repro.core import autowrap as jaw
from repro.core.dist import DistConfig as JDistConfig
from repro.core.dist import single_device_config as jax_single_device_config
from repro.core.meta import named_leaves as jnamed_leaves
from repro.core.obs import drift as jdrift
from repro.core.obs import trace as jtrace
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticC4 as JSyntheticC4
from repro.data.pipeline import adapt_batch as jadapt_batch
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.optim.adamw import AdamWConfig as JAdamWConfig, init_opt_state
from repro.train.train_step import default_schedule as jax_default_schedule
from repro.train.train_step import step_wire_metrics as jstep_wire_metrics

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import api, hw
from repro_torch.core import autowrap as aw
from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.core.obs import drift, trace
from repro_torch.data.pipeline import DataConfig, SyntheticC4, adapt_batch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state, \
    step_wire_metrics
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "seamless_m4t_large_v2"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, S, STEPS, WARMUP = 2, 32, 3, 1
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
STACKS = ("enc_blocks", "dec_blocks")


def _batch(step=0):
    """SyntheticC4's batch at seq S fitted to the SMOKE train spec: frames
    (B, S/2, 32) synthesised from (seed, step), tokens cropped to S/2."""
    cfg, model = get_arch(ARCH, smoke=True)
    base = SyntheticC4(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=0)).batch(step)
    return adapt_batch(base, model.input_specs(
        ShapeConfig("t", S, B, "train"), DistConfig()), step)


def _numpy_full(jmodel, dcfg, seed=0):
    """Full params in the reference's layout (blocks stacked) from a numpy
    seed, at its init's scales: N(0, 1) x 0.02, wo / wd / head x 0.02 /
    sqrt(2 L), norms 1 + 0.1 N(0, 1)."""
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
# Layout and size
# ---------------------------------------------------------------------------
def test_metas_stats_and_size_match_reference():
    for smoke in (True, False):
        _, jmodel = jax_get_arch(ARCH, smoke=smoke)
        _, model = get_arch(ARCH, smoke=smoke)
        jl = dict(jnamed_leaves(jmodel.metas(jax_single_device_config())))
        tl = dict(named_leaves(model.metas(DistConfig())))
        assert list(tl) == list(jl)
        for n, m in tl.items():
            assert (m.name, tuple(m.global_shape), m.tp_dim) == (
                jl[n].name, tuple(jl[n].global_shape), jl[n].tp_dim), n
        assert model.stacked_keys == jmodel.stacked_keys
        assert (model.n_enc, model.n_dec, model.n_steps) == (
            jmodel.n_enc, jmodel.n_dec, jmodel.n_steps)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = model.block_stats(DistConfig(param_dtype=dt), (4, 2048))
            want = jmodel.block_stats(
                jax_single_device_config(param_dtype=jdt), (4, 2048))
            assert (got.param_flops, got.param_bytes, got.act_bytes) == \
                (want.param_flops, want.param_bytes, want.act_bytes)
        assert model.bucket_units() == jmodel.bucket_units()
        for kind in ("train", "prefill", "decode"):
            got = model.input_specs(ShapeConfig("s", 24, 4, kind),
                                    DistConfig())
            want = jmodel.input_specs(JShapeConfig("s", 24, 4, kind),
                                      jax_single_device_config())
            assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} \
                == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    cfg, model = get_arch(ARCH)
    jcfg, _ = jax_get_arch(ARCH)
    assert cfg.n_params() == model.n_params() == 1_633_183_744
    assert jcfg.n_params() == 1_531_445_248
    assert (model.n_enc, model.n_dec) == (24, 24)
    assert cfg.gqa_layout(1)["mode"] == "sharded"


def test_storage_is_byte_equal_to_reference():
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
    assert {n.split("/")[0] for n, _ in got_leaves} >= set(STACKS)
    for (n, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        assert a.numpy().tobytes() == b.tobytes(), n
    back = {k: api.unshard_params(got[k], metas[k], dcfg) for k in got}
    for (_, a), (_, b) in zip(named_leaves(back), named_leaves(full_t)):
        assert torch.equal(a, b)
    # the reference's numpy storage carries over through storage_from_jax
    carried = RT.storage_from_jax(jax.tree.map(np.asarray, want), model,
                                  dcfg, device="cpu")
    for (n, a), (_, b) in zip(named_leaves(carried), want_leaves):
        assert a.numpy().tobytes() == b.tobytes(), n
    # the port's own seeded init has the reference's layout and shapes
    init = par.init_storage(torch.Generator().manual_seed(0))
    assert [(n, tuple(a.shape)) for n, a in named_leaves(init)] == \
        [(n, b.shape) for n, b in want_leaves]
    # and the batch the tests feed both sides is the reference's own
    jcfg, _ = jax_get_arch(ARCH, smoke=True)
    jb = jadapt_batch(JSyntheticC4(JDataConfig(
        vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=0)).batch(0),
        jmodel.input_specs(JShapeConfig("t", S, B, "train"), jdcfg), 0)
    tb = _batch()
    assert set(tb) == set(jb) == {"frames", "tokens", "targets", "valid"}
    for k in jb:
        assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k])


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
    n = flash_ops.launches, flash_ops.launches_f32
    loss, grads = par.loss_step()(storage, batch)
    assert (flash_ops.launches, flash_ops.launches_f32) == n  # CPU: plain
    tol = TOL32 if dtype == torch.float32 else TOL
    np.testing.assert_allclose(float(loss), want_loss, **tol)
    got = dict(named_leaves(grads))
    enc = [k for k in got if k.split("/")[0] in (
        "enc_blocks", "front_proj", "enc_norm")]
    assert len(enc) == 10
    for k in enc:        # the memory's cotangent reached the encoder
        assert float(got[k].abs().max()) > 0, k
    _close(grads, want_grads, f"reorder={reorder} {dtype} {remat} grad", tol)


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


def _two_rank_worker(rank, tmp):
    """One of 2 gloo ranks: the loss step of both schedules on this rank's
    shard of the storage and its row of the batch; rank 0 saves the
    rank-mean loss and the gradients as full params."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                            rank=rank, world_size=2)
    try:
        full, batch = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {}
        for reorder in (False, True):
            model, dcfg, par = _port(mesh_shape=(2, 1), reorder=reorder)
            metas = model.metas(dcfg)
            storage = par.shard({k: api.shard_params(
                jax.tree.map(torch.from_numpy, full[k]), metas[k], dcfg)
                for k in metas})
            loss, grads = par.loss_step()(storage, batch)
            whole = par.unshard(grads)
            out[reorder] = (float(loss), {k: api.unshard_params(
                whole[k], metas[k], dcfg) for k in metas})
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


def test_two_ranks_reduce_the_encoder_gradients(tmp_path):
    """On 2 gloo ranks (one batch row each) both schedules give the mean
    of the two rows' single-rank loss steps: the loss and every gradient,
    the encoder's included, whose cotangent crosses the decoder's carry and
    is reduce-scattered with the rest."""
    import torch.multiprocessing as mp
    storage_np, batch, _, _ = _reference()
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    full = jax.tree.map(np.asarray, _numpy_full(
        jmodel, jax_single_device_config(reorder=False)))
    torch.save((full, batch), tmp_path / "inputs.pt")
    mp.spawn(_two_rank_worker, args=(str(tmp_path),), nprocs=2, join=True)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    _, _, par1 = _port()
    model, dcfg = par1.model, par1.dcfg
    step = par1.loss_step()
    halves = [step(RT.storage_from_jax(storage_np, model, dcfg,
                                       device="cpu"),
                   {k: v[i:i + 1] for k, v in batch.items()})
              for i in range(2)]
    want_loss = sum(float(l) for l, _ in halves) / 2
    metas = model.metas(dcfg)
    full = [{k: api.unshard_params(g[k], metas[k], dcfg) for k in metas}
            for _, g in halves]
    want = named_leaves(full[0])
    other = dict(named_leaves(full[1]))
    for reorder, (loss, grads) in got.items():
        np.testing.assert_allclose(loss, want_loss, **TOL32)
        g = named_leaves(grads)
        assert [n for n, _ in g] == [n for n, _ in want]
        for (n, a), (_, b) in zip(g, want):
            np.testing.assert_allclose(
                a.numpy(), ((b + other[n]) / 2).numpy(),
                err_msg=f"reorder={reorder} {n}", **TOL32)
        assert float(dict(g)["front_proj"].abs().max()) > 0


# ---------------------------------------------------------------------------
# Plans, the memory plan, wire bytes
# ---------------------------------------------------------------------------
def test_both_stacks_plans_and_exposure_equal_reference():
    """Each stack's groups, precisions and exposed_comm_time (no stats:
    the reference prices only a `blocks` key's workload), describe(),
    `step_wire_metrics`, the modeled step time (None without a `blocks`
    key) and the plan's trace exactly equal, every bucket mode at dp 1
    and 8 x each wire precision x reorder, under the TPU v5e profile."""
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    jsub = {"enc_blocks": jmodel.enc_block_metas,
            "dec_blocks": jmodel.dec_block_metas}
    sub = {"enc_blocks": model.enc_block_metas,
           "dec_blocks": model.dec_block_metas}
    for mode, dp, prec, reorder in itertools.product(
            ("none", "block", "auto", "auto_dp"), (1, 8),
            ("bf16", "fp8_ef", "auto"), (True, False)):
        case = (mode, dp, prec, reorder)
        kw = dict(mesh_shape=(dp, 1), bucket_mode=mode, comm_precision=prec,
                  reorder=reorder)
        jd = JDistConfig(mesh_axes=("data", "model"), **kw)
        d = DistConfig(**kw)
        jshape = JShapeConfig("t", 16, max(4, dp), "train")
        shape = ShapeConfig("t", 16, max(4, dp), "train")
        jp = japi.plan_parallel(jmodel, jd, jshape)
        with hw.use_profile(hw.TPU_V5E):
            p = api.plan_parallel(model, d, shape)
            got = {k: aw.exposed_comm_time(p.bucket_plan(k), sub[k](d), d,
                                           None) for k in STACKS}
            t = drift.modeled_step_time(model, p, shape)
            doc = trace.plan_trace(model, p, shape, repeats=2).to_json()
        assert set(p.bucket_plans) == set(jp.bucket_plans) == set(STACKS)
        for k in STACKS:
            assert p.bucket_plans[k].groups == jp.bucket_plans[k].groups, \
                (case, k)
            assert p.bucket_plans[k].precisions == \
                jp.bucket_plans[k].precisions, (case, k)
            want = jaw.exposed_comm_time(jp.bucket_plan(k), jsub[k](jd),
                                         jd, None)
            for key in ("exposed_s", "exposed_comm_s", "total_comm_s",
                        "compute_s", "n_buckets", "comm_wire_bytes"):
                assert got[k][key] == want[key], (case, k, key)
        assert p.describe() == jp.describe(), case
        assert step_wire_metrics(model, p) == jstep_wire_metrics(jmodel, jp)
        assert t is None and jdrift.modeled_step_time(jmodel, jp,
                                                      jshape) is None
        assert doc == jtrace.plan_trace(jmodel, jp, jshape,
                                        repeats=2).to_json(), case


def test_memory_plan_overrides_the_decoder_stack_as_the_reference():
    """The memory plan describes the main block group, dec_blocks: its
    peak equals the reference's, and an auto budget's bucket override
    lands on dec_blocks and runs there (`train_step.stack_plans`)."""
    from repro.core.memory import plan_memory as jplan_memory
    from repro_torch.core.memory import plan_memory
    from repro_torch.train.train_step import stack_plans
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    shape = ShapeConfig("t", S, 8, "train")
    jshape = JShapeConfig("t", S, 8, "train")
    for remat in ("fsdp_only", "full", "auto:0.00105"):
        kw = dict(mesh_shape=(8, 1), remat=remat)
        jd = JDistConfig(mesh_axes=("data", "model"), **kw)
        d = DistConfig(**kw)
        with hw.use_profile(hw.TPU_V5E):
            got = plan_memory(model, d, shape)
            p = api.plan_parallel(model, d, shape)
        want = jplan_memory(jmodel, jd, jshape)
        jp = japi.plan_parallel(jmodel, jd, jshape)
        assert got.main_key == want.main_key == "dec_blocks"
        assert got.peak == want.peak and got.policies == want.policies
        assert got.describe() == want.describe()
        assert p.describe() == jp.describe(), remat
        assert p.exec_dcfg.remat == jp.exec_dcfg.remat
        for k in STACKS:
            assert p.bucket_plans[k].groups == jp.bucket_plans[k].groups
        assert stack_plans(p) == p.bucket_plans


def test_collective_counts_per_step():
    """Per loss step, block buckets (one a layer): each stack's layers
    gathered once on the vanilla stack under remat none, twice under
    fsdp_only and on the prefetch stack (the recompute gathers again);
    embed, front_proj, enc_norm, final_norm and head once; one
    reduce-scatter a bucket and a leaf."""
    storage_np, batch, _, _ = _reference()
    for remat, reorder, times in (("none", False, 1),
                                  ("fsdp_only", False, 2),
                                  ("fsdp_only", True, 2)):
        model, dcfg, par = _port(remat=remat, reorder=reorder)
        storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
        layers = sum(model.stacked_keys[k] * par.plan.bucket_plan(k)
                     .n_buckets for k in STACKS)
        assert layers == 4
        g0, r0 = coll.gathers, coll.reduce_scatters
        par.loss_step()(storage, batch)
        case = (remat, reorder)
        assert coll.gathers - g0 == times * layers + 5, case
        assert coll.reduce_scatters - r0 == layers + 5, case


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
    assert trainer._modeled_step_s is None      # no drift model, as the ref
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

    # the reference's checkpoint of step 2, both stacks, resumed
    rstore, ropt, hist = trainer.run()
    assert [h["step"] for h in hist] == [STEPS]
    np.testing.assert_allclose(hist[0]["loss"], want[-1]["loss"], **TOL32)
    _close(rstore, storage, "resumed storage")
    _close(ropt["v"], opt["v"], "resumed v")
    # the port's own checkpoint of the last step, both stacked groups
    # through the plain layout, restores bit for bit
    back, bopt, _ = Checkpointer(str(tmp_path)).restore(STEPS, model, dcfg)
    for name, got, want_ in (("params", back, rstore), ("m", bopt["m"],
                             ropt["m"]), ("v", bopt["v"], ropt["v"])):
        for (n, a), (_, b) in zip(named_leaves(got), named_leaves(want_)):
            assert torch.equal(a, b), f"{name}/{n}"


def test_train_launcher_trains_encdec_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq", "20", "--batch", "2",
                       "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("plan: mesh[data=1xmodel=1]")
    assert "buckets[enc_blocks:1,dec_blocks:1]" in lines[0]
    losses = [float(l.split()[3]) for l in lines if l.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    for leaf in ("enc_blocks__attn__wq", "dec_blocks__xattn__wk",
                 "front_proj"):
        assert (tmp_path / "step_00000002" / f"params__{leaf}.npy").exists()


def test_unported_parts_raise():
    cfg, model = get_arch(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.stage_spec(2)
    with pytest.raises(NotImplementedError, match="tp=2"):
        api.parallelize(model, DistConfig(mesh_shape=(1, 2)),
                        ShapeConfig("t", S, B, "train"), device="cpu")
    with pytest.raises(ValueError, match="not encdec"):
        EncDecLM(get_arch("qwen3_1_7b", smoke=True)[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.parallelize(model, DistConfig(), ShapeConfig("t", S, B, "train"))
