"""zamba2 training parity at pp = 1: the PyTorch port against the JAX
reference on the CPU, on the SMOKE config (8 Mamba layers: 2 superblocks
of 3, each followed by the weight-tied shared attention block, and a
2-layer tail), at T = 24 so that the SSD's ragged last chunk (chunk 16)
runs.

  * storage: the port's `shard_params` is byte-equal to the reference's
    from the same full params;
  * `causal_conv1d` against the reference's, with and without a state;
  * loss and every storage gradient against the reference's
    `parallelize(...).loss_step()` in fp32 at TOL32 (rtol 2e-4, atol
    2e-5) for remat in {none, fsdp_only, full} x reorder in {False, True}
    (remat and the schedule do not change the reference's numbers, so it
    runs once);
  * collectives per loss step: each Mamba layer's bucket once, or twice
    when the layer is recomputed; the shared block's 9 leaves once per
    invocation (2 in SMOKE), twice when the invocation is rematerialised;
  * the full config's size (1,245,814,912 parameters, the sum of the
    metas; the reference's `n_params` says 3,318,898,688) and layout;
  * the parts not ported yet raise.

The bf16 loss step, the chained steps and the launcher are in
tests/test_torch_zamba2_steps.py, which shares this file's helpers.
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
from repro.models.xlstm import causal_conv1d as jax_causal_conv1d

from repro_torch.core import api
from repro_torch.core import collectives as coll
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.models.xlstm import causal_conv1d
from repro_torch.models.zamba2 import Zamba2LM

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "zamba2_1_2b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, S, STEPS, WARMUP = 4, 24, 3, 1
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _batch(vocab, step=0):
    return SyntheticC4(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=0)).batch(step)


@functools.cache
def _reference(dtype=torch.float32):
    """(numpy storage, batch, loss, numpy grads) of the JAX loss step."""
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=JAX_DTYPES[dtype],
                                    reduce_dtype=jnp.float32, reorder=False)
    storage = JRT.init_storage(jmodel, jax.random.PRNGKey(0), dcfg)
    batch = _batch(jcfg.vocab)
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


def test_storage_is_byte_equal_to_reference():
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    jdcfg = jax_single_device_config(reorder=False)
    jmetas = jmodel.metas(jdcfg)
    # full params from a numpy seed, the blocks stacked over the layers
    rng = np.random.default_rng(3)
    full = {k: jax.tree.map(
        lambda m: jnp.asarray(rng.standard_normal(
            ((jmodel.n_steps,) if k == "blocks" else ())
            + m.global_shape).astype(np.float32)), v)
        for k, v in jmetas.items()}
    want = {k: japi.shard_params(full[k], jmetas[k], jdcfg) for k in full}

    model, dcfg, par = _port(reorder=False)
    metas = model.metas(dcfg)
    full_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), full)
    got = {k: api.shard_params(full_t[k], metas[k], dcfg) for k in full_t}
    got_leaves = named_leaves(got)
    want_leaves = named_leaves(jax.tree.map(np.asarray, want))
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    assert any(n.startswith("shared/") for n, _ in got_leaves)
    for (n, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        assert a.numpy().tobytes() == b.tobytes(), n
    back = {k: api.unshard_params(got[k], metas[k], dcfg) for k in got}
    for (_, a), (_, b) in zip(named_leaves(back), named_leaves(full_t)):
        assert torch.equal(a, b)
    # the port's own seeded init has the reference's layout and shapes
    init = par.init_storage(torch.Generator().manual_seed(0))
    assert [(n, tuple(a.shape)) for n, a in named_leaves(init)] == \
        [(n, b.shape) for n, b in want_leaves]


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        want, want_st = jax_causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        got, got_st = causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
        np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    out, new = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w[:1]))
    np.testing.assert_allclose(out.numpy(), x * w[0], **TOL32)
    assert new is None


@pytest.mark.parametrize("remat", ["none", "fsdp_only", "full"])
@pytest.mark.parametrize("reorder", [False, True])
def test_loss_and_grads_match_reference(remat, reorder):
    storage_np, batch, want_loss, want_grads = _reference()
    model, dcfg, par = _port(remat=remat, reorder=reorder)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    n = ssd_ops.launches
    loss, grads = par.loss_step()(storage, batch)
    assert ssd_ops.launches == n            # the plain version on the CPU
    np.testing.assert_allclose(float(loss), want_loss, **TOL32)
    _close(grads, want_grads, f"remat={remat} reorder={reorder} grad")


@pytest.mark.parametrize("remat", ["none", "fsdp_only"])
@pytest.mark.parametrize("reorder", [False, True])
def test_collective_counts_per_step(remat, reorder):
    """Per loss step, block buckets: 8 Mamba layers, one bucket each,
    gathered once, or twice when the layer is recomputed with its gather
    (the prefetch stack always; the vanilla schedule unless remat is
    'none'); the shared block's 9 leaves gathered once per invocation (2
    superblocks), twice unless remat is 'none'; embedding, final norm and
    head once; one reduce-scatter per bucket, leaf and invocation."""
    storage_np, batch, _, _ = _reference()
    model, dcfg, par = _port(remat=remat, reorder=reorder)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    layers = model.n_steps * par.plan.bucket_plan("blocks").n_buckets
    shared = len(named_leaves(model.shared_metas(dcfg))) * model.n_super
    assert (layers, shared) == (8, 18)
    twice = 2 if reorder or remat != "none" else 1
    g0, r0 = coll.gathers, coll.reduce_scatters
    par.loss_step()(storage, batch)
    assert coll.gathers - g0 == twice * layers + (
        2 if remat != "none" else 1) * shared + 3
    assert coll.reduce_scatters - r0 == layers + shared + 3


def test_full_config_size_and_layout():
    """The parameter count is the sum of the metas' global sizes; the
    reference's `ArchConfig.n_params` applies the dense formula to this
    family and overcounts."""
    cfg, model = get_arch(ARCH)
    jcfg, _ = jax_get_arch(ARCH)
    assert cfg.n_params() == model.n_params() == 1_245_814_912
    assert jcfg.n_params() == 3_318_898_688
    assert (model.n_super, model.n_tail, model.nh) == (6, 2, 64)
    m = model.metas(DistConfig())
    assert m["blocks"]["w_x"].global_shape == (2048, 64, 64)
    assert m["blocks"]["w_out"].global_shape == (64, 64, 2048)
    assert m["shared"]["wq"].global_shape == (4096, 4096)
    assert m["shared"]["wd"].global_shape == (8192, 2048)
    assert cfg.gqa_layout(1)["mode"] == "sharded"


def test_unported_parts_raise():
    """Pipeline stages and tp > 1 raise (serving is ported:
    tests/test_torch_zamba2_serve.py); block_stats (the planners'
    workload) is ported and equals the reference's."""
    cfg, model = get_arch(ARCH, smoke=True)
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    got = model.block_stats(DistConfig(), (B, S))
    want = jmodel.block_stats(jax_single_device_config(), (B, S))
    assert (got.param_flops, got.param_bytes, got.act_bytes) == \
        (want.param_flops, want.param_bytes, want.act_bytes)
    for call in (lambda: model.stage_spec(2),
                 lambda: model.stage_blocks(None, None, None),
                 lambda: model.init_state(2, DistConfig(mesh_shape=(1, 2)))):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
    with pytest.raises(NotImplementedError, match="tp=2"):
        api.parallelize(model, DistConfig(mesh_shape=(1, 2)),
                        ShapeConfig("t", S, B, "train"), device="cpu")
    with pytest.raises(ValueError, match="not zamba"):
        Zamba2LM(get_arch("qwen3_1_7b", smoke=True)[0])
