"""Quantized collectives in the PyTorch port against the JAX reference, on
the CPU, qwen3 smoke, fp32, one rank, the prefetch stack (reorder=True).

  * the plain codec (`repro_torch.kernels.quant.ref`, what `ops.roundtrip`
    runs on the CPU) equals `repro.kernels.quant.ref` BIT FOR BIT: wire
    bytes, scales and decoded values, {fp8, int8} x {RTN, SR} x shapes
    (129,), (1024,), (1, 384), (5000,), f32 and bf16 inputs with an
    all-zero chunk, int8 half-way ties and values at exactly +-QMAX*scale;
    `hash_u32` and `buffer_seed` on the same bits; one case per codec and
    rounding against the Pallas kernel in interpret mode;
  * the error-feedback hop equals `repro.optim.adamw._error_feedback` bit
    for bit, and meets the reference's 50-step convergence bound;
  * the gradient half bit for bit: the same gradients of qwen3 smoke's
    block buckets (each holding TP-sharded and replicated params) packed
    and reduced by the port's `finalize_grad_bucket` and by the
    reference's (stochastic fp8 / int8 round trip per class buffer, the
    bf16 reduce-scatter of grad_compression), and one AdamW step with the
    error-feedback state on an injected reduced gradient against the
    reference's `apply_adamw` (ef, m, v, params and the norm); planted
    faults (the reduce-scatter codec off, RTN in place of SR, one codec
    buffer for the whole bucket, no EF hop, the hop after the norm) fail
    these checks;
  * the train step: comm_precision="bf16" is bit-exact with the default;
    fp8_ag / int8_ag give the reference's first-step loss and gradients at
    TOL32 (rtol 2e-4, atol 2e-5: the round-to-nearest all-gather codec is
    deterministic, the rest differs in summation order only); fp8, fp8_ef,
    int8_ef and int8 with grad_compression stay within the harness bounds
    (`tests/dist_harness.py` case_quant) of the reference's bf16 run over
    2 chained AdamW steps: losses at rtol 5e-2 and per-coordinate weight
    drift <= 4*lr*steps (the stochastic-rounding seed depends on every bit
    of the gradient, so the two packages dither differently); `ef` is in
    the optimizer state exactly when `needs_ef`, and non-zero;
    comm_precision="auto" resolves (bf16 everywhere at one rank);
  * a per-bucket plan (bf16 / fp8_ef / int8_ag) on both schedules: the
    first loss step against the reference's on the same plan; two chained
    steps within the harness bounds and against the reference's two steps
    on the same plan, its error-feedback hop restricted to the fp8_ef
    bucket's leaves as the port's (the reference quantizes every leaf
    under 'auto'): losses and the bf16 / int8_ag leaves at TOL32, the
    fp8_ef leaves within lr * steps / 2; EF non-zero only in the fp8_ef
    bucket;
  * a `Trainer` restart under fp8_ef ends bit-exact, EF included, and a
    checkpoint written by the reference's checkpointer (which drops EF)
    resumes with EF at zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import api as japi
from repro.core.bucketing import BucketPlan as JBucketPlan
from repro.core import collectives as jcoll
from repro.core.compat import shard_map
from repro.core.dist import make_mesh as jax_make_mesh
from repro.core.dist import single_device_config as jax_single_device_config
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.kernels.quant import ops as jquant_ops
from repro.kernels.quant import ref as jquant
from repro.models import runtime as JRT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.core.meta import ParamMeta as JParamMeta
from repro.models.registry import get_arch as jax_get_arch
from repro.optim import adamw as jadamw
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import _error_feedback
from repro.optim.adamw import init_opt_state as jinit_opt_state

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import api
from repro_torch.core import collectives as coll
from repro_torch.core.bucketing import (BucketPlan, plan_for,
                                        split_plan_at_segments)
from repro_torch.core.dist import COMM_PRECISIONS, DistConfig, make_mesh
from repro_torch.core.meta import named_leaves
from repro_torch.ft.failures import InjectedFailures
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.quant import ref as quant
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, error_feedback, \
    init_opt_state
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
B, S, LR, STEPS = 4, 16, 1e-3, 2
ARCH = "qwen3_1_7b"


def codec_input(shape, dtype, seed=0):
    """numpy f32 data for the codec: an all-zero first chunk and, where the
    size allows, a chunk with absmax 127 (scale 1.0 under int8) holding
    int8 ties k + 0.5 and one with absmax 448 (scale 1.0 under fp8)
    holding e4m3 ties; both hold values at exactly +-QMAX * scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(int(np.prod(shape))) * 3).astype(np.float32)
    c = quant.QCHUNK
    x[:c] = 0
    if x.size >= 3 * c:
        x[c:c + 20] = np.arange(-10, 10) + 0.5
        x[c + 20:c + 22] = (127.0, -127.0)
        x[2 * c:2 * c + 6] = (448.0, -448.0, 1.0625, -17.0, 0.5 + 2 ** -5,
                              208.0)
    t = torch.from_numpy(x.reshape(shape))
    j = jnp.asarray(x.reshape(shape))
    if dtype == "bf16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)
    return t, j


def _u8(a):
    return np.asarray(a).view(np.uint8) if not isinstance(a, torch.Tensor) \
        else a.view(torch.uint8).numpy()


def _f32_bits(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy().view(np.uint32)
    return np.asarray(a.astype(jnp.float32)).view(np.uint32)


@pytest.mark.parametrize("shape", [(129,), (1024,), (1, 384), (5000,)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("codec", ["fp8", "int8"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_codec_is_bit_equal_to_reference(shape, dtype, codec, stochastic):
    t, j = codec_input(shape, dtype, seed=sum(shape))
    q, s = quant.quantize(t, codec, stochastic)
    jq, js = jquant.quantize(j, codec, stochastic)
    assert q.dtype == quant.WIRE_DTYPE[codec] and q.shape == jq.shape
    np.testing.assert_array_equal(_u8(q), _u8(jq))
    np.testing.assert_array_equal(_f32_bits(s), _f32_bits(js))
    got = quant_ops.roundtrip(t, codec, stochastic)
    want = jquant.roundtrip(j, codec, stochastic)
    assert got.dtype == t.dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


def test_hash_and_seed_are_bit_equal_to_reference():
    idx = np.arange(0, 1 << 20, 4099, dtype=np.uint32)
    for seed in (1, 0x9E3779B9, 0xFFFFFFFF):
        want = np.asarray(jquant.hash_u32(jnp.asarray(idx), jnp.uint32(seed)))
        got = quant.hash_u32(torch.from_numpy(idx.astype(np.int64)), seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for dtype in ("f32", "bf16"):
        t, j = codec_input((5000,), dtype, seed=3)
        t = t.clone()
        t[5] = -0.0
        j = j.at[5].set(-0.0)
        assert int(quant.buffer_seed(quant.chunk(t)[0])) == \
            int(jquant.buffer_seed(jquant.chunk(j)[0]))


@pytest.mark.parametrize("codec", ["fp8", "int8"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_codec_matches_pallas_kernel_in_interpret_mode(codec, stochastic):
    t, j = codec_input((1, 384), "f32", seed=7)
    want = jquant_ops.roundtrip_pallas(j, codec, stochastic=stochastic,
                                       interpret=True)
    got = quant_ops.roundtrip(t, codec, stochastic)
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


def test_error_feedback_hop_is_bit_equal_to_reference():
    rng = np.random.default_rng(11)
    g = {"a": rng.standard_normal(300).astype(np.float32),
         "b": {"c": (rng.standard_normal((2, 256)) * 1e-3)
               .astype(np.float32)}}
    ef = {"a": (rng.standard_normal(300) * 1e-2).astype(np.float32),
          "b": {"c": np.zeros((2, 256), np.float32)}}
    jgq, jef = _error_feedback(jax.tree.map(jnp.asarray, g),
                               jax.tree.map(jnp.asarray, ef))
    tef = jax.tree.map(lambda a: torch.from_numpy(a.copy()), ef)
    tgq = error_feedback(jax.tree.map(torch.from_numpy, g), tef)
    for tree, want in ((tgq, jgq), (tef, jef)):
        for (n, a), (_, b) in zip(named_leaves(tree),
                                  named_leaves(jax.tree.map(np.asarray,
                                                            want))):
            np.testing.assert_array_equal(_f32_bits(a), b.view(np.uint32),
                                          err_msg=n)


def test_error_feedback_converges():
    """The reference's bound (tests/test_quant.py): with a constant
    gradient the compensated stream's mean approaches the gradient as 1/T
    and the residual stays within one quantization step."""
    g = {"w": torch.from_numpy(np.random.default_rng(11).standard_normal(
        512).astype(np.float32) * 3)}
    ef = {"w": torch.zeros(512)}
    total = torch.zeros(512)
    T = 50
    for _ in range(T):
        total += error_feedback(g, ef)["w"]
    step = float(g["w"].abs().max()) / 14.0
    assert float((total / T - g["w"]).abs().max()) <= 2.0 * step / T + 1e-6
    assert float(ef["w"].abs().max()) <= step + 1e-6


# ---------------------------------------------------------------------------
# The gradient half bit for bit: reduce-scatter codec and the EF step
# ---------------------------------------------------------------------------
GRAD_CASES = [("fp8", {}), ("int8", {}), ("fp8_ef", {}), ("int8_ef", {}),
              ("fp8", dict(grad_compression=True)),
              ("bf16", dict(grad_compression=True))]
GRAD_IDS = ["fp8", "int8", "fp8_ef", "int8_ef", "fp8+gc", "bf16+gc"]


def _bits_equal(pairs) -> bool:
    return all(tuple(a.shape) == tuple(b.shape) and np.array_equal(
        _f32_bits(a), _f32_bits(b)) for a, b in pairs)


def _finalize_both(precision, kw, seed=5):
    """The same full gradients of every block bucket of qwen3 smoke's
    prefetch path (attention | mlp), packed and finalized (codec round
    trip, reduce-scatter, mean, split) by the port and by the reference at
    one rank.  Returns ([(port, reference) packed buffers],
    [(port, reference) local grad chunks])."""
    _, model = get_arch(ARCH, smoke=True)
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32, comm_precision=precision,
                      **kw)
    jdcfg = jax_single_device_config(param_dtype=jnp.float32,
                                     reduce_dtype=jnp.float32,
                                     comm_precision=precision, **kw)
    make_mesh(dcfg)
    mtree = model.block_metas(dcfg)
    metas = [m for _, m in named_leaves(mtree)]
    jmetas = jax.tree.leaves(jmodel.block_metas(jdcfg),
                             is_leaf=lambda x: isinstance(x, JParamMeta))
    assert [m.name for m in metas] == [m.name for m in jmetas]
    plan = split_plan_at_segments(plan_for(mtree, dcfg), mtree,
                                  model.block_segments(dcfg))
    groups = plan.index_groups(mtree)
    # a bucket holding both classes, so the per-class codec buffers show
    assert any(len({metas[i].tp_dim is None for i in grp}) == 2
               for grp in groups)
    rng = np.random.default_rng(seed)
    packed, chunks = [], []
    for grp in groups:
        ms, jms = [metas[i] for i in grp], [jmetas[i] for i in grp]
        gs = [rng.standard_normal(m.local_shape(dcfg)).astype(np.float32)
              for m in ms]
        shapes = [m.shard_shape(dcfg) for m in ms]
        ct = coll.pack_grad_bucket([torch.from_numpy(g) for g in gs], ms,
                                   dcfg)
        jcts = jcoll.pack_grad_bucket([jnp.asarray(g) for g in gs], jms,
                                      jdcfg)
        packed.append((ct.clone(), jnp.concatenate(jcts, axis=1)))
        chunks += zip(coll.finalize_grad_bucket(ct, ms, dcfg,
                                                shapes).wait(),
                      jcoll.finalize_grad_bucket(jcts, jms, jdcfg, shapes))
    return packed, chunks


@pytest.mark.parametrize("precision,kw", GRAD_CASES, ids=GRAD_IDS)
def test_grad_bucket_finalize_is_bit_equal_to_reference(precision, kw):
    packed, chunks = _finalize_both(precision, kw)
    assert {p[0].dtype for p in packed} == \
        {torch.bfloat16 if kw else torch.float32}
    assert _bits_equal(packed)
    assert _bits_equal(chunks)


def _planted_roundtrip(plant):
    real = quant_ops.roundtrip

    def roundtrip(x, codec, stochastic=False, out=None):
        y = x if plant == "codec_off" else real(x, codec, False)
        return y if out is None else out.copy_(y)
    return roundtrip


@pytest.mark.parametrize("plant", ["codec_off", "rtn_for_sr", "one_buffer"])
def test_grad_bucket_check_rejects_planted_faults(plant, monkeypatch):
    """Each plant must break the bit-equality above: the reduce-scatter
    codec switched off, round-to-nearest in place of the stochastic
    codec, one codec buffer for the whole bucket instead of one per
    class (a different seed and flat index)."""
    if plant == "one_buffer":
        monkeypatch.setattr(coll, "_vma_classes",
                            lambda metas: [list(range(len(metas)))])
    else:
        monkeypatch.setattr(quant_ops, "roundtrip", _planted_roundtrip(plant))
    packed, chunks = _finalize_both("fp8", {})
    assert not _bits_equal(chunks)


@functools.cache
def _ef_step_inputs():
    """Params, an injected reduced gradient, non-zero moments and EF, as
    numpy, and the reference's `apply_adamw` on them at step 5 with
    clipping on (the norm sets the scale, so where the hop sits shows):
    (inputs, (params, state, norm)).  The reference's hop is fp8 under
    every *_ef precision, so one run serves both."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 256)).astype(np.float32),
            "b": rng.standard_normal(384).astype(np.float32)}
    draw = {"g": 2.0, "m": 0.1, "ef": 0.05}
    st = {k: {n: (rng.standard_normal(a.shape) * s).astype(np.float32)
              for n, a in tree.items()} for k, s in draw.items()}
    st["v"] = {n: (np.abs(rng.standard_normal(a.shape)) * 0.01)
               .astype(np.float32) for n, a in tree.items()}
    st["p"] = tree
    jcfg = jax_single_device_config(comm_precision="fp8_ef")
    jmetas = {k: JParamMeta(k, a.shape) for k, a in tree.items()}
    J = lambda d: {k: jnp.asarray(a) for k, a in d.items()}  # noqa: E731
    jstate = {"m": J(st["m"]), "v": J(st["v"]), "ef": J(st["ef"]),
              "step": jnp.asarray(4, jnp.int32)}

    def step(p, g, s):
        return jadamw.apply_adamw(p, g, s, jmetas, jcfg,
                                  jadamw.AdamWConfig(), EF_LR)
    leafs = {k: P() for k in tree}
    specs = (leafs, leafs, {"m": leafs, "v": leafs, "ef": leafs,
                            "step": P()})
    want = shard_map(step, mesh=jax_make_mesh(jcfg), in_specs=specs,
                     out_specs=(specs[0], specs[2], P()))(
        J(tree), J(st["g"]), jstate)
    return st, jax.tree.map(np.asarray, want)


EF_LR = np.float32(3e-4)


def _ef_step_both(precision, monkeypatch=None, plant=None):
    """The port's `apply_adamw` on `_ef_step_inputs`, beside the
    reference's: [(port, reference)] for params, m, v, ef and the norm."""
    st, (want_p, want_s, want_norm) = _ef_step_inputs()
    dcfg = DistConfig(param_dtype=torch.float32, comm_precision=precision)
    make_mesh(dcfg)
    T = lambda d: {k: torch.from_numpy(a.copy())  # noqa: E731
                   for k, a in d.items()}
    storage, grads = T(st["p"]), T(st["g"])
    state = {"m": T(st["m"]), "v": T(st["v"]), "ef": T(st["ef"]),
             "step": torch.tensor(4, dtype=torch.int32)}
    if plant == "no_hop":
        monkeypatch.setattr(adamw, "error_feedback",
                            lambda g, ef, mask=None: g)
    elif plant == "hop_after_norm":
        norm = adamw.global_grad_norm
        monkeypatch.setattr(adamw, "global_grad_norm",
                            lambda g, cfg: norm(grads, cfg))
    gnorm = adamw.apply_adamw(storage, grads, state, dcfg, AdamWConfig(),
                              torch.tensor(EF_LR))
    assert int(state["step"]) == int(want_s["step"]) == 5
    pairs = [(storage[k], want_p[k]) for k in storage]
    pairs += [(state[s][k], want_s[s][k]) for s in ("m", "v", "ef")
              for k in storage]
    return pairs + [(gnorm, want_norm)]


@pytest.mark.parametrize("precision", ["fp8_ef", "int8_ef"])
def test_ef_optimizer_step_is_bit_equal_to_reference(precision):
    pairs = _ef_step_both(precision)
    assert _bits_equal(pairs)
    assert float(pairs[-1][0]) > AdamWConfig().grad_clip   # clipping on


@pytest.mark.parametrize("plant", ["no_hop", "hop_after_norm"])
def test_ef_step_check_rejects_planted_faults(plant, monkeypatch):
    assert not _bits_equal(_ef_step_both("fp8_ef", monkeypatch, plant))


@pytest.mark.parametrize("precision", ["fp8_ef", "bf16"])
def test_ef_state_must_match_the_config(precision):
    """An optimizer state built without the config under an *_ef precision
    (or with EF under one without) is refused, not trained as if EF were
    off."""
    dcfg = DistConfig(param_dtype=torch.float32, comm_precision=precision)
    make_mesh(dcfg)
    storage = {"a": torch.ones(256)}
    state = init_opt_state(storage, None if dcfg.needs_ef else
                           DistConfig(comm_precision="fp8_ef"))
    with pytest.raises(ValueError, match="error-feedback"):
        adamw.apply_adamw(storage, {"a": torch.ones(256)}, state, dcfg,
                          AdamWConfig(), torch.tensor(1e-3))


# ---------------------------------------------------------------------------
# Train steps against the reference
# ---------------------------------------------------------------------------
def _batch(vocab):
    return SyntheticC4(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=0)).batch(0)


@functools.cache
def _jax_storage():
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=jnp.float32,
                                    reduce_dtype=jnp.float32)
    storage = JRT.init_storage(jmodel, jax.random.PRNGKey(0), dcfg)
    return jax.tree.map(np.asarray, storage), _batch(jcfg.vocab)


@functools.cache
def _jax_loss_step(precision):
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    storage, batch = _jax_storage()
    dcfg = jax_single_device_config(param_dtype=jnp.float32,
                                    reduce_dtype=jnp.float32,
                                    comm_precision=precision)
    par = japi.parallelize(jmodel, dcfg, JShapeConfig("t", S, B, "train"))
    loss, grads = par.loss_step()(
        jax.tree.map(jnp.asarray, storage),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.cache
def _jax_two_steps():
    """The reference's bf16 run: 2 chained AdamW steps; returns (losses,
    final storage, the state after step 1)."""
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    storage, batch = _jax_storage()
    dcfg = jax_single_device_config(param_dtype=jnp.float32,
                                    reduce_dtype=jnp.float32)
    par = japi.parallelize(jmodel, dcfg, JShapeConfig("t", S, B, "train"))
    fn = par.train_step(JAdamWConfig(lr=LR), donate=False)
    st = jax.tree.map(jnp.asarray, storage)
    opt = jinit_opt_state(st, dcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, after_one = [], None
    for _ in range(STEPS):
        st, opt, met = fn(st, opt, jb)
        losses.append(float(met["loss"]))
        after_one = after_one or (st, opt)
    return losses, jax.tree.map(np.asarray, st), after_one


def _port(precision=None, **kw):
    """The port's plan at `precision` (None: the config's default)."""
    _, model = get_arch(ARCH, smoke=True)
    if precision is not None:
        kw["comm_precision"] = precision
    dcfg = DistConfig(param_dtype=torch.float32, **kw)
    par = api.parallelize(model, dcfg, ShapeConfig("t", S, B, "train"),
                          device="cpu")
    return model, dcfg, par


def _port_two_steps(precision=None, **kw):
    model, dcfg, par = _port(precision, **kw)
    storage_np, batch = _jax_storage()
    st = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    opt = init_opt_state(st, dcfg)
    fn = par.train_step(AdamWConfig(lr=LR))
    losses = []
    for _ in range(STEPS):
        st, opt, met = fn(st, opt, batch)
        losses.append(float(met["loss"]))
    return losses, st, opt, dcfg


def test_bf16_is_bit_exact_with_the_default():
    l_def, st_def, opt_def, _ = _port_two_steps()
    l_bf, st_bf, opt_bf, _ = _port_two_steps("bf16")
    assert l_bf == l_def and "ef" not in opt_bf and "ef" not in opt_def
    for (n, a), (_, b) in zip(named_leaves(st_bf), named_leaves(st_def)):
        assert torch.equal(a, b), n
    l_q, _, _, _ = _port_two_steps("fp8_ag")
    assert l_q != l_def      # the codec is engaged when asked for


@pytest.mark.parametrize("precision", ["fp8_ag", "int8_ag"])
def test_all_gather_codecs_match_reference_first_step(precision):
    want_loss, want_grads = _jax_loss_step(precision)
    model, dcfg, par = _port(precision)
    storage_np, batch = _jax_storage()
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    loss, grads = par.loss_step()(storage, batch)
    np.testing.assert_allclose(float(loss), want_loss, **TOL32)
    bf_loss, _ = _port("bf16")[2].loss_step()(storage, batch)
    assert abs(want_loss - float(bf_loss)) > 1e-5   # the codec moved it
    got, want = named_leaves(grads), named_leaves(want_grads)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=n, **TOL32)


@pytest.mark.parametrize("precision,kw", [
    ("fp8", {}), ("fp8_ef", {}), ("int8_ef", {}),
    ("int8", dict(grad_compression=True))])
def test_quantized_steps_stay_within_harness_bounds(precision, kw):
    want_losses, want_st, _ = _jax_two_steps()
    losses, st, opt, dcfg = _port_two_steps(precision, **kw)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want_losses, rtol=5e-2)
    drift = max(float(np.abs(a.numpy() - b).max()) for (_, a), (_, b) in
                zip(named_leaves(st), named_leaves(want_st)))
    assert drift <= 4.0 * LR * STEPS, drift
    assert any(not np.array_equal(a.numpy(), b) for (_, a), (_, b) in
               zip(named_leaves(st), named_leaves(want_st)))
    assert ("ef" in opt) == dcfg.needs_ef
    if dcfg.needs_ef:
        assert max(float(a.abs().max()) for a in
                   (x for _, x in named_leaves(opt["ef"]))) > 0


def test_auto_precision_raises_not_yet_ported():
    """comm_precision='auto' resolves (it raised before the planners were
    ported): every block bucket gets a precision from the lattice, the
    state carries EF, and at one rank (every collective priced at 0) the
    planner keeps bf16, so the first loss step is the bf16 one."""
    assert "auto" in COMM_PRECISIONS
    _, dcfg, par = _port("auto")
    precs = par.plan.bucket_plan("blocks").precisions
    assert precs is not None and set(precs) == {"bf16"}
    assert dcfg.needs_ef and "comm=auto(bf16)" in par.plan.describe()
    model, _, bf = _port("bf16")
    storage_np, batch = _jax_storage()
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    assert float(par.loss_step()(storage, batch)[0]) == \
        float(bf.loss_step()(storage, batch)[0])
    with pytest.raises(ValueError, match="comm_precision"):
        DistConfig(comm_precision="fp4")


# a per-bucket plan: a bf16 bucket, an fp8_ef bucket spanning the attn and
# mlp segments (split by the prefetch stack, each piece keeping fp8_ef),
# and an int8_ag bucket
MIXED = (("attn/wk", "attn/wq", "attn/wv", "ln1"),
         ("attn/k_norm", "attn/q_norm", "attn/wo", "ln2", "mlp/wd"),
         ("mlp/wg", "mlp/wu"))
MIXED_PRECISIONS = ("bf16", "fp8_ef", "int8_ag")


@pytest.mark.parametrize("reorder", [False, True],
                         ids=["vanilla", "prefetch"])
def test_mixed_precision_plan_first_step_matches_reference(reorder):
    """One BucketPlan with a precision per bucket, on both schedules: the
    first loss step against the reference's on the same plan.  The loss
    and the gradients of buckets whose reduce-scatter is uncompressed
    (bf16, int8_ag) at TOL32, as the uniform *_ag cases; the fp8_ef
    bucket's gradients (a stochastically rounded reduce-scatter that
    dithers differently in the two packages) within two fp8 e4m3 steps
    of the reference's: 2 x (2^-3 |g| + 2^-9 x the leaf's largest |g|),
    plus TOL32's atol."""
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    storage_np, batch = _jax_storage()
    jd = jax_single_device_config(
        param_dtype=jnp.float32, reduce_dtype=jnp.float32,
        comm_precision="auto", reorder=reorder,
        bucket_mode=JBucketPlan(MIXED, MIXED_PRECISIONS))
    jpar = japi.parallelize(jmodel, jd, JShapeConfig("t", S, B, "train"))
    want_loss, want_grads = jpar.loss_step()(
        jax.tree.map(jnp.asarray, storage_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model, dcfg, par = _port("auto", reorder=reorder,
                             bucket_mode=BucketPlan(MIXED, MIXED_PRECISIONS))
    assert par.plan.describe() == jpar.plan.describe()
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    q0, d0 = quant_ops.quant_launches, quant_ops.dequant_launches
    loss, grads = par.loss_step()(storage, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL32)
    bf_loss = float(_port("bf16")[2].loss_step()(storage, batch)[0])
    assert abs(float(want_loss) - bf_loss) > 1e-5   # the codecs moved it
    sr = {f"blocks/{n}" for n in MIXED[1]}
    got = named_leaves(grads)
    want = named_leaves(jax.tree.map(np.asarray, want_grads))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        a = a.numpy()
        if n in sr:
            bound = 2 * (2.0 ** -3 * np.abs(b) + 2.0 ** -9 * np.abs(b).max()) \
                + TOL32["atol"]
            assert np.all(np.abs(a - b) <= bound), n
        else:
            np.testing.assert_allclose(a, b, err_msg=n, **TOL32)
    # the CPU runs the plain codec: no kernel launch is counted
    assert (quant_ops.quant_launches, quant_ops.dequant_launches) == (q0, d0)


def _flat(tree, prefix=""):
    """A nested dict -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _replaced(tree, new, prefix=""):
    """`tree` with the leaves `new` names replaced."""
    return {k: _replaced(v, new, f"{prefix}{k}/") if isinstance(v, dict)
            else new.get(f"{prefix}{k}", v) for k, v in tree.items()}


def _masked_hop(names):
    """The reference's error-feedback hop on the leaves `names` only (the
    port's rule: *_ef buckets); the others pass through, their EF kept."""
    def hop(grads, ef):
        fg, fe = _flat(grads), _flat(ef)
        gq, new_ef = _error_feedback({n: fg[n] for n in names},
                                     {n: fe[n] for n in names})
        return _replaced(grads, gq), _replaced(ef, new_ef)
    return hop


@functools.cache
def _jax_two_steps_mixed(masked):
    """The reference's 2 chained AdamW steps on the MIXED plan, its
    error-feedback hop on every leaf (as it runs) or, `masked`, on the
    fp8_ef bucket's leaves only; returns (losses, storage, opt state)."""
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    storage, batch = _jax_storage()
    jd = jax_single_device_config(
        param_dtype=jnp.float32, reduce_dtype=jnp.float32,
        comm_precision="auto",
        bucket_mode=JBucketPlan(MIXED, MIXED_PRECISIONS))
    mp = pytest.MonkeyPatch()
    if masked:
        mp.setattr(jadamw, "_error_feedback",
                   _masked_hop([f"blocks/{n}" for n in MIXED[1]]))
    try:
        par = japi.parallelize(jmodel, jd, JShapeConfig("t", S, B, "train"))
        fn = par.train_step(JAdamWConfig(lr=LR), donate=False)
        st = jax.tree.map(jnp.asarray, storage)
        opt = jinit_opt_state(st, jd)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        losses = []
        for _ in range(STEPS):
            st, opt, met = fn(st, opt, jb)
            losses.append(float(met["loss"]))
    finally:
        mp.undo()
    return losses, jax.tree.map(np.asarray, st), jax.tree.map(np.asarray,
                                                               opt)


def test_mixed_precision_plan_trains_within_harness_bounds():
    """Two chained AdamW steps of the per-bucket plan (prefetch) within
    the harness bounds of the reference's bf16 run, as the uniform
    quantized cases, and against the reference's two steps on the SAME
    plan with its error-feedback hop restricted to the fp8_ef bucket's
    leaves, the port's rule (the reference applies it to every leaf under
    'auto'):

      * losses and the leaves of the bf16 and int8_ag buckets, and the
        leaves outside the stack, at TOL32 (their gradients differ in
        summation order, and through the loss in the fp8_ef leaves);
      * the fp8_ef bucket's leaves within lr * steps / 2: the two
        packages' stochastic rounding dithers their gradients by up to two
        e4m3 steps (relative 2^-2, the first-step bound), and AdamW's step
        lr * m/sqrt(v) is invariant to the gradients' scale, so a relative
        change e moves it by about e * lr a step; the bound is twice that;
      * the error-feedback accumulator is non-zero exactly in the fp8_ef
        bucket's leaves, in both.

    Against the reference as it runs (the hop on every leaf), the bf16 /
    int8_ag leaves miss TOL32: the rule is the difference, measured."""
    want_losses, want_st, _ = _jax_two_steps()
    losses, st, opt, dcfg = _port_two_steps(
        "auto", bucket_mode=BucketPlan(MIXED, MIXED_PRECISIONS))
    np.testing.assert_allclose(losses, want_losses, rtol=5e-2)
    drift = max(float(np.abs(a.numpy() - b).max()) for (_, a), (_, b) in
                zip(named_leaves(st), named_leaves(want_st)))
    assert drift <= 4.0 * LR * STEPS, drift
    ef_names = {f"blocks/{n}" for n in MIXED[1]}
    ef_leaves = {n for n, a in named_leaves(opt["ef"])
                 if float(a.abs().max()) > 0}
    assert ef_leaves == ef_names

    same_losses, same_st, same_opt = _jax_two_steps_mixed(True)
    np.testing.assert_allclose(losses, same_losses, **TOL32)
    got, want = named_leaves(st), named_leaves(same_st)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        if n in ef_names:
            diff = float(np.abs(a.numpy() - b).max())
            assert diff <= LR * STEPS / 2, (n, diff)
        else:
            np.testing.assert_allclose(a.numpy(), b, err_msg=n, **TOL32)
    assert {n for n, a in named_leaves(same_opt["ef"])
            if np.abs(a).max() > 0} == ef_names

    _, all_st, all_opt = _jax_two_steps_mixed(False)
    assert {n for n, a in named_leaves(all_opt["ef"])
            if np.abs(a).max() > 0} == {n for n, _ in named_leaves(st)}
    ports = dict(named_leaves(st))
    assert not all(np.allclose(ports[n].numpy(), b, **TOL32)
                   for n, b in named_leaves(all_st) if n not in ef_names)


def _trainer(ckpt_dir, failures=None, steps=4):
    _, model = get_arch(ARCH, smoke=True)
    dcfg = DistConfig(param_dtype=torch.float32, comm_precision="fp8_ef")
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=1, log_every=1,
                         warmup=1, ckpt_dir=str(ckpt_dir))
    return Trainer(model, dcfg, ShapeConfig("t", S, B, "train"),
                   AdamWConfig(), tcfg, failure_source=failures,
                   device="cpu")


def test_fp8_ef_trainer_restarts_bit_exact(tmp_path):
    clean = _trainer(tmp_path / "a")
    st_a, opt_a, _ = clean.run()
    tr = _trainer(tmp_path / "b", InjectedFailures((2,)))
    st_b, opt_b, hist = tr.run()
    assert tr.restarts == 1 and [h["step"] for h in hist] == [1, 2, 3, 4]
    for tree_a, tree_b in ((st_a, st_b), (opt_a["ef"], opt_b["ef"]),
                           (opt_a["m"], opt_b["m"])):
        for (n, a), (_, b) in zip(named_leaves(tree_a), named_leaves(tree_b)):
            assert torch.equal(a, b), n
    assert max(float(a.abs().max()) for _, a in
               named_leaves(opt_a["ef"])) > 0
    # the port's checkpoint holds the accumulator beside m and v
    restored = Checkpointer(str(tmp_path / "a")).restore(
        4, clean.model, clean.dcfg)[1]
    for (n, a), (_, b) in zip(named_leaves(restored["ef"]),
                              named_leaves(clean.par.unshard(opt_a["ef"]))):
        assert torch.equal(a, b), n


def test_reference_checkpoint_resumes_with_zero_ef(tmp_path):
    _, _, (st, opt) = _jax_two_steps()
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    jdcfg = jax_single_device_config(param_dtype=jnp.float32)
    JCheckpointer(str(tmp_path)).save(1, st, opt, jmodel, jdcfg)
    tr = _trainer(tmp_path, steps=2)
    _, restored, _ = tr.ckpt.restore(1, tr.model, tr.dcfg)
    assert set(restored) == {"m", "v", "step", "ef"}
    assert all(not a.any() for _, a in named_leaves(restored["ef"]))
    storage, opt_state, hist = tr.run()
    assert [h["step"] for h in hist] == [2] and np.isfinite(hist[0]["loss"])
    assert max(float(a.abs().max()) for _, a in
               named_leaves(opt_state["ef"])) > 0
