"""xlstm training parity at pp = 1: the PyTorch port against the JAX
reference on the CPU, on the SMOKE config (one superblock of 3 mLSTM blocks
and 1 sLSTM block, d 64, 2 heads, mLSTM chunk 16), at T = 40 so that the
chunkwise form's ragged last chunk runs.

  * the cells: `mlstm_chunked` at T 37, chunk 16, without and with an
    incoming state (y and the final (C, n, m)); `mlstm_step` repeated T
    times against the chunked form in true units (C e^m, n e^m: the pads of
    a ragged chunk may raise m); `slstm_seq` without and with a state; all
    at TOL32 (rtol 2e-4, atol 2e-5);
  * the metas' names, shapes and tp_dim; the full config's size
    (3,530,098,688 parameters, the sum of the metas; the reference's
    `ArchConfig.n_params` says 1,011,548,160);
  * loss and every storage gradient against the reference's
    `parallelize(...).loss_step()`, on the vanilla and the prefetch stack,
    fp32 at TOL32 and bf16 at TOL (2e-2);
  * the blocks' bucket plans and `exposed_comm_time` of SMOKE equal to the
    reference's under the TPU v5e profile, every bucket mode and wire
    precision (the planner files that parametrise over every ported arch
    leave xlstm out: there the joint precision DP over its 67-leaf
    superblock takes ~70 s a full-width plan on each side); block_stats,
    bucket_units and input_specs equal;
  * the launcher trains xlstm on the CPU end to end;
  * the parts not ported yet raise.

Weights come from a numpy seed at the reference init's scales (the gate
projection w_if at 0.1 instead of 0.005, so that the input and forget gates
vary and the stabilizers move), in the reference's storage layout, and
reach the port through `storage_from_jax`.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autowrap as jaw
from repro.core.dist import DistConfig as JDistConfig
from repro.core.dist import single_device_config as jax_single_device_config
from repro.core.meta import named_leaves as jnamed_leaves
from repro.data.pipeline import DataConfig, SyntheticC4
from repro.models import xlstm as jx
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch

from repro_torch.core import api, hw
from repro_torch.core import autowrap as aw
from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import named_leaves
from repro_torch.kernels.cross_entropy import ops as xent_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import runtime as RT
from repro_torch.models import xlstm as X
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "xlstm_1_3b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 40
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _close(got, want, what, tol=TOL32):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------
def _mlstm_inputs(seed=0, b=2, t=37, h=2, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    i_pre = rng.standard_normal((b, t, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, t, h)) + 3).astype(np.float32)
    state = (rng.standard_normal((b, h, dk, dv)).astype(np.float32),
             rng.standard_normal((b, h, dk)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    return (q, k, v, i_pre, f_pre), state


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(with_state):
    args, state = _mlstm_inputs()
    jy, jst = jx.mlstm_chunked(
        *map(jnp.asarray, args), chunk=16,
        state=tuple(map(jnp.asarray, state)) if with_state else None)
    ty, tst = X.mlstm_chunked(
        *map(torch.from_numpy, args), chunk=16,
        state=tuple(map(torch.from_numpy, state)) if with_state else None)
    assert ty.shape == (2, 37, 2, 8) and ty.dtype == torch.float32
    _close(ty, jy, "y")
    for name, a, b in zip("Cnm", tst, jst):
        _close(a, b, name)


def test_mlstm_step_repeated_equals_chunked_in_true_units():
    """T one-token steps from the empty state against the chunked form at
    T 37 (chunk 16: 11 pad rows): y, and the state as C e^m, n e^m."""
    args, _ = _mlstm_inputs(seed=1)
    q, k, v, i_pre, f_pre = map(torch.from_numpy, args)
    b, t, h, dk = q.shape
    y_c, (C_c, n_c, m_c) = X.mlstm_chunked(q, k, v, i_pre, f_pre, chunk=16)
    st = (torch.zeros((b, h, dk, v.shape[-1])), torch.zeros((b, h, dk)),
          torch.full((b, h), X.M0))
    ys = []
    for i in range(t):
        st, y = X.mlstm_step(st, q[:, i], k[:, i], v[:, i], i_pre[:, i],
                             f_pre[:, i])
        ys.append(y)
    _close(torch.stack(ys, 1), y_c, "y")
    C_s, n_s, m_s = st
    _close(C_s * m_s.exp()[..., None, None], C_c * m_c.exp()[..., None, None],
           "C e^m")
    _close(n_s * m_s.exp()[..., None], n_c * m_c.exp()[..., None], "n e^m")
    # and against the reference's step, one token
    jst, jy = jx.mlstm_step(tuple(jnp.asarray(a.numpy()) for a in st),
                            *(jnp.asarray(a[:, 0].numpy())
                              for a in (q, k, v, i_pre, f_pre)))
    tst, ty = X.mlstm_step(st, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                           f_pre[:, 0])
    _close(ty, jy, "step y")
    for name, a, b_ in zip("Cnm", tst, jst):
        _close(a, b_, f"step {name}")


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_seq_matches_reference(with_state):
    rng = np.random.default_rng(2)
    b, t, h, hd = 2, 23, 2, 8
    xg = (2 * rng.standard_normal((b, t, 4, h, hd))).astype(np.float32)
    R = (rng.standard_normal((4, h, hd, hd)) / np.sqrt(hd)).astype(
        np.float32)
    state = (rng.standard_normal((b, h, hd)).astype(np.float32),
             rng.standard_normal((b, h, hd)).astype(np.float32),
             (1 + rng.random((b, h, hd))).astype(np.float32),
             rng.standard_normal((b, h, hd)).astype(np.float32))
    jh, jst = jx.slstm_seq(jnp.asarray(xg), jnp.asarray(R),
                           tuple(map(jnp.asarray, state))
                           if with_state else None)
    th, tst = X.slstm_seq(torch.from_numpy(xg), torch.from_numpy(R),
                          tuple(map(torch.from_numpy, state))
                          if with_state else None)
    assert th.shape == (b, t, h, hd) and th.dtype == torch.float32
    _close(th, jh, "hs")
    for name, a, b_ in zip("hcnm", tst, jst):
        _close(a, b_, name)
    # bf16 gate inputs and a bf16 R: the reference widens R to fp32
    jh, _ = jx.slstm_seq(jnp.asarray(xg, jnp.bfloat16),
                         jnp.asarray(R, jnp.bfloat16))
    th, _ = X.slstm_seq(torch.from_numpy(xg).bfloat16(),
                        torch.from_numpy(R).bfloat16())
    _close(th, jh, "bf16 hs")


def test_metas_stats_and_size_match_reference():
    """Names, shapes, tp_dim; block_stats (fp32 and bf16), bucket_units
    and input_specs; the parameter count."""
    for smoke in (True, False):
        _, jmodel = jax_get_arch(ARCH, smoke=smoke)
        _, model = get_arch(ARCH, smoke=smoke)
        want = jmodel.metas(jax_single_device_config())
        got = model.metas(DistConfig())
        jl = dict(jnamed_leaves(want))
        tl = dict(named_leaves(got))
        assert list(tl) == list(jl)
        for n, m in tl.items():
            assert (m.name, tuple(m.global_shape), m.tp_dim) == (
                jl[n].name, tuple(jl[n].global_shape), jl[n].tp_dim), n
        assert model.stacked_keys == jmodel.stacked_keys
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
    assert cfg.n_params() == model.n_params() == 3_530_098_688
    assert jcfg.n_params() == 1_011_548_160
    assert (model.n_steps, model.per, model.d_inner, model.dk) == \
        (6, 8, 4096, 1024)


# ---------------------------------------------------------------------------
# Loss and gradients against the reference
# ---------------------------------------------------------------------------
def _batch(vocab):
    return SyntheticC4(DataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                  seed=0)).batch(0)


def _numpy_full(jmodel, dcfg, seed=0):
    """Full params in the reference's layout (blocks stacked) from a numpy
    seed, at its init's scales."""
    cfg = jmodel.cfg
    rng = np.random.default_rng(seed)
    deep = 0.02 / np.sqrt(2 * cfg.n_layers)
    hd = cfg.d_model // cfg.n_heads
    scale = dict(w_out=deep, head=deep, conv=1 / np.sqrt(cfg.ssm_conv),
                 R=1 / np.sqrt(hd), w_if=0.1)

    def tree(metas, n):
        if not hasattr(metas, "global_shape"):
            return {k: tree(v, n) for k, v in metas.items()}
        shape = (n, *metas.global_shape) if n else tuple(metas.global_shape)
        a = rng.standard_normal(shape)
        key = metas.name.split(".")[-1]
        a = 1 + 0.1 * a if len(metas.global_shape) == 1 \
            else scale.get(key, 0.02) * a
        return jnp.asarray(a.astype(np.float32))

    sk = jmodel.stacked_keys
    return {k: tree(v, sk.get(k)) for k, v in jmodel.metas(dcfg).items()}


@functools.cache
def _reference(dtype=torch.float32):
    """(numpy storage, batch, loss, numpy grads) of the JAX loss step."""
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=JAX_DTYPES[dtype],
                                    reduce_dtype=jnp.float32, reorder=False)
    full = _numpy_full(jmodel, dcfg)
    metas = jmodel.metas(dcfg)
    storage = {k: japi.shard_params(full[k], metas[k], dcfg) for k in full}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("reorder", [False, True],
                         ids=["vanilla", "prefetch"])
def test_loss_and_grads_match_reference(reorder, dtype):
    storage_np, batch, want_loss, want_grads = _reference(dtype)
    model, dcfg, par = _port(reorder=reorder, dtype=dtype)
    storage = RT.storage_from_jax(storage_np, model, dcfg, device="cpu")
    before = (rms_ops.launches, xent_ops.fwd_launches)
    loss, grads = par.loss_step()(storage, batch)
    assert (rms_ops.launches, xent_ops.fwd_launches) == before  # CPU: plain
    tol = TOL32 if dtype == torch.float32 else TOL
    np.testing.assert_allclose(float(loss), want_loss, **tol)
    got, want = named_leaves(grads), named_leaves(want_grads)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert any(n.startswith("blocks/s/") for n, _ in got)
    for (n, a), (_, b) in zip(got, want):
        assert float(np.abs(b).max()) > 0, n
        _close(a, b, f"reorder={reorder} {dtype} grad {n}", tol)


# ---------------------------------------------------------------------------
# Plans and the cost contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["none", "block", "auto", "auto_dp"])
def test_plans_and_exposure_equal_reference(mode):
    """SMOKE's blocks: groups, precisions and every field of
    exposed_comm_time exactly equal, at dp 1 and 8 x each wire precision
    x reorder on / off, priced with the reference's TPU v5e profile.  The
    joint precision DP (auto_dp with comm_precision auto) takes ~9 s a
    plan on each side over the superblock's 67 leaves: it runs once, at dp
    8 with the prefetch stack."""
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    precs = ("bf16", "fp8_ef", "auto")
    for dp, prec, reorder in itertools.product((1, 8), precs, (True, False)):
        if mode == "auto_dp" and prec == "auto" and (dp, reorder) != (
                8, True):
            continue
        case = (dp, prec, reorder)
        kw = dict(mesh_shape=(dp, 1), bucket_mode=mode, comm_precision=prec,
                  reorder=reorder)
        jd = JDistConfig(mesh_axes=("data", "model"), **kw)
        d = DistConfig(**kw)
        jshape = JShapeConfig("t", 16, max(4, dp), "train")
        shape = ShapeConfig("t", 16, max(4, dp), "train")
        jp = japi.plan_parallel(jmodel, jd, jshape)
        with hw.use_profile(hw.TPU_V5E):
            p = api.plan_parallel(model, d, shape)
            stats = model.block_stats(d, (max(4, dp) // dp, 16))
            got = aw.exposed_comm_time(p.bucket_plan("blocks"),
                                       model.block_metas(d), d, stats)
        jstats = jmodel.block_stats(jd, (max(4, dp) // dp, 16))
        want = jaw.exposed_comm_time(jp.bucket_plan("blocks"),
                                     jmodel.block_metas(jd), jd, jstats)
        assert p.bucket_plans["blocks"].groups == \
            jp.bucket_plans["blocks"].groups, case
        assert p.bucket_plans["blocks"].precisions == \
            jp.bucket_plans["blocks"].precisions, case
        for key in ("exposed_s", "exposed_comm_s", "total_comm_s",
                    "compute_s", "n_buckets", "comm_wire_bytes"):
            assert got[key] == want[key], (case, key)
        assert p.describe() == jp.describe(), case


def test_train_launcher_trains_xlstm_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq", "20", "--batch", "2",
                       "--dtype", "float32", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("plan: mesh[data=1xmodel=1]")
    losses = [float(l.split()[3]) for l in lines if l.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "step_00000002" / "params__blocks__s__R.npy").exists()


def test_unported_parts_raise():
    cfg, model = get_arch(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.stage_spec(2)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.init_state(2, DistConfig(mesh_shape=(1, 2)))
    with pytest.raises(NotImplementedError, match="tp=2"):
        api.parallelize(model, DistConfig(mesh_shape=(1, 2)),
                        ShapeConfig("t", S, B, "train"), device="cpu")
    with pytest.raises(ValueError, match="not xlstm"):
        X.XLSTMLM(get_arch("qwen3_1_7b", smoke=True)[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.parallelize(model, DistConfig(), ShapeConfig("t", S, B, "train"))
