"""xlstm serving parity: the PyTorch port against the JAX reference on the
CPU, on the SMOKE config (one superblock of 3 mLSTM blocks and 1 sLSTM
block, mLSTM chunk 16).

  * `prefill_local` at T 40 (a ragged last chunk): the logits and every
    leaf of the state (each mLSTM's C, n, m and conv state, the sLSTM's h,
    c, n, m) against the reference's prefill step at TOL32 (rtol 2e-4, atol
    2e-5), then 3 `decode_local` steps (logits and the state after them)
    against its decode step;
  * a bf16 prefill against the reference's bf16 prefill at TOL (2e-2), its
    logits also within BF16_LOGITS_REL of their RMS;
  * prefill over p tokens and one decode of token p against prefill over p
    + 1 tokens, in the port (p 32: token p opens a chunk; p 36: both
    prefills end in ragged chunks) and in the reference (its own serving
    test compares nothing): logits, the conv and sLSTM states, and the
    mLSTM state in true units (C e^m, n e^m), since the pads of a ragged
    chunk may raise the stabilizer m;
  * the cache's leaves against the reference's `cache_abstract`; a KV
    codec and the paged step raise;
  * each cell (`mlstm_chunked`, `mlstm_step`, `slstm_seq`) on bf16 inputs
    against the same values in fp32, bit for bit: the cells widen first;
  * `launch.serve --arch xlstm_1_3b --smoke --device cpu` end to end (its
    `main`, in this process).

Weights come from a numpy seed in the reference's layout, at its init's
scales (w_if at 0.1 instead of 0.005, so that the gates vary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import single_device_config as jax_single_device_config
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.train import serve as JSV

from repro_torch.core.dist import single_device_config
from repro_torch.core.serving import pages as PG
from repro_torch.launch import serve as launch
from repro_torch.models import xlstm as X
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.models.xlstm import MLSTM_STATE, SLSTM_STATE
from repro_torch.train import serve as SV

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "xlstm_1_3b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
# the bf16 prefill's logits against the reference's, max abs err over the
# reference logits' RMS (~0.057, so TOL's atol alone allows ~0.35 of it).
# Both run in bf16 and differ in the order of their roundings: these
# weights read 1.18e-3, weights from numpy seeds 1-3 up to 6.9e-3
BF16_LOGITS_REL = 1e-2
B, PROMPT, GEN = 2, 37, 3
T = PROMPT + GEN                      # 40: chunks of 16, 16 and 8
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _close(got, want, what, tol=TOL32):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _subs(state):
    return sorted(state)


def _close_state(got, want, what, tol=TOL32, true_units=False):
    """Every leaf of an xlstm state; with `true_units` the mLSTM's C and n
    times e^m instead of C, n and m."""
    assert _subs(got) == _subs(want)
    for sub in _subs(got):
        g, w = got[sub], want[sub]
        if sub == "s":
            for k in SLSTM_STATE:
                _close(g[k], w[k], f"{what} {sub}.{k}", tol)
            continue
        _close(g["conv"], w["conv"], f"{what} {sub}.conv", tol)
        if not true_units:
            for k in ("C", "n", "m"):
                _close(g[k], w[k], f"{what} {sub}.{k}", tol)
            continue
        ge, we = np.exp(_np(g["m"])), np.exp(_np(w["m"]))
        _close(_np(g["C"]) * ge[..., None, None],
               _np(w["C"]) * we[..., None, None], f"{what} {sub}.C e^m", tol)
        _close(_np(g["n"]) * ge[..., None], _np(w["n"]) * we[..., None],
               f"{what} {sub}.n e^m", tol)


def _tokens(cfg, seed=0, prompt=PROMPT, gen=GEN):
    rng = np.random.default_rng(seed)
    return np.pad(rng.integers(3, cfg.vocab, (B, prompt)),
                  ((0, 0), (0, gen)), constant_values=3)


def _numpy_params(seed=0):
    """Serve weights in the reference's layout from a numpy seed, at the
    scales of its init: N(0, 1) times 0.02, 0.02 / sqrt(2 L) for w_out and
    the head, 1 / sqrt(K) for the conv taps, 1 / sqrt(hd) for R, 0.1 for
    w_if; norms 1 + 0.1 N(0, 1)."""
    cfg, model = get_arch(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    sk = model.stacked_keys
    deep = 0.02 / np.sqrt(2 * cfg.n_layers)
    scale = dict(w_out=deep, head=deep, conv=1 / np.sqrt(cfg.ssm_conv),
                 R=1 / np.sqrt(cfg.d_model // cfg.n_heads), w_if=0.1)

    def tree(metas, n):
        if not hasattr(metas, "global_shape"):
            return {k: tree(v, n) for k, v in metas.items()}
        shape = (n, *metas.global_shape) if n else tuple(metas.global_shape)
        a = rng.standard_normal(shape)
        return 1 + 0.1 * a if len(metas.global_shape) == 1 \
            else scale.get(metas.name.split(".")[-1], 0.02) * a

    return {k: tree(v, sk.get(k))
            for k, v in model.metas(single_device_config()).items()}


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(dtype, decode_steps, tokens=None):
    """The seeded serve params in `dtype` (as numpy fp32), the tokens, and
    the reference's prefill (logits, state) followed by `decode_steps`
    greedy decode steps' (logits, state)."""
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=dtype,
                                    reduce_dtype=jnp.float32)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), _numpy_params())
    tokens = _tokens(jcfg) if tokens is None else tokens
    t = tokens.shape[1]
    pf, mesh = JSV.make_prefill_step(jmodel, dcfg,
                                     JShapeConfig("p", t, B, "prefill"))
    logits, cache = pf(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    # the decode step donates its cache: each state is read out first
    steps = [_as_np((logits, cache))]
    if decode_steps:
        dec, _ = JSV.make_decode_step(jmodel, dcfg,
                                      JShapeConfig("d", t, B, "decode"),
                                      mesh=mesh)
        for i in range(decode_steps):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = dec(params, cache, tok,
                                jnp.full((B,), PROMPT + i, jnp.int32))
            steps.append(_as_np((logits, cache)))
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return np_params, tokens, steps


def _port(np_params, dtype, t=T):
    _, model = get_arch(ARCH, smoke=True)
    dcfg = single_device_config(param_dtype=TORCH[dtype])
    params = SV.serve_params_from_jax(np_params, model, dcfg, device="cpu")
    pf = SV.make_prefill_step(model, dcfg, ShapeConfig("p", t, B, "prefill"))
    dec = SV.make_decode_step(model, dcfg, ShapeConfig("d", t, B, "decode"))
    return model, dcfg, params, pf, dec


@pytest.fixture(scope="module")
def fp32_run():
    """The reference's and the port's fp32 prefill and 3 decode steps."""
    np_params, tokens, want = _reference(jnp.float32, 3)
    model, dcfg, params, pf, dec = _port(np_params, jnp.float32)
    logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)})
    got = [(logits, PG.kv_map(torch.clone, cache))]
    for i in range(3):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int64)
        logits, cache = dec(params, cache, logits.argmax(-1), pos)
        got.append((logits, PG.kv_map(torch.clone, cache)))
    return dict(got=got, want=want, model=model, dcfg=dcfg, params=params,
                np_params=np_params)


def test_prefill_matches_reference(fp32_run):
    (logits, cache), (jlogits, jcache) = fp32_run["got"][0], \
        fp32_run["want"][0]
    assert logits.shape == (B, get_arch(ARCH, smoke=True)[0].vocab)
    _close(logits, jlogits, "prefill logits")
    _close_state(cache, jcache, "prefill")


def test_decode_steps_match_reference(fp32_run):
    for i, ((logits, cache), (jlogits, jcache)) in enumerate(
            zip(fp32_run["got"][1:], fp32_run["want"][1:])):
        assert np.array_equal(
            fp32_run["got"][i][0].argmax(-1).numpy(),
            np.asarray(jnp.argmax(fp32_run["want"][i][0], -1))), i
        _close(logits, jlogits, f"decode {i} logits")
        _close_state(cache, jcache, f"decode {i}")


def test_bf16_prefill_matches_reference():
    np_params, tokens, want = _reference(jnp.bfloat16, 0)
    _, _, params, pf, _ = _port(np_params, jnp.bfloat16)
    logits, cache = pf(params, {"tokens": torch.from_numpy(tokens)})
    assert all(a.dtype == torch.float32 for a in PG.kv_leaves(cache))
    _close(logits, want[0][0], "bf16 prefill logits", TOL)
    got, ref = _np(logits), _np(want[0][0])
    rms = np.sqrt(np.mean(ref ** 2))
    assert np.abs(got - ref).max() <= BF16_LOGITS_REL * rms
    _close_state(cache, want[0][1], "bf16 prefill", tol=TOL)


@pytest.mark.parametrize("p", [32, 36])
def test_prefill_then_decode_equals_the_longer_prefill(fp32_run, p):
    """Prefill over p tokens and one decode of token p against prefill over
    p + 1 tokens: logits and every state leaf, the mLSTM's in true
    units."""
    model, dcfg, params = (fp32_run[k] for k in ("model", "dcfg", "params"))
    x = torch.from_numpy(_tokens(model.cfg, seed=2, prompt=p + 1, gen=0))
    shape = ShapeConfig("p", p + 1, B, "prefill")
    with torch.inference_mode():
        want, full = model.prefill_local(
            params, {"tokens": x}, dcfg, SV.alloc_cache(model, shape, dcfg,
                                                        "cpu"))
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :p]}, dcfg,
            SV.alloc_cache(model, shape, dcfg, "cpu"))
        got, cache = model.decode_local(params, cache, x[:, p],
                                        torch.full((B,), p), dcfg)
    _close(got, want, f"p {p}: prefill p + decode vs prefill p + 1 logits")
    _close_state(cache, full, f"p {p}: prefill p + decode vs prefill p + 1",
                 true_units=True)


def test_reference_prefill_then_decode_equals_its_longer_prefill(fp32_run):
    """The reference's own steps pass the same check at p = 36 (its serving
    test, tests/test_models_smoke.py, asserts only shapes and
    finiteness)."""
    jcfg, _ = jax_get_arch(ARCH, smoke=True)
    p = 36
    x = _tokens(jcfg, seed=2, prompt=p + 1, gen=0)
    _, _, (want,) = _reference(jnp.float32, 0, tokens=x)
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=jnp.float32,
                                    reduce_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, fp32_run["np_params"])
    pf, mesh = JSV.make_prefill_step(jmodel, dcfg,
                                     JShapeConfig("p", p, B, "prefill"))
    _, cache = pf(params, {"tokens": jnp.asarray(x[:, :p], jnp.int32)})
    dec, _ = JSV.make_decode_step(jmodel, dcfg,
                                  JShapeConfig("d", p, B, "decode"),
                                  mesh=mesh)
    got, cache = dec(params, cache, jnp.asarray(x[:, p], jnp.int32),
                     jnp.full((B,), p, jnp.int32))
    _close(np.asarray(got), want[0], "reference: prefill p + decode vs "
           "prefill p + 1 logits")
    _close_state(_as_np(cache), want[1], "reference: prefill p + decode vs "
                 "prefill p + 1", true_units=True)


def _cell_args(cell):
    """(bf16 inputs, fp32 state) of one call of `cell`, from a seed."""
    rng = np.random.default_rng(7)
    b, t, h, d = 2, 37, 2, 8

    def bf16(*shape, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) + shift).bfloat16()

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    if cell == "slstm_seq":
        return (bf16(b, t, 4, h, d) * 2, bf16(4, h, d, d) / np.sqrt(d)), \
            (f32(b, h, d), f32(b, h, d), 1 + f32(b, h, d).abs(),
             f32(b, h, d))
    state = (f32(b, h, d, d), f32(b, h, d), f32(b, h))
    if cell == "mlstm_step":
        return (bf16(b, h, d), bf16(b, h, d), bf16(b, h, d), bf16(b, h),
                bf16(b, h, shift=3.0)), state
    return (bf16(b, t, h, d), bf16(b, t, h, d), bf16(b, t, h, d),
            bf16(b, t, h), bf16(b, t, h, shift=3.0)), state


@pytest.mark.parametrize("cell", ["mlstm_chunked", "mlstm_step",
                                  "slstm_seq"])
def test_cells_compute_in_fp32_on_bf16_inputs(cell):
    """Each cell widens its bf16 inputs to fp32 before any arithmetic, as
    the reference's does: its fp32 results (the state; slstm_seq's hs) on
    bf16 inputs equal, bit for bit, its results on the same values given
    in fp32.  A cast left out (a gate, q, k, v or R computed on in bf16)
    breaks the equality where it stays within a bf16 tolerance of the
    reference."""
    fn = getattr(X, cell)
    args, state = _cell_args(cell)
    wide = [a.float() for a in args]
    if cell == "mlstm_step":
        got, want = fn(state, *args), fn(state, *wide)
    elif cell == "mlstm_chunked":
        got = fn(*args, chunk=16, state=state)
        want = fn(*wide, chunk=16, state=state)
    else:
        got, want = fn(*args, state), fn(*wide, state)

    def leaves(a):
        return [a] if torch.is_tensor(a) else [t for x in a
                                                for t in leaves(x)]

    pairs = [(g, w) for g, w in zip(leaves(got), leaves(want))
             if g.dtype == torch.float32]
    assert len(pairs) == {"mlstm_chunked": 3, "mlstm_step": 3,
                          "slstm_seq": 5}[cell]
    for i, (g, w) in enumerate(pairs):
        assert torch.equal(g, w), (cell, i, (g - w).abs().max().item())


def test_cache_layout_matches_reference():
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    jabs, _ = JSV.cache_abstract(jmodel, JShapeConfig("d", T, B, "decode"),
                                 jax_single_device_config())
    dcfg = single_device_config()
    got = SV.cache_abstract(model, ShapeConfig("d", T, B, "decode"), dcfg)
    assert _subs(got) == _subs(jabs) == ["m0", "m1", "m2", "s"]
    for sub in got:
        assert set(got[sub]) == set(jabs[sub]) == set(
            SLSTM_STATE if sub == "s" else MLSTM_STATE)
        for k, a in got[sub].items():
            assert (tuple(a.shape), a.dtype) == (
                jabs[sub][k].shape, torch.float32), (sub, k)
    cache = SV.alloc_cache(model, ShapeConfig("d", T, B, "decode"), dcfg,
                           "cpu")
    assert all(float(a.abs().sum()) == 0 for a in PG.kv_leaves(cache))
    for codec in ("int8", "fp8"):
        with pytest.raises(ValueError, match="no KV codec"):
            SV.cache_abstract(model, ShapeConfig("d", T, B, "decode"),
                              single_device_config(kv_cache_codec=codec))
    with pytest.raises(ValueError, match="no paged decode path"):
        SV.make_paged_step(model, dcfg, ShapeConfig("d", T, B, "decode"),
                           page=4, n_pages_local=8, max_pages=10)


def test_serve_launcher_serves_xlstm_on_cpu(capsys):
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated:")
    assert any(l.startswith("steady:") for l in lines)
    with pytest.raises(ValueError, match="no KV codec"):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--int8-kv"])
