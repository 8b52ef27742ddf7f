"""zamba2 serving parity: the PyTorch port against the JAX reference on the
CPU, on the SMOKE config (8 Mamba layers in 2 superblocks of 3 and a tail
of 2, the shared block after each superblock, SSD chunk 16).

  * `ref.ssd_step` (the decode's one-token recurrence) against the
    reference's, with and without D, at TOL32 (rtol 2e-4, atol 2e-5);
  * `ops.ssd_with_state` on the CPU, (y, the final state), against the
    reference's `ssd_chunked` at ragged T (40 at chunk 16, 300 at 128);
  * `prefill_local` at T 40 (a ragged last chunk): the logits and every
    leaf of the state (S, conv_x, conv_bc, the shared block's keys and
    values) against the reference's prefill step at TOL32, then 3
    `decode_local` steps (logits and the state after them) against its
    decode step; the prompt is padded as both launchers pad it, so every
    decode position lies inside the reference's prompt-length cache;
  * a bf16 prefill against the reference's bf16 prefill at TOL (2e-2);
  * prefill over p tokens into a cache of capacity p + 1, then one decode
    of token p at position p, against prefill over p + 1 tokens (p 32: the
    p + 1-th token opens a chunk), logits and state at TOL32.  The port
    only: the reference's cache is the prompt's length and its decode
    drops the write at position p;
  * the cache's leaves against the reference's `cache_abstract`; a KV
    codec raises (the reference's zamba cache ignores one);
  * `input_specs` for the serving kinds;
  * `launch.serve --arch zamba2_1_2b --smoke --device cpu` end to end (its
    `main`, in this process).

Weights come from a numpy seed in the reference's layout.  The reference
runs once per step kind (one fp32 prefill, one fp32 decode, one bf16
prefill), in module-scoped fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import single_device_config as jax_single_device_config
from repro.kernels.ssd import ref as jref
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.train import serve as JSV

from repro_torch.core.dist import single_device_config
from repro_torch.core.serving import pages as PG
from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref
from repro_torch.launch import serve as launch
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as SV

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "zamba2_1_2b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, PROMPT, GEN = 2, 37, 3
T = PROMPT + GEN                      # 40: chunks of 16, 16 and 8
STATE_KEYS = ("S", "conv_x", "conv_bc")
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _close(got, want, what, tol=TOL32):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _close_state(got, want, what, upto=None, tol=TOL32):
    """Every leaf of a zamba2 state; the keys and values to `upto`."""
    for k in STATE_KEYS:
        _close(got[k], want[k], f"{what} {k}", tol)
    assert len(got["sh_kv"]) == len(want["sh_kv"])
    for i, (g, w) in enumerate(zip(got["sh_kv"], want["sh_kv"])):
        for name, a, b in zip("kv", g, w):
            _close(a[:, :upto], b[:, :upto], f"{what} sh_kv[{i}] {name}", tol)


# ---------------------------------------------------------------------------
# The SSD entries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_d", [True, False])
def test_ssd_step_matches_reference(with_d):
    rng = np.random.default_rng(0)
    b, h, p, g, n = 3, 4, 8, 2, 6
    S = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = (0.4 * rng.standard_normal((2, b, g, n))).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32) if with_d \
        else None
    args = (S, x, dt, A, Bm, Cm)
    jS, jy = jref.ssd_step(*map(jnp.asarray, args),
                           D=None if D is None else jnp.asarray(D))
    tS, ty = ssd_ref.ssd_step(*map(torch.from_numpy, args),
                              D=None if D is None else torch.from_numpy(D))
    _close(tS, jS, "S")
    _close(ty, jy, "y")


@pytest.mark.parametrize("t,chunk", [(40, 16), (300, 128)])
def test_ssd_with_state_on_cpu_matches_reference(t, chunk):
    """(y, S) of the serving entry at a ragged last chunk: the padded rows
    carry dt = 0, so S is the state at the true T."""
    rng = np.random.default_rng(1)
    b, h, p, g, n = 2, 4, 16, 1, 8
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bc = (0.4 * rng.standard_normal((b, t, g, 2 * n))).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    args = (x, dt, A, bc[..., :n], bc[..., n:], D)
    jy, jS = jref.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, tS = ssd_ops.ssd_with_state(*map(torch.from_numpy, args),
                                    chunk=chunk)
    assert tuple(tS.shape) == (b, h, p, n) and tS.dtype == torch.float32
    _close(ty, jy, "y")
    _close(tS, jS, "S")


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------
def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return np.pad(rng.integers(3, cfg.vocab, (B, PROMPT)),
                  ((0, 0), (0, GEN)), constant_values=3)


def _numpy_params(seed=0):
    """Serve weights in the reference's layout from a numpy seed, at the
    scales of its init (`mamba_init`, `shared_init`): N(0, 1) times 0.02,
    0.01 for wo and wd, 0.02 / sqrt(2 L) for w_out and the head, 1 / sqrt(K)
    for the conv taps; norms and D 1 + 0.1 N(0, 1); A_log = log(1..H) and
    softplus(dt_bias) log-uniform in [1e-3, 1e-1]."""
    cfg, model = get_arch(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    sk = model.stacked_keys
    deep, conv = 0.02 / np.sqrt(2 * cfg.n_layers), 1 / np.sqrt(cfg.ssm_conv)
    scale = dict(wo=0.01, wd=0.01, w_out=deep, head=deep, conv_x=conv,
                 conv_bc=conv)

    def one(name, m, n):
        shape = (n, *m.global_shape) if n else tuple(m.global_shape)
        if name == "A_log":
            return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)), shape)
        if name == "dt_bias":
            return np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3),
                                                      np.log(1e-1), shape))))
        a = rng.standard_normal(shape)
        return 1 + 0.1 * a if len(m.global_shape) == 1 \
            else scale.get(name, 0.02) * a

    return {k: {n: one(n, m, sk.get(k)) for n, m in v.items()}
            if isinstance(v, dict) else one(k, v, sk.get(k))
            for k, v in model.metas(single_device_config()).items()}


def _reference(dtype, decode_steps):
    """The seeded serve params in `dtype` (as numpy fp32), the reference's
    prefill logits and state, and `decode_steps` greedy decode steps'
    (logits, state)."""
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=dtype,
                                    reduce_dtype=jnp.float32)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), _numpy_params())
    pf, mesh = JSV.make_prefill_step(jmodel, dcfg,
                                     JShapeConfig("p", T, B, "prefill"))
    tokens = _tokens(jcfg)
    logits, cache = pf(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    # the decode step donates its cache: each state is read out first
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    steps = [as_np((logits, cache))]
    if decode_steps:
        dec, _ = JSV.make_decode_step(jmodel, dcfg,
                                      JShapeConfig("d", T, B, "decode"),
                                      mesh=mesh)
        for i in range(decode_steps):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = dec(params, cache, tok,
                                jnp.full((B,), PROMPT + i, jnp.int32))
            steps.append(as_np((logits, cache)))
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return np_params, tokens, steps


def _port(np_params, dtype):
    _, model = get_arch(ARCH, smoke=True)
    dcfg = single_device_config(param_dtype=TORCH[dtype])
    params = SV.serve_params_from_jax(np_params, model, dcfg, device="cpu")
    pf = SV.make_prefill_step(model, dcfg, ShapeConfig("p", T, B, "prefill"))
    dec = SV.make_decode_step(model, dcfg, ShapeConfig("d", T, B, "decode"))
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
    return dict(got=got, want=want, model=model, dcfg=dcfg, params=params)


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
    assert cache["sh_kv"][0][0].dtype == torch.bfloat16
    _close(logits, want[0][0], "bf16 prefill logits", TOL)
    _close_state(cache, want[0][1], "bf16 prefill", tol=TOL)


def test_prefill_then_decode_equals_the_longer_prefill(fp32_run):
    """Prefill over p tokens into a cache of capacity p + 1 and one decode
    of token p at position p against prefill over p + 1 tokens: logits and
    every state leaf (keys and values over the p + 1 positions)."""
    model, dcfg, params = (fp32_run[k] for k in ("model", "dcfg", "params"))
    p = 32                      # two whole chunks; token p opens the third
    x = torch.from_numpy(_tokens(model.cfg, seed=2)[:, :p + 1])
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
    _close(got, want, "prefill p + decode vs prefill p + 1: logits")
    _close_state(cache, full, "prefill p + decode vs prefill p + 1")
    with pytest.raises(ValueError, match="a prompt of 34 tokens"):
        model.prefill_local(params, {"tokens": torch.zeros((B, p + 2),
                                                           dtype=torch.int64)},
                            dcfg, SV.alloc_cache(model, shape, dcfg, "cpu"))


# ---------------------------------------------------------------------------
# Layout, specs, launcher
# ---------------------------------------------------------------------------
def test_cache_layout_matches_reference():
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jabs, _ = JSV.cache_abstract(
            jmodel, JShapeConfig("d", T, B, "decode"),
            jax_single_device_config(param_dtype=jdt))
        dcfg = single_device_config(param_dtype=dt)
        got = SV.cache_abstract(model, ShapeConfig("d", T, B, "decode"), dcfg)
        assert set(got) == set(jabs)
        for k in STATE_KEYS:
            assert (tuple(got[k].shape), got[k].dtype) == (
                jabs[k].shape, torch.float32), k
        assert len(got["sh_kv"]) == len(jabs["sh_kv"]) == model.n_super
        for pair, jpair in zip(got["sh_kv"], jabs["sh_kv"]):
            for a, b in zip(pair, jpair):
                assert (tuple(a.shape), a.dtype) == (b.shape, TORCH[jdt])
        cache = SV.alloc_cache(model, ShapeConfig("d", T, B, "decode"),
                               dcfg, "cpu")
        assert all(float(a.abs().sum()) == 0 for a in PG.kv_leaves(cache))
    for codec in ("int8", "fp8"):
        with pytest.raises(ValueError, match="no KV codec"):
            SV.cache_abstract(model, ShapeConfig("d", T, B, "decode"),
                              single_device_config(kv_cache_codec=codec))


def test_serving_input_specs_match_reference():
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    for kind in ("prefill", "decode"):
        got = model.input_specs(ShapeConfig("s", T, B, kind),
                                single_device_config())
        want = jmodel.input_specs(JShapeConfig("s", T, B, kind),
                                  jax_single_device_config())
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}


def test_serve_launcher_serves_zamba2_on_cpu(capsys):
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated:")
    assert any(l.startswith("steady:") for l in lines)
