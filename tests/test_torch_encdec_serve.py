"""encdec serving parity: the PyTorch port against the JAX reference on the
CPU, on seamless-m4t-large-v2's SMOKE config (2 encoder and 2 decoder
layers).

  * `prefill_local` over a padded 20-token prompt (T 20, the frames S_src =
    T // 2 = 10): the logits, the self cache (keys after RoPE, values) and
    the cross cache (the memory's keys and values, every decoder layer)
    against the reference's prefill step at TOL32 (rtol 2e-4, atol 2e-5),
    then 3 `decode_local` steps (logits and both caches) against its decode
    step; the prompt is padded as both launchers pad it, so every decode
    position lies inside the reference's prompt-length self cache;
  * a ragged decode step (each row at its own position) against the
    reference's;
  * a bf16 prefill against the reference's bf16 prefill at TOL (2e-2);
  * prefill over p tokens into a self cache of capacity p + 1, then one
    decode of token p at position p, against prefill over p + 1 tokens
    with the same frames, logits and both caches at TOL32; a decode from a
    cache whose self keys and values at p - 1 were dropped, and one whose
    cross cache holds the decoder's keys in place of the memory's, must
    fail it.  The port only: the reference's self cache is the prompt's
    length and its decode drops the write at position p;
  * the cache's leaves against the reference's `cache_abstract`; a KV
    codec raises (the reference's encdec cache ignores one); the prefill
    step rejects frames and tokens of the wrong shape;
  * `launch.serve --arch seamless_m4t_large_v2 --smoke --device cpu` end
    to end, with its seeded frames.

Weights come from a numpy seed in the reference's layout; the frames from
a numpy seed at 0.3 x N(0, 1).  The reference runs once per step kind (one
fp32 prefill, four fp32 decodes, one bf16 prefill), in module-scoped
fixtures.
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
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as launch
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as SV

ARCH = "seamless_m4t_large_v2"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, PROMPT, GEN = 2, 17, 3
T = PROMPT + GEN                      # 20 target tokens, 10 frames
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _close(got, want, what, tol=TOL32):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _close_cache(got, want, what, tol=TOL32):
    """Both caches: (k, v) of the self cache, (k, v) of the cross cache."""
    assert set(got) == set(want) == {"self", "cross"}
    for part in ("self", "cross"):
        for name, a, b in zip("kv", got[part], want[part]):
            _close(a, b, f"{what} {part} {name}", tol)


def _inputs(cfg, t=T, seed=0):
    """(tokens (B, t) int: a random prompt padded with token 3 to t, frames
    (B, t // 2, frontend_dim) fp32)."""
    rng = np.random.default_rng(seed)
    prompt = min(PROMPT, t)
    tokens = np.pad(rng.integers(3, cfg.vocab, (B, prompt)),
                    ((0, 0), (0, t - prompt)), constant_values=3)
    frames = (0.3 * rng.standard_normal((B, t // 2, cfg.frontend_dim))
              ).astype(np.float32)
    return tokens, frames


def _numpy_params(seed=0):
    """Serve weights in the reference's layout from a numpy seed at its
    init's scales: N(0, 1) x 0.02, wo / wd / head x 0.02 / sqrt(2 L),
    norms 1 + 0.1 N(0, 1)."""
    cfg, model = get_arch(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    deep = 0.02 / np.sqrt(2 * cfg.n_layers)
    sk = model.stacked_keys

    def tree(metas, n):
        if isinstance(metas, dict):
            return {k: tree(v, n) for k, v in metas.items()}
        shape = (n, *metas.global_shape) if n else tuple(metas.global_shape)
        a = rng.standard_normal(shape)
        key = metas.name.split(".")[-1]
        return 1 + 0.1 * a if len(metas.global_shape) == 1 else \
            (deep if key in ("wo", "wd", "head") else 0.02) * a

    return {k: tree(v, sk.get(k))
            for k, v in model.metas(single_device_config()).items()}


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(dtype, decode_steps):
    """The seeded serve params in `dtype` (as numpy fp32), the inputs, the
    reference's prefill (logits, cache), `decode_steps` greedy decode
    steps' and one ragged step's."""
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=dtype,
                                    reduce_dtype=jnp.float32)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), _numpy_params())
    pf, mesh = JSV.make_prefill_step(jmodel, dcfg,
                                     JShapeConfig("p", T, B, "prefill"))
    tokens, frames = _inputs(jcfg)
    logits, cache = pf(params, {"tokens": jnp.asarray(tokens, jnp.int32),
                                "frames": jnp.asarray(frames)})
    # the decode step donates its cache: each is read out first
    steps = [_as_np((logits, cache))]
    if decode_steps:
        dec, _ = JSV.make_decode_step(jmodel, dcfg,
                                      JShapeConfig("d", T, B, "decode"),
                                      mesh=mesh)
        for i in range(decode_steps):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = dec(params, cache, tok,
                                jnp.full((B,), PROMPT + i, jnp.int32))
            steps.append(_as_np((logits, cache)))
        # ragged: row 0 at the last slot, row 1 back at the prompt's end
        logits, cache = dec(params, cache, jnp.asarray([5, 7], jnp.int32),
                            jnp.asarray([T - 1, PROMPT], jnp.int32))
        steps.append(_as_np((logits, cache)))
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return np_params, (tokens, frames), steps


def _port(np_params, dtype, t=T):
    _, model = get_arch(ARCH, smoke=True)
    dcfg = single_device_config(param_dtype=TORCH[dtype])
    params = SV.serve_params_from_jax(np_params, model, dcfg, device="cpu")
    pf = SV.make_prefill_step(model, dcfg, ShapeConfig("p", t, B, "prefill"))
    dec = SV.make_decode_step(model, dcfg, ShapeConfig("d", t, B, "decode"))
    return model, dcfg, params, pf, dec


def _batch(tokens, frames):
    return {"tokens": torch.from_numpy(tokens),
            "frames": torch.from_numpy(frames)}


@pytest.fixture(scope="module")
def fp32_run():
    """The reference's and the port's fp32 prefill, 3 decode steps and a
    ragged one."""
    np_params, inputs, want = _reference(jnp.float32, 3)
    model, dcfg, params, pf, dec = _port(np_params, jnp.float32)
    n = flash_ops.launches, flash_ops.launches_f32
    logits, cache = pf(params, _batch(*inputs))
    assert (flash_ops.launches, flash_ops.launches_f32) == n  # CPU: plain
    got = [(logits, PG.kv_map(torch.clone, cache))]
    for i in range(3):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int64)
        logits, cache = dec(params, cache, logits.argmax(-1), pos)
        got.append((logits, PG.kv_map(torch.clone, cache)))
    logits, cache = dec(params, cache, torch.tensor([5, 7]),
                        torch.tensor([T - 1, PROMPT]))
    got.append((logits, PG.kv_map(torch.clone, cache)))
    return dict(got=got, want=want, model=model, dcfg=dcfg, params=params,
                inputs=inputs)


def test_prefill_matches_reference(fp32_run):
    (logits, cache), (jlogits, jcache) = fp32_run["got"][0], \
        fp32_run["want"][0]
    cfg = fp32_run["model"].cfg
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    assert cache["self"][0].shape == (2, B, T, 4, 16)
    assert cache["cross"][0].shape == (2, B, T // 2, 4, 16)
    _close(logits, jlogits, "prefill logits")
    _close_cache(cache, jcache, "prefill")


def test_decode_steps_match_reference(fp32_run):
    for i, ((logits, cache), (jlogits, jcache)) in enumerate(
            zip(fp32_run["got"][1:4], fp32_run["want"][1:4])):
        assert np.array_equal(
            fp32_run["got"][i][0].argmax(-1).numpy(),
            np.asarray(jnp.argmax(fp32_run["want"][i][0], -1))), i
        _close(logits, jlogits, f"decode {i} logits")
        _close_cache(cache, jcache, f"decode {i}")


def test_ragged_decode_step_matches_reference(fp32_run):
    """Rows at positions T - 1 and PROMPT: each writes its own slot and
    attends to its own prefix."""
    (logits, cache), (jlogits, jcache) = fp32_run["got"][4], \
        fp32_run["want"][4]
    _close(logits, jlogits, "ragged decode logits")
    _close_cache(cache, jcache, "ragged decode")


def test_bf16_prefill_matches_reference():
    np_params, inputs, want = _reference(jnp.bfloat16, 0)
    _, _, params, pf, _ = _port(np_params, jnp.bfloat16)
    logits, cache = pf(params, _batch(*inputs))
    assert all(a.dtype == torch.bfloat16 for a in PG.kv_leaves(cache))
    _close(logits, want[0][0], "bf16 prefill logits", TOL)
    _close_cache(cache, want[0][1], "bf16 prefill", TOL)


def _p1(model, dcfg, params, x, frames, plant=None):
    """Prefill over x (B, p + 1) against prefill over x[:, :p] into a cache
    of capacity p + 1 and one decode of x[:, p] at p, the same frames.
    Returns (want logits, want cache, got logits, got cache)."""
    b, t = x.shape
    shape = ShapeConfig("p", t, b, "prefill")
    pos = torch.full((b,), t - 1, dtype=torch.int64)
    with torch.inference_mode():
        want, full = model.prefill_local(
            params, {"tokens": x, "frames": frames}, dcfg,
            SV.alloc_cache(model, shape, dcfg, "cpu"))
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :-1], "frames": frames}, dcfg,
            SV.alloc_cache(model, shape, dcfg, "cpu"))
        if plant == "cross from the decoder":
            for i in range(model.n_dec):     # the self cache's first keys
                for a, b_ in zip(cache["cross"], cache["self"]):
                    a[i].copy_(b_[i, :, :a.shape[2]])
        if plant == "the prefill's last self write dropped":
            for a in cache["self"]:
                a[:, :, t - 2].zero_()
        got, cache = model.decode_local(params, cache, x[:, -1], pos, dcfg)
    return want, full, got, cache


def test_prefill_then_decode_equals_the_longer_prefill(fp32_run):
    """p 19: the self cache's capacity is p + 1 = 20, the frames 10.  Two
    planted faults must fail the logits' check: the prefill's self keys
    and values at p - 1 dropped, and the cross cache built from the
    decoder's self keys in place of the memory's."""
    model, dcfg, params = (fp32_run[k] for k in ("model", "dcfg", "params"))
    tokens, frames = _inputs(model.cfg, t=T, seed=2)
    x, fr = torch.from_numpy(tokens), torch.from_numpy(frames)
    want, full, got, cache = _p1(model, dcfg, params, x, fr)
    _close(got, want, "prefill p + decode vs prefill p + 1: logits")
    _close_cache(cache, full, "prefill p + decode vs prefill p + 1")
    for plant in ("the prefill's last self write dropped",
                  "cross from the decoder"):
        _, _, bad, _ = _p1(model, dcfg, params, x, fr, plant=plant)
        assert not np.allclose(_np(bad), _np(want), **TOL32), plant
    with pytest.raises(ValueError, match="self cache"):
        model.prefill_local(
            params, {"tokens": torch.zeros((B, T + 1), dtype=torch.int64),
                     "frames": fr}, dcfg,
            SV.alloc_cache(model, ShapeConfig("p", T, B, "prefill"), dcfg,
                           "cpu"))


# ---------------------------------------------------------------------------
# Layout, step shapes, launcher
# ---------------------------------------------------------------------------
def test_cache_layout_matches_reference():
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jabs, _ = JSV.cache_abstract(
            jmodel, JShapeConfig("d", T, B, "decode"),
            jax_single_device_config(param_dtype=jdt))
        dcfg = single_device_config(param_dtype=dt)
        got = SV.cache_abstract(model, ShapeConfig("d", T, B, "decode"), dcfg)
        assert set(got) == set(jabs) == {"self", "cross"}
        for part in ("self", "cross"):
            for a, b in zip(got[part], jabs[part]):
                assert (tuple(a.shape), a.dtype) == (b.shape, TORCH[jdt])
        cache = SV.alloc_cache(model, ShapeConfig("d", T, B, "decode"),
                               dcfg, "cpu")
        leaves = PG.kv_leaves(cache)
        assert len({a.data_ptr() for a in leaves}) == 4
        assert all(float(a.abs().sum()) == 0 for a in leaves)
    for codec in ("int8", "fp8"):
        with pytest.raises(ValueError, match="no KV codec"):
            SV.cache_abstract(model, ShapeConfig("d", T, B, "decode"),
                              single_device_config(kv_cache_codec=codec))
    with pytest.raises(ValueError, match="no paged decode path"):
        SV.make_paged_step(model, single_device_config(),
                           ShapeConfig("d", T, B, "decode"), page=4,
                           n_pages_local=8, max_pages=5)


def test_prefill_step_checks_the_batch_shapes(fp32_run):
    model, dcfg, params = (fp32_run[k] for k in ("model", "dcfg", "params"))
    pf = SV.make_prefill_step(model, dcfg, ShapeConfig("p", T, B, "prefill"))
    tokens, frames = fp32_run["inputs"]
    for bad in ({"tokens": torch.from_numpy(tokens)},
                _batch(tokens, frames[:, :-1]),
                _batch(tokens[:, :-1], frames)):
        with pytest.raises(ValueError, match="step built for"):
            pf(params, bad)


def test_serve_launcher_serves_encdec_on_cpu(capsys):
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated:")
    assert any(l.startswith("steady:") for l in lines)
    cfg, model = get_arch(ARCH, smoke=True)
    fr = launch.make_frames(model, single_device_config(), 4, 27, "cpu")
    assert tuple(fr.shape) == (4, 13, cfg.frontend_dim)
    assert fr.dtype == torch.float32
