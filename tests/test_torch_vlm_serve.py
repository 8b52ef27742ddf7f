"""vlm serving parity: the PyTorch port against the JAX reference on the
CPU, on internvl2-26b's SMOKE config (2 layers, 8 image tokens of 48).

  * `prefill_local` over 8 image embeddings and a padded 20-token text
    prompt (a cell of 28 positions, the images first): the logits and the
    cache (keys after RoPE over the whole sequence, values) against the
    reference's prefill step at TOL32 (rtol 2e-4, atol 2e-5), then 3
    `decode_local` steps at positions 8 + 17, 8 + 18, 8 + 19 (logits and
    cache) against its decode step on the same cache;
  * a ragged decode step (each row at its own position) against the
    reference's;
  * a bf16 prefill against the reference's bf16 prefill at TOL (2e-2): the
    projector runs in bf16 on fp32 images in both, its output cast to the
    text embedding's dtype;
  * prefill over p text tokens into a cache of capacity 8 + p + 1, then one
    decode of token p at position 8 + p, against prefill over p + 1 text
    tokens, the same images, logits and cache at TOL32; the decode at p,
    the reference launcher's position (no image offset), must fail it;
  * the int8 and fp8 KV caches: prefill and decode against the
    reference's under the same codec;
  * the cache's leaves against the reference's `cache_abstract` (bf16,
    fp32, int8, fp8); the paged step and `plan_serve` raise; the prefill
    step rejects images and tokens of the wrong shape;
  * `launch.serve --arch internvl2_26b --smoke --device cpu` end to end,
    with its seeded image embeddings, decoding from position 8 + prompt.

Weights come from a numpy seed in the reference's layout; the image
embeddings from a numpy seed at 0.3 x N(0, 1).  The reference runs once
per step kind, in module-scoped fixtures.
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
from repro_torch.core.serving.scheduler import plan_serve
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as launch
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as SV

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

ARCH = "internvl2_26b"
TOL32 = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=2e-2, atol=2e-2)
B, PROMPT, GEN, N_IMG, VIT = 2, 17, 3, 8, 48
T = PROMPT + GEN                      # 20 text tokens
CELL = N_IMG + T                      # 28 positions, the images first
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _close(got, want, what, tol=TOL32):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _close_cache(got, want, what, tol=TOL32):
    for name, a, b in zip("kv", got, want):
        _close(a, b, f"{what} {name}", tol)


def _inputs(cfg, t=T, seed=0):
    """(tokens (B, t) int: a random prompt padded with token 3 to t, image
    embeddings (B, 8, 48) fp32)."""
    rng = np.random.default_rng(seed)
    prompt = min(PROMPT, t)
    tokens = np.pad(rng.integers(3, cfg.vocab, (B, prompt)),
                    ((0, 0), (0, t - prompt)), constant_values=3)
    img = (0.3 * rng.standard_normal((B, N_IMG, VIT))).astype(np.float32)
    return tokens, img


def _numpy_params(seed=0):
    """Serve weights in the reference's layout from a numpy seed at its
    init's scales: N(0, 1) x 0.02 (the projector too), wo / wd / head x
    0.02 / sqrt(2 L), norms 1 + 0.1 N(0, 1)."""
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


def _jbatch(tokens, img):
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            "img_embeds": jnp.asarray(img)}


def _batch(tokens, img):
    return {"tokens": torch.from_numpy(tokens),
            "img_embeds": torch.from_numpy(img)}


def _reference(dtype, decode_steps, codec=None):
    """The seeded serve params in `dtype` (as numpy fp32), the inputs, the
    reference's prefill (logits, cache), `decode_steps` greedy decode
    steps' from position 8 + PROMPT and one ragged step's."""
    jcfg, jmodel = jax_get_arch(ARCH, smoke=True)
    dcfg = jax_single_device_config(param_dtype=dtype,
                                    reduce_dtype=jnp.float32,
                                    kv_cache_codec=codec)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), _numpy_params())
    pf, mesh = JSV.make_prefill_step(jmodel, dcfg,
                                     JShapeConfig("p", CELL, B, "prefill"))
    inputs = _inputs(jcfg)
    logits, cache = pf(params, _jbatch(*inputs))
    # the decode step donates its cache: each is read out first
    steps = [_as_np((logits, cache))]
    if decode_steps:
        dec, _ = JSV.make_decode_step(jmodel, dcfg,
                                      JShapeConfig("d", CELL, B, "decode"),
                                      mesh=mesh)
        for i in range(decode_steps):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = dec(params, cache, tok,
                                jnp.full((B,), N_IMG + PROMPT + i,
                                         jnp.int32))
            steps.append(_as_np((logits, cache)))
        if codec is None:
            # ragged: row 0 at the last slot, row 1 back at the prompt's end
            logits, cache = dec(params, cache, jnp.asarray([5, 7], jnp.int32),
                                jnp.asarray([CELL - 1, N_IMG + PROMPT],
                                            jnp.int32))
            steps.append(_as_np((logits, cache)))
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return np_params, inputs, steps


def _port(np_params, dtype, codec=None):
    _, model = get_arch(ARCH, smoke=True)
    dcfg = single_device_config(param_dtype=TORCH[dtype],
                                kv_cache_codec=codec)
    params = SV.serve_params_from_jax(np_params, model, dcfg, device="cpu")
    pf = SV.make_prefill_step(model, dcfg, ShapeConfig("p", CELL, B,
                                                       "prefill"))
    dec = SV.make_decode_step(model, dcfg, ShapeConfig("d", CELL, B,
                                                       "decode"))
    return model, dcfg, params, pf, dec


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
        pos = torch.full((B,), N_IMG + PROMPT + i, dtype=torch.int64)
        logits, cache = dec(params, cache, logits.argmax(-1), pos)
        got.append((logits, PG.kv_map(torch.clone, cache)))
    logits, cache = dec(params, cache, torch.tensor([5, 7]),
                        torch.tensor([CELL - 1, N_IMG + PROMPT]))
    got.append((logits, PG.kv_map(torch.clone, cache)))
    return dict(got=got, want=want, model=model, dcfg=dcfg, params=params,
                inputs=inputs)


def test_prefill_matches_reference(fp32_run):
    (logits, cache), (jlogits, jcache) = fp32_run["got"][0], \
        fp32_run["want"][0]
    cfg = fp32_run["model"].cfg
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    assert cache[0].shape == (2, B, CELL, 2, 16)
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
    """Rows at positions 8 + 19 and 8 + 17: each writes its own slot and
    attends to its own prefix, the images included."""
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


def _p1(model, dcfg, params, x, img, pos=None):
    """Prefill over x (B, p + 1) against prefill over x[:, :p] into a cache
    of capacity 8 + p + 1 and one decode of x[:, p] at `pos` (default 8 +
    p), the same images.  Returns (want logits, want cache, got logits,
    got cache)."""
    b, t = x.shape
    shape = ShapeConfig("p", N_IMG + t, b, "prefill")
    at = torch.full((b,), N_IMG + t - 1 if pos is None else pos,
                    dtype=torch.int64)
    with torch.inference_mode():
        want, full = model.prefill_local(
            params, {"tokens": x, "img_embeds": img}, dcfg,
            SV.alloc_cache(model, shape, dcfg, "cpu"))
        _, cache = model.prefill_local(
            params, {"tokens": x[:, :-1], "img_embeds": img}, dcfg,
            SV.alloc_cache(model, shape, dcfg, "cpu"))
        got, cache = model.decode_local(params, cache, x[:, -1], at, dcfg)
    return want, full, got, cache


def test_prefill_then_decode_equals_the_longer_prefill(fp32_run):
    """p 19: the cache's capacity is 8 + 20 = 28.  The decode at p, the
    reference launcher's position, which writes over an image position
    and attends to the images only, must fail the logits' check."""
    model, dcfg, params = (fp32_run[k] for k in ("model", "dcfg", "params"))
    tokens, img = _inputs(model.cfg, t=T, seed=2)
    x, im = torch.from_numpy(tokens), torch.from_numpy(img)
    want, full, got, cache = _p1(model, dcfg, params, x, im)
    _close(got, want, "prefill p + decode vs prefill p + 1: logits")
    _close_cache(cache, full, "prefill p + decode vs prefill p + 1")
    _, _, bad, _ = _p1(model, dcfg, params, x, im, pos=T - 1)
    assert not np.allclose(_np(bad), _np(want), **TOL32)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_codec_prefill_and_decode_match_reference(codec):
    """The vlm's cache under a KV codec: prefill logits, the dequantized
    cache and 2 decode steps against the reference's, both fed the
    reference's greedy tokens.  Both quantize K/V that agree to fp32
    rounding, so a code may sit one step apart: logits held to 1e-3 (the
    dense codec test's limit), dequantized caches to one code step."""
    tol = dict(rtol=1e-3, atol=1e-3)
    np_params, inputs, want = _reference(jnp.float32, 2, codec)
    _, _, params, pf, dec = _port(np_params, jnp.float32, codec)
    logits, cache = pf(params, _batch(*inputs))
    assert sorted(cache) == ["k", "ks", "v", "vs"]
    assert cache["k"].shape == (2, B, CELL, 2, 16)

    def check_cache(jcache, what):
        for n in ("k", "v"):
            step = torch.repeat_interleave(cache[n + "s"], 128, -1)[
                ..., :cache[n].shape[-1]]
            got = cache[n].float() * step
            q = np.asarray(jcache[n]).astype(np.float32)
            ref = torch.from_numpy(q) * torch.repeat_interleave(
                torch.from_numpy(np.array(jcache[n + "s"])), 128,
                -1)[..., :q.shape[-1]]
            assert bool(((got - ref).abs() <= step * (1 + 1e-6)
                         + 2e-5).all()), (what, n)

    np.testing.assert_allclose(logits.numpy(), want[0][0], **tol)
    check_cache(want[0][1], "prefill")
    for i, (jlogits, jcache) in enumerate(want[1:]):
        tok = torch.from_numpy(np.asarray(want[i][0]).argmax(-1))
        pos = torch.full((B,), N_IMG + PROMPT + i, dtype=torch.int64)
        logits, cache = dec(params, cache, tok, pos)
        np.testing.assert_allclose(logits.numpy(), jlogits, **tol,
                                   err_msg=f"step {i}")
        check_cache(jcache, f"decode {i}")


# ---------------------------------------------------------------------------
# Layout, step shapes, launcher
# ---------------------------------------------------------------------------
def test_cache_layout_matches_reference():
    _, jmodel = jax_get_arch(ARCH, smoke=True)
    _, model = get_arch(ARCH, smoke=True)
    shape, jshape = (ShapeConfig("d", CELL, B, "decode"),
                     JShapeConfig("d", CELL, B, "decode"))
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        for codec in (None, "int8", "fp8"):
            jabs, _ = JSV.cache_abstract(jmodel, jshape,
                                         jax_single_device_config(
                                             param_dtype=jdt,
                                             kv_cache_codec=codec))
            got = SV.cache_abstract(model, shape, single_device_config(
                param_dtype=dt, kv_cache_codec=codec))
            jl, gl = jax.tree.leaves(jabs), PG.kv_leaves(got)
            assert [tuple(a.shape) for a in gl] == [b.shape for b in jl]
            assert [str(a.dtype).split(".")[-1] for a in gl] == [
                {"float8_e4m3fn": "float8_e4m3fn"}.get(str(b.dtype),
                                                       str(b.dtype))
                for b in jl], (jdt, codec)
            if codec:
                assert sorted(got) == ["k", "ks", "v", "vs"]
    assert gl[0].shape == (2, B, CELL, 2, 16)
    cache = SV.alloc_cache(model, shape, single_device_config(), "cpu")
    assert all(float(a.abs().sum()) == 0 for a in PG.kv_leaves(cache))
    assert model.paged_kv is False
    with pytest.raises(ValueError, match="no paged decode path"):
        SV.make_paged_step(model, single_device_config(), shape, page=4,
                           n_pages_local=8, max_pages=7)
    with pytest.raises(ValueError, match="no paged KV"):
        plan_serve(model, single_device_config(), arena_bytes=1 << 20,
                   max_batch=2, max_seq=64)


def test_prefill_step_checks_the_batch_shapes(fp32_run):
    model, dcfg, params = (fp32_run[k] for k in ("model", "dcfg", "params"))
    pf = SV.make_prefill_step(model, dcfg,
                              ShapeConfig("p", CELL, B, "prefill"))
    tokens, img = fp32_run["inputs"]
    for bad in ({"tokens": torch.from_numpy(tokens)},
                _batch(tokens, img[:, :-1]),
                _batch(tokens[:, :-1], img),
                {"tokens": torch.zeros((B, CELL), dtype=torch.int64),
                 "img_embeds": torch.from_numpy(img)}):
        with pytest.raises(ValueError, match="step built for"):
            pf(params, bad)


def test_serve_launcher_serves_the_vlm_on_cpu(capsys):
    """The launcher's cell spans 8 image positions + prompt + gen, and its
    greedy tokens are those of a prefill and decode steps from position 8
    + prompt on the same seeded inputs."""
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "9", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated:")
    assert any(l.startswith("steady:") for l in lines)
    cfg, model, dcfg, params, prefill, decode = launch.setup(
        ARCH, True, 2, 9, 3, device="cpu")
    padded = launch.make_prompts(cfg, 2, 9, 3, "cpu")
    img = launch.make_img_embeds(model, dcfg, 2, N_IMG + 12, "cpu")
    assert tuple(img.shape) == (2, N_IMG, VIT) and img.dtype == torch.float32
    tokens, _ = launch.generate(params, prefill, decode, padded, 9, 3,
                                img_embeds=img)
    logits, cache = prefill(params, {"tokens": padded, "img_embeds": img})
    want = [logits.argmax(-1)]
    for i in range(2):
        logits, cache = decode(params, cache, want[-1],
                               torch.full((2,), N_IMG + 9 + i))
        want.append(logits.argmax(-1))
    assert torch.equal(tokens, torch.stack(want, 1))
    assert f"{tokens.numpy()}".split() == " ".join(
        lines[:lines.index(next(l for l in lines if l.startswith(
            "warm-up")))]).removeprefix("generated:").split()
