"""Paged serving of the PyTorch port against the JAX reference on the CPU.

  * `PagePool` invariants; `scatter_tokens` / `gather_tokens` /
    `dense_to_pages` / `arena_abstract` equal to the reference's on seeded
    numpy inputs, exactly, tables included (the scratch row, which
    duplicate writes from inactive rows may fill in any order, is not
    compared);
  * the KV codec (`encode_kv` / `decode_kv`, `kv_quantize` /
    `kv_dequantize`) bit-equal to the reference's at hd 64, 96 and 128;
  * port-internal paged decode == dense decode BIT FOR BIT in the
    reference's five cases (qwen3 with no codec / int8 / fp8, gemma2,
    qwen2-moe), and the port's paged step against the reference's
    `make_paged_step` on weights carried by `serve_params_from_jax`:
    logits and caches at TOL32 (rtol 2e-4, atol 2e-5, tests/test_kernels.py's
    fp32 tolerance) without a codec; with one, the dequantized caches to
    one quantization step (the chunk's scale) and the logits to
    TOL_CODEC_LOGITS, since equal inputs may round to adjacent codes;
  * ragged positions and chunked prefill == full prefill, at the reference
    test's 2e-5.

One JAX compile per shape: the reference's steps are built once a case by
module-scoped fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serving as JSERVE
from repro.core.dist import DistConfig as JDistConfig
from repro.core.serving import pages as JPG
from repro.core.serving.scheduler import _pages_through as j_pages_through
from repro.kernels.quant import ops as JQOPS
from repro.models import layers as JLY
from repro.models import runtime as RT
from repro.models.common import ShapeConfig as JShapeConfig
from repro.models.registry import get_arch as jax_get_arch
from repro.train import serve as JSV

from repro_torch.core.dist import DistConfig, single_device_config
from repro_torch.core.serving import (PagePool, arena_abstract,
                                      dense_to_pages, gather_tokens,
                                      scatter_tokens)
from repro_torch.core.serving import pages as PG
from repro_torch.core.serving.scheduler import _pages_through
from repro_torch.kernels.quant import ops as QOPS
from repro_torch.models import layers as LY
from repro_torch.models.common import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.train import serve as SV

torch.set_num_threads(1)  # small tensors: spare the test workers' cores

TOL32 = dict(rtol=2e-4, atol=2e-5)
# logits under a KV codec, port vs reference: both quantize K/V that agree
# to fp32 rounding, so a code may land one step apart where a value sits
# on a rounding boundary; one int8 step is 1/127 of its chunk's absmax.
# The smoke models' logits move by well under this where that happens.
TOL_CODEC_LOGITS = dict(rtol=1e-3, atol=1e-3)
CASES = [("qwen3_1_7b", None), ("qwen3_1_7b", "int8"), ("qwen3_1_7b", "fp8"),
         ("gemma2_27b", None), ("qwen2_moe_a2_7b", None)]
B, PROMPT, GEN, PAGE = 4, 12, 4, 4


def _np(t):
    """A tensor or jax array as numpy; fp8 as its bytes."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------
def test_page_pool_invariants():
    pool = PagePool(8)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.used == 3
    assert pool.alloc(6) is None          # never partial
    assert pool.used == 3
    pool.retain(a[0])
    assert not pool.release(a[0])         # still referenced
    assert pool.release(a[0])             # now freed
    pool.release_all(a[1:])
    assert pool.available == 8
    pool.check()
    with pytest.raises(AssertionError):
        pool.release(a[0])                # double free


def test_page_pool_follows_the_reference():
    """The same seeded sequence of alloc / retain / release gives the same
    page ids and counts as the reference's pool."""
    rng = np.random.default_rng(0)
    mine, ref = PagePool(12), JPG.PagePool(12)
    held = []
    for _ in range(200):
        op = rng.integers(3)
        if op == 0:
            n = int(rng.integers(1, 5))
            a, b = mine.alloc(n), ref.alloc(n)
            assert a == b
            held += a or []
        elif held and op == 1:
            pid = held[int(rng.integers(len(held)))]
            mine.retain(pid)
            ref.retain(pid)
            held.append(pid)
        elif held:
            pid = held.pop(int(rng.integers(len(held))))
            assert mine.release(pid) == ref.release(pid)
        assert (mine.used, mine.available) == (ref.used, ref.available)
        mine.check()


@pytest.mark.parametrize("pos,page", [(0, 4), (3, 4), (4, 4), (15, 16),
                                      (2063, 16)])
def test_pages_through(pos, page):
    assert _pages_through(pos, page) == j_pages_through(pos, page)


# ---------------------------------------------------------------------------
# gather / scatter / repage
# ---------------------------------------------------------------------------
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "int8": (np.int8, torch.int8, jnp.int8),
          "fp8": (np.float32, torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scatter_and_gather_match_reference(dtype):
    np_dt, t_dt, j_dt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    n_pages, page, b, c, max_pages = 9, 4, 3, 5, 4
    pool = (rng.standard_normal((n_pages + 1, page, 2, 6)) * 20).astype(
        np_dt)
    val = (rng.standard_normal((b, c, 2, 6)) * 20).astype(np_dt)
    table = np.array([[2, 5, -1, -1], [0, 7, 3, -1], [-1, -1, -1, -1]],
                     np.int32)
    qpos = np.array([[3, 4, 5, 6, 7], [8, 9, 10, 11, 2], [0, 1, 2, 3, 4]],
                    np.int32)
    jpool = JPG.scatter_tokens(jnp.asarray(pool).astype(j_dt),
                               jnp.asarray(table), jnp.asarray(qpos),
                               jnp.asarray(val).astype(j_dt), page)
    tpool = torch.from_numpy(pool).to(t_dt)
    out = scatter_tokens(tpool, torch.from_numpy(table),
                         torch.from_numpy(qpos).long(),
                         torch.from_numpy(val).to(t_dt), page)
    assert out is tpool                          # in place
    # every row but the scratch row (the last) exactly
    np.testing.assert_array_equal(_np(tpool)[:-1], _np(jpool)[:-1])
    # the gather reads the table's window, clipped ids included
    got = gather_tokens(tpool, torch.from_numpy(table), page)
    want = JPG.gather_tokens(jpool, jnp.asarray(table), page)
    assert tuple(got.shape) == want.shape == (b, max_pages * page, 2, 6)
    live = np.repeat(table >= 0, page, axis=1)
    np.testing.assert_array_equal(_np(got)[live], _np(want)[live])


@pytest.mark.parametrize("codec", [None, "fp8"])
@pytest.mark.parametrize("dp_shards", [1, 2])
def test_dense_to_pages_matches_reference(codec, dp_shards):
    rng = np.random.default_rng(2)
    L, b, t, page, n_local, max_pages = 2, 4, 12, 4, 7, 3
    lengths = np.array([5, 0, 12, 7])

    def leaf(shape, dt):
        a = rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(a).astype(dt)

    if codec:
        q = leaf((L, b, t, 2, 8), jnp.float8_e4m3fn)
        cache = {"k": q, "ks": leaf((L, b, t, 2, 1), jnp.float32),
                 "v": q, "vs": leaf((L, b, t, 2, 1), jnp.float32)}
    else:
        cache = (leaf((L, b, t, 2, 8), jnp.float32),
                 leaf((L, b, t, 2, 8), jnp.float32))
    jarena, jtable, jpools = JPG.dense_to_pages(
        cache, lengths, page, n_local, max_pages, dp_shards=dp_shards)
    arena, table, pools = dense_to_pages(
        PG.kv_map(_to_torch, cache if codec else list(cache)), lengths, page,
        n_local, max_pages, dp_shards=dp_shards)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    jl = jax.tree.leaves(jarena) if not codec else [
        jarena[k] for k in ("k", "ks", "v", "vs")]
    for got, want in zip(PG.kv_leaves(arena), jl):
        assert got.dtype == _to_torch(want).dtype
        np.testing.assert_array_equal(_np(got), _np(want))
    assert [p.used for p in pools] == [p.used for p in jpools]


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
@pytest.mark.parametrize("codec", [None, "int8", "fp8"])
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "gemma2_27b"])
def test_cache_and_arena_shapes_match_reference(arch, codec, mesh):
    """`cache_abstract` / `paged_abstracts` against the reference's: shapes
    and dtypes, leaf for leaf, at any mesh."""
    jcfg, jmodel = jax_get_arch(arch, smoke=True)
    _, model = get_arch(arch, smoke=True)
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=mesh,
                     param_dtype=jnp.float32, kv_cache_codec=codec)
    d = DistConfig(mesh_shape=mesh, param_dtype=torch.float32,
                   kv_cache_codec=codec)
    shape = (JShapeConfig("d", 16, 4, "decode"),
             ShapeConfig("d", 16, 4, "decode"))
    jabs, _ = JSV.cache_abstract(jmodel, shape[0], jd)
    jarena, _, jtable, _ = JSV.paged_abstracts(
        jmodel, shape[0], jd, page=4, n_pages_local=10, max_pages=4)
    arena, table = SV.paged_abstracts(model, shape[1], d, page=4,
                                      n_pages_local=10, max_pages=4)

    def same(mine, ref):
        got = [(tuple(a.shape), a.dtype) for a in PG.kv_leaves(mine)]
        # the reference's dicts flatten with sorted keys (k, ks, v, vs):
        # the port's order too
        want = [(tuple(a.shape), _to_torch(np.zeros((), a.dtype)).dtype)
                for a in jax.tree.leaves(ref)]
        assert got == want

    same(SV.cache_abstract(model, shape[1], d), jabs)
    same(arena, jarena)
    assert (tuple(table.shape), table.dtype) == (tuple(jtable.shape),
                                                 torch.int32)
    # arena_abstract alone, on the port's cache leaves
    mine = arena_abstract(SV.cache_abstract(model, shape[1], d), 10, 4,
                          d.dp_total)
    same(mine, jarena)


# ---------------------------------------------------------------------------
# KV codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_kv_codec_matches_reference(codec, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero vector: scale 1
    x[1, 2, 1, :7] = 1e-30                  # subnormal-sized entries
    jq, js = JQOPS.encode_kv(jnp.asarray(x), codec)
    q, s = QOPS.encode_kv(torch.from_numpy(x), codec)
    assert q.dtype == QOPS.kv_wire_dtype(codec) and s.dtype == torch.float32
    assert tuple(s.shape) == (2, 5, 3, QOPS.kv_chunks(hd)) == js.shape
    np.testing.assert_array_equal(_np(q), _np(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = QOPS.decode_kv(q, s, dt)
        want = JQOPS.decode_kv(jq, js, jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # the layer helpers are the ops
    lq, ls = LY.kv_quantize(torch.from_numpy(x), codec)
    jlq, jls = JLY.kv_quantize(jnp.asarray(x), codec)
    np.testing.assert_array_equal(_np(lq), _np(jlq))
    np.testing.assert_array_equal(ls.numpy(), np.asarray(jls))
    np.testing.assert_array_equal(
        LY.kv_dequantize(lq, ls, torch.float32).numpy(),
        np.asarray(JLY.kv_dequantize(jlq, jls, jnp.float32)))


def test_kv_codec_config():
    assert DistConfig().kv_codec is None
    assert DistConfig(kv_cache_int8=True).kv_codec == "int8"
    assert DistConfig(kv_cache_codec="fp8", kv_cache_int8=True).kv_codec \
        == "fp8"
    with pytest.raises(ValueError, match="kv_cache_codec='int4'"):
        DistConfig(kv_cache_codec="int4")
    with pytest.raises(ValueError, match="kv_cache_codec='int4'"):
        JDistConfig(kv_cache_codec="int4")


# ---------------------------------------------------------------------------
# paged == dense (exact) and the port against the reference
# ---------------------------------------------------------------------------
def _shape_consts(b=B, prompt=PROMPT, gen=GEN, page=PAGE):
    t = prompt + gen
    max_pages = t // page
    return dict(B=b, prompt=prompt, gen=gen, page=page, T=t,
                max_pages=max_pages, n_pages_local=b * max_pages + 2)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    """Both packages prefilled on the same weights and tokens, with the
    reference's dense decode and paged steps built once."""
    arch, codec = request.param
    sh = _shape_consts()
    jd = JDistConfig(mesh_axes=("data", "model"), mesh_shape=(1, 1),
                     param_dtype=jnp.float32, reduce_dtype=jnp.float32,
                     kv_cache_codec=codec)
    jcfg, jmodel = jax_get_arch(arch, smoke=True)
    storage = RT.init_storage(jmodel, jax.random.PRNGKey(0), jd)
    jparams = JSV.serve_params_from_storage(jmodel, storage, jd)
    jpf, mesh = JSV.make_prefill_step(
        jmodel, jd, JShapeConfig("p", sh["T"], sh["B"], "prefill"))
    jdec, _ = JSV.make_decode_step(
        jmodel, jd, JShapeConfig("d", sh["T"], sh["B"], "decode"), mesh=mesh)
    jpstep, _ = JSV.make_paged_step(
        jmodel, jd, JShapeConfig("d", sh["T"], sh["B"], "decode"),
        page=sh["page"], n_pages_local=sh["n_pages_local"],
        max_pages=sh["max_pages"], mesh=mesh)
    rng = np.random.default_rng(1)
    toks = rng.integers(3, jcfg.vocab, (sh["B"], sh["prompt"]))
    padded = np.pad(toks, ((0, 0), (0, sh["gen"])), constant_values=3)
    jlogits, jcache = jpf(jparams, {"tokens": jnp.asarray(padded,
                                                          jnp.int32)})

    cfg, model = get_arch(arch, smoke=True)
    d = single_device_config(param_dtype=torch.float32, kv_cache_codec=codec)
    params = SV.serve_params_from_jax(jax.tree.map(np.asarray, jparams),
                                      model, d, device="cpu")
    pf = SV.make_prefill_step(model, d, ShapeConfig("p", sh["T"], sh["B"],
                                                    "prefill"))
    dec = SV.make_decode_step(model, d, ShapeConfig("d", sh["T"], sh["B"],
                                                    "decode"))
    pstep = SV.make_paged_step(
        model, d, ShapeConfig("d", sh["T"], sh["B"], "decode"),
        page=sh["page"], n_pages_local=sh["n_pages_local"],
        max_pages=sh["max_pages"], chunk=4)
    logits, cache = pf(params, {"tokens": torch.from_numpy(padded)})
    return dict(arch=arch, codec=codec, sh=sh, cfg=cfg, model=model, d=d,
                params=params, dec=dec, pstep=pstep, logits=logits,
                cache=cache, toks=toks, jd=jd, jmodel=jmodel,
                jparams=jparams, jdec=jdec, jpstep=jpstep, jlogits=jlogits,
                jcache=jcache)


def _full_tables(table, pools, lengths, sh, dp=1):
    """dense_to_pages' table plus the generation pages each row needs."""
    tbl = np.array(table)
    for b in range(sh["B"]):
        filled = -(-int(lengths[b]) // sh["page"])
        ids = pools[b // (sh["B"] // dp)].alloc(sh["max_pages"] - filled)
        tbl[b, filled:filled + len(ids)] = ids
    return tbl


def _clone(tree):
    return PG.kv_map(lambda a: a.clone(), tree)


def test_paged_decode_exact_parity(case):
    """Port-internal: paged decode equals dense decode bit for bit, each
    side on its own greedy tokens, as the reference's test asserts."""
    sh = case["sh"]
    cache_d = _clone(case["cache"])
    arena, table, pools = dense_to_pages(
        _clone(case["cache"]), np.full((sh["B"],), sh["prompt"]), sh["page"],
        sh["n_pages_local"], sh["max_pages"])
    table = torch.from_numpy(_full_tables(table, pools,
                                          [sh["prompt"]] * sh["B"], sh))
    tok_d = tok_p = case["logits"].argmax(-1)
    for i in range(sh["gen"]):
        pos = torch.full((sh["B"],), sh["prompt"] + i, dtype=torch.int64)
        ld, cache_d = case["dec"](case["params"], cache_d, tok_d, pos)
        lp, arena = case["pstep"](case["params"], arena, table,
                                  tok_p[:, None], pos[:, None])
        assert torch.equal(ld, lp), f"{case['arch']}/{case['codec']} step {i}"
        tok_d, tok_p = ld.argmax(-1), lp.argmax(-1)


def _dequant_leaves(tree, codec):
    """(k, v) leaves of a cache or arena tree in fp32 (dequantized under a
    codec), plus the per-element size of one code step."""
    out = []
    for kv in (tree if isinstance(tree, tuple) and isinstance(
            tree[0], (tuple, dict)) else (tree,)):
        if codec:
            for n in ("k", "v"):
                s = torch.repeat_interleave(
                    kv[n + "s"], 128, dim=-1)[..., :kv[n].shape[-1]]
                out.append((kv[n].float() * s, s))
        else:
            out += [(kv[0].float(), None), (kv[1].float(), None)]
    return out


def _jtree(tree, codec):
    """The reference's cache / arena as the port's tree of tensors."""
    conv = lambda a: _to_torch(a)                   # noqa: E731
    if isinstance(tree, tuple) and isinstance(tree[0], (tuple, dict)):
        return tuple(_jtree(t, codec) for t in tree)
    if codec:
        return {k: conv(tree[k]) for k in ("k", "ks", "v", "vs")}
    return tuple(conv(a) for a in tree)


def _close_caches(mine, ref, codec, what):
    for (a, step), (b, _) in zip(_dequant_leaves(mine, codec),
                                 _dequant_leaves(_jtree(ref, codec), codec)):
        if step is None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL32,
                                       err_msg=what)
        else:
            # at most one code step apart (plus fp32 rounding)
            bad = (a - b).abs() > step * (1 + 1e-6) + TOL32["atol"]
            assert not bool(bad.any()), (what, int(bad.sum()))


def test_paged_step_matches_reference(case):
    """The port's prefill, repage and paged decode against the reference's
    on carried weights, both fed the reference's greedy tokens: logits and
    caches at TOL32 without a codec; with one, caches within one code step
    and logits at TOL_CODEC_LOGITS."""
    sh, codec = case["sh"], case["codec"]
    tol = TOL_CODEC_LOGITS if codec else TOL32
    np.testing.assert_allclose(case["logits"].numpy(),
                               np.asarray(case["jlogits"]), **tol)
    _close_caches(case["cache"], case["jcache"], codec, "prefill cache")
    lengths = np.full((sh["B"],), sh["prompt"])
    jarena, jtable, jpools = JPG.dense_to_pages(
        case["jcache"], lengths, sh["page"], sh["n_pages_local"],
        sh["max_pages"])
    arena, table, pools = dense_to_pages(
        _clone(case["cache"]), lengths, sh["page"], sh["n_pages_local"],
        sh["max_pages"])
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    jtbl = _full_tables(jtable, jpools, lengths, sh)
    tbl = _full_tables(table, pools, lengths, sh)
    np.testing.assert_array_equal(tbl, jtbl)
    tok = np.array(jnp.argmax(case["jlogits"], -1))
    for i in range(sh["gen"]):
        pos = np.full((sh["B"], 1), sh["prompt"] + i)
        jl, jarena = case["jpstep"](
            case["jparams"], jarena, jnp.asarray(jtbl),
            jnp.asarray(tok[:, None], jnp.int32), jnp.asarray(pos, jnp.int32))
        lp, arena = case["pstep"](case["params"], arena,
                                  torch.from_numpy(tbl),
                                  torch.from_numpy(tok[:, None]).long(),
                                  torch.from_numpy(pos).long())
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl), **tol,
                                   err_msg=f"step {i}")
        tok = np.array(jnp.argmax(jl, -1))
    # the arenas' live rows (the scratch row last in the pool is not read)
    live = lambda t: PG.kv_map(lambda a: a[:, :-1], t)   # noqa: E731
    jlive = jax.tree.map(lambda a: a[:, :-1], jarena)
    _close_caches(live(arena), jlive, codec, "arena after decode")


def test_paged_step_rejects_a_shape_it_was_not_built_for(case):
    sh = case["sh"]
    arena, table, _ = dense_to_pages(
        _clone(case["cache"]), np.full((sh["B"],), sh["prompt"]), sh["page"],
        sh["n_pages_local"], sh["max_pages"])
    toks = torch.zeros((sh["B"], 5), dtype=torch.int64)      # > chunk 4
    with pytest.raises(ValueError, match="<= 4 tokens"):
        case["pstep"](case["params"], arena, table, toks, toks)
    small = dense_to_pages(_clone(case["cache"]),
                           np.full((sh["B"],), sh["prompt"]), sh["page"],
                           sh["n_pages_local"] - 1, sh["max_pages"])[0]
    one = torch.zeros((sh["B"], 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="arena leaves"):
        case["pstep"](case["params"], small, table, one, one)


def test_zamba2_has_no_paged_step():
    _, model = get_arch("zamba2_1_2b", smoke=True)
    d = single_device_config(param_dtype=torch.float32)
    with pytest.raises(ValueError, match="no paged decode path"):
        SV.make_paged_step(model, d, ShapeConfig("d", 16, 2, "decode"),
                           page=4, n_pages_local=8, max_pages=4)


@pytest.fixture(scope="module")
def qwen3_b2():
    """qwen3 SMOKE at B 2, prompt 8, gen 8, page 4 (the reference tests'
    ragged and chunked shapes): port steps on seeded weights."""
    sh = _shape_consts(b=2, prompt=8, gen=8, page=4)
    cfg, model = get_arch("qwen3_1_7b", smoke=True)
    d = single_device_config(param_dtype=torch.float32)
    params = SV.init_serve_params(model, d, torch.Generator().manual_seed(0),
                                  "cpu")
    mk = lambda k, t: ShapeConfig(k, t, sh["B"], k)    # noqa: E731
    pf = SV.make_prefill_step(model, d, mk("prefill", sh["T"]))
    dec = SV.make_decode_step(model, d, mk("decode", sh["T"]))
    pstep = SV.make_paged_step(model, d, mk("decode", sh["T"]),
                               page=sh["page"],
                               n_pages_local=sh["n_pages_local"],
                               max_pages=sh["max_pages"], chunk=4)
    toks = torch.randint(3, cfg.vocab, (sh["B"], sh["prompt"]),
                         generator=torch.Generator().manual_seed(1))
    padded = torch.nn.functional.pad(toks, (0, sh["gen"]), value=3)
    logits, cache = pf(params, {"tokens": padded})
    return dict(sh=sh, model=model, d=d, params=params, pf=pf, dec=dec,
                pstep=pstep, toks=toks, logits=logits, cache=cache)


def test_paged_decode_ragged_positions(qwen3_b2):
    """Rows at different depths decode correctly: row b of a ragged paged
    step matches row b of a dense decode at that row's depth."""
    c = qwen3_b2
    sh, params, dec = c["sh"], c["params"], c["dec"]
    b, prompt = sh["B"], sh["prompt"]
    cache_d = _clone(c["cache"])
    tok = c["logits"].argmax(-1)
    toks_by_step = [tok]
    for i in range(2):
        lg, cache_d = dec(params, cache_d, tok,
                          torch.full((b,), prompt + i, dtype=torch.int64))
        tok = lg.argmax(-1)
        toks_by_step.append(tok)
    lengths = np.array([prompt + 2, prompt])
    # the ragged dense cache: row 0 advanced two steps, row 1 at the prompt
    ragged = PG.kv_map(lambda adv, base: torch.cat([adv[:, :1], base[:, 1:]],
                                                   1), cache_d, c["cache"])
    arena, table, pools = dense_to_pages(ragged, lengths, sh["page"],
                                         sh["n_pages_local"],
                                         sh["max_pages"])
    table = torch.from_numpy(_full_tables(table, pools, lengths, sh))
    rtok = torch.stack([toks_by_step[2][0], toks_by_step[0][1]])
    rpos = torch.from_numpy(lengths)
    lp, _ = c["pstep"](params, arena, table, rtok[:, None], rpos[:, None])
    l0, _ = dec(params, _clone(cache_d), toks_by_step[2],
                torch.full((b,), prompt + 2, dtype=torch.int64))
    l1, _ = dec(params, _clone(c["cache"]), toks_by_step[0],
                torch.full((b,), prompt, dtype=torch.int64))
    np.testing.assert_allclose(lp[0].numpy(), l0[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lp[1].numpy(), l1[1].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunks", [(4, 4), (3, 4, 1)],
                         ids=["even", "ragged"])
def test_chunked_prefill_matches_full_prefill(qwen3_b2, chunks):
    """Chunked prefill into an empty arena reproduces a prompt-length dense
    prefill's logits (a ragged last chunk runs at its true length), and
    the next paged decode step agrees with dense decode."""
    c = qwen3_b2
    sh, params = c["sh"], c["params"]
    b, prompt, page = sh["B"], sh["prompt"], sh["page"]
    empty = PG.kv_map(torch.zeros_like, c["cache"])
    arena, table, pools = dense_to_pages(empty, np.zeros((b,), int), page,
                                         sh["n_pages_local"],
                                         sh["max_pages"])
    table = torch.from_numpy(_full_tables(table, pools, [0] * b, sh))
    s = 0
    for n in chunks:
        qpos = torch.arange(s, s + n)[None, :].repeat(b, 1)
        lp, arena = c["pstep"](params, arena, table, c["toks"][:, s:s + n],
                               qpos)
        s += n
    assert s == prompt
    pf2 = SV.make_prefill_step(c["model"], c["d"],
                               ShapeConfig("p2", prompt, b, "prefill"))
    logits_ref, _ = pf2(params, {"tokens": c["toks"]})
    np.testing.assert_allclose(lp.numpy(), logits_ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    tok = logits_ref.argmax(-1)
    pos = torch.full((b,), prompt, dtype=torch.int64)
    ld, _ = c["dec"](params, _clone(c["cache"]), tok, pos)
    lp2, _ = c["pstep"](params, arena, table, tok[:, None], pos[:, None])
    np.testing.assert_allclose(lp2.numpy(), ld.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_serving_package_exports_match_reference():
    from repro_torch.core import serving
    assert sorted(serving.__all__) == sorted(JSERVE.__all__)
    for name in serving.__all__:
        assert hasattr(serving, name), name


def test_inactive_rows_write_only_the_scratch_page(qwen3_b2):
    """A step whose second row is inactive (its table row all -1) leaves
    every live page of the arena as it was but the active row's slot."""
    c = qwen3_b2
    sh = c["sh"]
    arena, table, pools = dense_to_pages(
        _clone(c["cache"]), np.full((sh["B"],), sh["prompt"]), sh["page"],
        sh["n_pages_local"], sh["max_pages"])
    table = torch.from_numpy(_full_tables(table, pools,
                                          [sh["prompt"]] * sh["B"], sh))
    table[1] = -1
    before = _clone(arena)
    tok = c["logits"].argmax(-1)[:, None]
    pos = torch.full((sh["B"], 1), sh["prompt"], dtype=torch.int64)
    c["pstep"](c["params"], arena, table, tok, pos)
    pid = int(table[0, sh["prompt"] // sh["page"]])
    slot = sh["prompt"] % sh["page"]
    for a, b in zip(PG.kv_leaves(arena), PG.kv_leaves(before)):
        changed = (a != b).any(dim=(0, 3, 4)).nonzero().tolist()
        rows = {r for r, _ in changed}
        assert rows <= {pid, a.shape[1] - 1}, changed
        assert [pid, slot] in changed
