"""Serving runtime (port of `repro.train.serve`) at world size 1.

  * `serve_params_from_jax` — the weight carry-over: the reference's serve
    params, as numpy arrays in their exact layouts, become the port's;
  * `init_serve_params` — seeded weights made directly on the device;
  * `cache_abstract` — the dense KV cache's leaves on the meta device
    (the reference's `cache_abstract` without the partition specs), at any
    mesh: the serving plan prices them; for zamba2 its serving state (SSD
    and conv states, the shared block's keys and values) and for xlstm
    its recurrent states (mLSTM C, n, m and conv, sLSTM h, c, n, m) at
    tp = 1, and for encdec its self and cross caches;
  * `alloc_cache` — the dense KV cache, one (k, v) pair a layer of a
    local/global pair; under a KV codec ({"k", "ks", "v", "vs"} leaves)
    int8 / fp8 wire values and their per-128-chunk f32 scales; zamba2's
    and xlstm's states, zeroed (a prefill writes every leaf); encdec's
    self and cross caches;
  * `paged_abstracts` / `alloc_arena` — the paged arena (core/serving) of
    the same leaves, and its page table;
  * `make_prefill_step` / `make_decode_step` / `make_paged_step` — plain
    callables that run under `torch.inference_mode()` and update the cache
    or the arena in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dist import (DistConfig, check_world_size_one,
                                   resolve_device)
from repro_torch.core.meta import ParamMeta, tree_map
from repro_torch.core.serving import pages as PG
from repro_torch.kernels.quant import ops as QOPS
from repro_torch.models import runtime as RT
from repro_torch.models.common import ShapeConfig


# ---------------------------------------------------------------------------
# Serve parameters
# ---------------------------------------------------------------------------
def _check_keys(metas, tree, path: str) -> None:
    if isinstance(metas, ParamMeta):
        return
    if not isinstance(tree, dict) or set(tree) != set(metas):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"params{path}: expected keys {sorted(metas)}, "
                         f"got {got}")
    for k in metas:
        _check_keys(metas[k], tree[k], f"{path}/{k}")


def serve_params_from_jax(tree, model, dcfg: DistConfig, device="cuda"):
    """The reference's serve params -> the port's, on `device` in
    param_dtype.

    `tree` is what `repro.train.serve.serve_params_from_storage` returns,
    with every leaf converted to a numpy array: the same keys, wk/wv stored
    transposed as (kvp*hd, d), block leaves stacked (n_steps, ...).  Every
    leaf's shape is checked against the port's metas, so a layout that does
    not carry over raises here instead of failing inside a matmul."""
    check_world_size_one(dcfg)
    dev = resolve_device(device)
    metas = model.metas(dcfg)
    _check_keys(metas, tree, "")
    sk = RT.stacked_keys(model)

    def one(m: ParamMeta, a, n):
        want = (n, *m.global_shape) if n else m.global_shape
        # an fp32 host copy is exact for the reference's fp32/bf16 leaves
        a = np.array(a, dtype=np.float32)
        if a.shape != want:
            raise ValueError(f"{m.name}: expected {want}, got {a.shape}")
        return torch.from_numpy(a).to(device=dev, dtype=dcfg.param_dtype)

    return {k: tree_map(lambda m, a: one(m, a, sk.get(k)), metas[k], tree[k])
            for k in metas}


def init_serve_params(model, dcfg: DistConfig, generator: torch.Generator,
                      device="cuda"):
    """Seeded weights with the reference's distributions (normal * 0.02,
    wo/wd/head scaled by 1/sqrt(2 L), norms ones, or zeros where they store
    w - 1 under gemma2's unit offset), allocated on `device` in
    param_dtype layer by layer.  `generator` must live on `device`."""
    check_world_size_one(dcfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    with torch.no_grad():
        return model.init_full(generator, dcfg, dev, dcfg.param_dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def _kl_total(cfg, tp: int) -> int:
    """Global kv head count of the cache: per-rank kl x tp (grouped-kv
    archs store each rank's contiguous slice explicitly)."""
    lay = cfg.gqa_layout(tp)
    if lay["mode"] == "sharded":
        return cfg.n_kv_heads
    return max(1, lay["kvp"] // tp) * tp


def cache_abstract(model, shape: ShapeConfig, dcfg: DistConfig):
    """The dense cache's leaves for one decode step, as tensors on the meta
    device (shapes and dtypes): a (k, v) pair of (n_steps, B, T, kv heads,
    hd) in param_dtype, or under a KV codec {"k", "ks", "v", "vs"} (wire
    values in the codec's dtype, scales (..., kv_chunks(hd)) f32); gemma2's
    local/global pairs hold one such pair a layer of the pair.  Global
    head counts, as the reference's: any mesh.  zamba2: `init_state`'s
    {"S", "conv_x", "conv_bc", "sh_kv"} (the reference's leaves) at tp =
    1; xlstm: `init_state`'s {"m0".."m6": {"C", "n", "m", "conv"}, "s":
    {"h", "c", "n", "m"}}, fp32, stacked over the superblocks, at tp = 1;
    encdec: {"self": (k, v), "cross": (k, v)}, the decoder's self cache
    (n_dec, B, T, kv heads, hd) and its cross cache over S_src = T // 2
    frames.  None of the three takes a KV codec (the reference's caches
    ignore one; the port raises)."""
    cfg = model.cfg
    if cfg.family in ("zamba", "xlstm", "encdec") and dcfg.kv_codec:
        raise ValueError(f"{cfg.name}: the {cfg.family} cache takes no "
                         f"KV codec (got {dcfg.kv_codec!r})")
    if cfg.family in ("zamba", "xlstm"):
        return model.init_state(shape.global_batch, dcfg, shape.seq_len)
    if cfg.family == "encdec":
        heads = _kl_total(cfg, dcfg.tp_size)

        def kv(t_len):
            a = torch.empty((model.n_dec, shape.global_batch, t_len, heads,
                             cfg.head_dim), dtype=dcfg.param_dtype,
                            device="meta")
            return (a, a)
        return {"self": kv(shape.seq_len), "cross": kv(shape.seq_len // 2)}
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: serving the {cfg.family} family is not yet ported "
            "to repro_torch")
    dims = (model.n_steps, shape.global_batch, shape.seq_len,
            _kl_total(cfg, dcfg.tp_size), cfg.head_dim)
    codec = dcfg.kv_codec

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if codec:
        q = meta(dims, QOPS.kv_wire_dtype(codec))
        sc = meta((*dims[:-1], QOPS.kv_chunks(cfg.head_dim)), torch.float32)
        pair = {"k": q, "ks": sc, "v": q, "vs": sc}
    else:
        pair = (meta(dims, dcfg.param_dtype), meta(dims, dcfg.param_dtype))
    return (pair, pair) if cfg.local_global_alternate else pair


def alloc_cache(model, shape: ShapeConfig, dcfg: DistConfig, device="cuda"):
    """Zeroed dense KV cache on `device` with `cache_abstract`'s leaves: a
    (k, v) pair of (n_steps, B, T, Kl, hd) tensors in param_dtype (under a
    KV codec the wire values and scales), or for gemma2's local/global
    pairs one such pair a layer of the pair, ((k, v), (k, v)); zamba2's
    or xlstm's serving state."""
    check_world_size_one(dcfg)
    dev = resolve_device(device)
    return PG.kv_map(lambda a: PG.zeros(a.shape, a.dtype, dev),
                     cache_abstract(model, shape, dcfg))


def paged_abstracts(model, shape: ShapeConfig, dcfg: DistConfig, *,
                    page: int, n_pages_local: int, max_pages: int):
    """(arena leaves, page table) of a paged step, on the meta device: each
    cache leaf (L, B, T, *rest) becomes a pool (L, dp * (n_pages_local +
    1), page, *rest), the +1 a scratch page a shard; the table is (B,
    max_pages) int32."""
    arena = PG.arena_abstract(cache_abstract(model, shape, dcfg),
                              n_pages_local, page, dcfg.dp_total)
    return arena, torch.empty((shape.global_batch, max_pages),
                              dtype=torch.int32, device="meta")


def alloc_arena(model, dcfg: DistConfig, *, page: int, n_pages_local: int,
                device="cuda"):
    """A zeroed paged arena on `device` (`paged_abstracts`' leaves)."""
    check_world_size_one(dcfg)
    dev = resolve_device(device)
    arena, _ = paged_abstracts(model, ShapeConfig("arena", page, 1,
                                                  "decode"), dcfg,
                               page=page, n_pages_local=n_pages_local,
                               max_pages=1)
    return PG.kv_map(lambda a: PG.zeros(a.shape, a.dtype, dev), arena)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def make_prefill_step(model, dcfg: DistConfig, shape: ShapeConfig):
    """step(params, {"tokens": (B, T)}) -> (last logits (B, V), cache);
    encdec's batch also holds {"frames": (B, T // 2, frontend_dim)}, the
    shape its `input_specs` gives the frames of a prefill cell."""
    check_world_size_one(dcfg)
    want = {"tokens": (shape.global_batch, shape.seq_len)}
    if model.cfg.family == "encdec":
        want["frames"] = model.input_specs(shape, dcfg)["frames"].shape

    @torch.inference_mode()
    def step(params, batch):
        tokens = batch["tokens"]
        got = {k: tuple(batch[k].shape) if k in batch else None
               for k in want}
        if got != want:
            raise ValueError(f"batch {got}, step built for {want}")
        cache = alloc_cache(model, shape, dcfg, tokens.device)
        return model.prefill_local(params, batch, dcfg, cache)

    return step


def make_decode_step(model, dcfg: DistConfig, shape: ShapeConfig):
    """step(params, cache, tok (B,), pos (B,)) -> (logits (B, V), cache);
    the cache is updated in place."""
    check_world_size_one(dcfg)

    @torch.inference_mode()
    def step(params, cache, tok, pos):
        if tok.shape != (shape.global_batch,) or pos.shape != tok.shape:
            raise ValueError(f"tok {tuple(tok.shape)} / pos "
                             f"{tuple(pos.shape)}, step built for batch "
                             f"{shape.global_batch}")
        return model.decode_local(params, cache, tok, pos, dcfg)

    return step


def make_paged_step(model, dcfg: DistConfig, shape: ShapeConfig, *,
                    page: int, n_pages_local: int, max_pages: int,
                    chunk: int = 1):
    """step(params, arena, table, toks, qpos) -> (logits (B, V), arena): a
    paged serving step over the arena `paged_abstracts` lays out.

    toks/qpos are (b, c) with b <= shape.global_batch rows (a caller may
    pass the live rows only) and 1 <= c <= chunk tokens a row: c = 1 is a
    decode step, c > 1 a chunked-prefill slab (its logits are position
    c-1's, so a ragged last chunk runs at its true length).  table: (b,
    max_pages) int page ids, -1 = unallocated (written to the scratch
    page).  The arena is updated in place."""
    if not getattr(model, "paged_kv", False):
        raise ValueError(
            f"{model.cfg.family}: no paged decode path (see plan_serve)")
    check_world_size_one(dcfg)
    arena_abs, _ = paged_abstracts(model, shape, dcfg, page=page,
                                   n_pages_local=n_pages_local,
                                   max_pages=max_pages)
    want = [tuple(a.shape) for a in PG.kv_leaves(arena_abs)]

    @torch.inference_mode()
    def step(params, arena, table, toks, qpos):
        b, c = toks.shape
        if (tuple(qpos.shape) != (b, c) or tuple(table.shape) != (
                b, max_pages) or not 1 <= b <= shape.global_batch
                or not 1 <= c <= chunk):
            raise ValueError(
                f"toks {tuple(toks.shape)} / qpos {tuple(qpos.shape)} / "
                f"table {tuple(table.shape)}: step built for <= "
                f"{shape.global_batch} rows of <= {chunk} tokens and "
                f"{max_pages} pages")
        got = [tuple(a.shape) for a in PG.kv_leaves(arena)]
        if got != want:
            raise ValueError(f"arena leaves {got}, step built for {want}")
        return model.paged_step_local(params, arena, table, toks, qpos,
                                      dcfg, page=page)

    return step
