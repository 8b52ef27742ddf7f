"""Serving runtime (port of `repro.train.serve`) at world size 1.

  * `serve_params_from_jax` — the weight carry-over: the reference's serve
    params, as numpy arrays in their exact layouts, become the port's;
  * `init_serve_params` — seeded weights made directly on the device;
  * `alloc_cache` — the dense KV cache (the reference's `cache_abstract`),
    one (k, v) pair a layer of a local/global pair;
  * `make_prefill_step` / `make_decode_step` — plain callables that run
    under `torch.inference_mode()`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dist import (DistConfig, check_world_size_one,
                                   resolve_device)
from repro_torch.core.meta import ParamMeta, tree_map
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
def alloc_cache(model, shape: ShapeConfig, dcfg: DistConfig, device="cuda"):
    """Zeroed dense KV cache in param_dtype on `device`: a (k, v) pair of
    (n_steps, B, T, Kl, hd) tensors, or for gemma2's local/global pairs one
    such pair a layer of the pair, ((k, v), (k, v)), as the reference's
    `cache_abstract` lays it out."""
    check_world_size_one(dcfg)
    dev = resolve_device(device)
    cfg = model.cfg
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: serving the {cfg.family} family is not yet ported "
            "to repro_torch")
    dims = (model.n_steps, shape.global_batch, shape.seq_len,
            cfg.gqa_layout(dcfg.tp_size)["kvp"], cfg.head_dim)
    def pair():
        return tuple(torch.zeros(dims, dtype=dcfg.param_dtype, device=dev)
                     for _ in range(2))

    if cfg.local_global_alternate:
        return pair(), pair()
    return pair()


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def make_prefill_step(model, dcfg: DistConfig, shape: ShapeConfig):
    """step(params, {"tokens": (B, T)}) -> (last logits (B, V), cache)."""
    check_world_size_one(dcfg)
    want = (shape.global_batch, shape.seq_len)

    @torch.inference_mode()
    def step(params, batch):
        tokens = batch["tokens"]
        if tuple(tokens.shape) != want:
            raise ValueError(f"tokens {tuple(tokens.shape)}, step built for "
                             f"{want}")
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
