"""Glue between model definitions and the steps (port of
`repro.models.runtime`): the `stacked_keys` contract, storage init, the
local shard of a rank, and the carry-over of the reference's storage and
optimizer trees.

Storage in the port is what ONE rank holds: every leaf's last axis is that
rank's contiguous chunk of the padded flat axis (`core/meta.py`).  At
world size 1 the local storage is the whole storage, byte for byte the
reference's `shard_params` output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.dist import DistConfig, resolve_device
from repro_torch.core.meta import abstract_storage, named_leaves, tree_map


def stacked_keys(model) -> dict:
    """Which top-level param groups carry a leading layer-stack dim.

    Part of the model contract: every model declares `stacked_keys`
    explicitly; a model without it gets a pointed error."""
    sk = getattr(model, "stacked_keys", None)
    if sk is None:
        raise TypeError(
            f"{type(model).__name__} does not declare `stacked_keys`; the "
            "model contract requires a property mapping each layer-stacked "
            "param group to its stack length, e.g. {'blocks': n_steps}")
    return dict(sk)


def n_params(model) -> int:
    """Sum of the metas' global sizes, a layer-stacked group once per
    layer."""
    sk = stacked_keys(model)
    return sum(math.prod(m.global_shape) * sk.get(k, 1)
               for k, tree in model.metas(DistConfig()).items()
               for _, m in named_leaves(tree))


def model_abstract_storage(model, dcfg: DistConfig):
    """The whole storage on the meta device (shapes and dtypes)."""
    metas = model.metas(dcfg)
    sk = stacked_keys(model)
    return {k: abstract_storage(metas[k], dcfg, n_layers=sk.get(k))
            for k in metas}


def local_shard(storage, dcfg: DistConfig, rank: int):
    """Whole storage -> this rank's chunk of every leaf, contiguous."""
    def one(a):
        chunk = a.shape[-1] // dcfg.fsdp_size
        return a[..., rank * chunk:(rank + 1) * chunk].contiguous()
    return tree_map(one, storage)


def gather_shards(local, dcfg: DistConfig):
    """Inverse of `local_shard` across the FSDP ranks (one all-gather per
    leaf)."""
    from repro_torch.core.collectives import all_gather_single

    def one(a):
        out = torch.empty((dcfg.fsdp_size, *a.shape), dtype=a.dtype,
                          device=a.device)
        all_gather_single(out.view(-1), a.contiguous().view(-1))
        return out.movedim(0, -2).reshape(*a.shape[:-1], -1)
    return tree_map(one, local)


def init_storage(model, generator: torch.Generator, dcfg: DistConfig,
                 device="cuda"):
    """Seeded full params (the reference's distributions) made on `device`
    in the storage dtype, laid out as storage (whole, not yet sharded)."""
    from repro_torch.core.api import shard_params
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, storage on {dev}")
    with torch.no_grad():
        full = model.init_full(generator, dcfg, dev, dcfg.storage_dtype)
        metas = model.metas(dcfg)
        return {k: shard_params(full.pop(k), metas[k], dcfg)
                for k in list(metas)}


# ---------------------------------------------------------------------------
# Carry-over from the reference (numpy trees)
# ---------------------------------------------------------------------------
def _check_tree(want, tree, path: str, what: str):
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) \
                else type(tree).__name__
            raise ValueError(f"{what}{path}: expected keys {sorted(want)}, "
                             f"got {got}")
        for k in want:
            _check_tree(want[k], tree[k], f"{path}/{k}", what)
    elif tuple(np.shape(tree)) != tuple(want.shape):
        raise ValueError(f"{what}{path}: expected {tuple(want.shape)}, got "
                         f"{tuple(np.shape(tree))}")


def storage_from_jax(tree, model, dcfg: DistConfig, device="cuda"):
    """The reference's (whole) storage tree, leaves as numpy arrays, -> the
    port's storage on `device` in the storage dtype.  Every key and shape
    is checked against the port's own layout."""
    dev = resolve_device(device)
    want = model_abstract_storage(model, dcfg)
    _check_tree(want, tree, "", "storage")
    return tree_map(lambda w, a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device=dev, dtype=w.dtype),
        want, tree)


def opt_state_from_jax(state, model, dcfg: DistConfig, device="cuda"):
    """The reference's optimizer state {"m", "v", "step"[, "ef"]} (numpy)
    -> the port's; m, v (and the error-feedback accumulator, which the
    state has exactly when `dcfg.needs_ef`) are checked like the storage,
    step becomes an int32 device scalar."""
    dev = resolve_device(device)
    keys = {"m", "v", "step"} | ({"ef"} if dcfg.needs_ef else set())
    if set(state) != keys:
        raise ValueError(
            f"opt_state: expected keys {sorted(keys)} (error feedback "
            f"exactly when comm_precision={dcfg.comm_precision!r} needs "
            f"it), got {sorted(state)}")
    out = {k: storage_from_jax(state[k], model, dcfg, dev)
           for k in ("m", "v", "ef") if k in keys}
    if "ef" in out:
        out["ef"] = tree_map(lambda a: a.to(torch.float32), out["ef"])
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=dev)
    return out

