"""Parameter metadata and the ZeRO-3 storage layout (port of
`repro.core.meta`).

The layout is the reference's, byte for byte, so storage moves between the
two packages as plain arrays:

  * every parameter is flattened (per TP rank), padded to a multiple of
    ``fsdp_size * LANE`` and sharded 1-D over the FSDP ranks;
  * TP-sharded parameters carry an explicit leading ``tp`` index axis in
    storage, ``(tp, padded_flat)``; it is 1 in the port (tp = 1);
  * layer-stacked parameters get a leading ``L`` axis on top of that.

A rank holds the contiguous chunk ``[rank * chunk, (rank + 1) * chunk)`` of
the padded flat axis.  `to_storage` / `from_storage` are exact inverses.
Trees are nested dicts; `named_leaves` walks them in sorted-key order with
'/'-joined names, which is the reference's pytree flatten order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.dist import DistConfig

LANE = 128  # pad flat shards so per-rank chunks are lane-aligned


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    name: str
    global_shape: tuple[int, ...]     # logical full shape (after head padding)
    tp_dim: int | None = None         # which logical dim is TP-sharded
    dtype: torch.dtype = torch.float32  # storage (master) dtype

    def local_shape(self, cfg: DistConfig) -> tuple[int, ...]:
        """TP-local compute shape (what the model sees after the gather)."""
        if self.tp_dim is None:
            return self.global_shape
        s = list(self.global_shape)
        if s[self.tp_dim] % cfg.tp_size:
            raise ValueError(f"{self.name}: dim {self.tp_dim} ({s[self.tp_dim]})"
                             f" not divisible by tp={cfg.tp_size}")
        s[self.tp_dim] //= cfg.tp_size
        return tuple(s)

    def numel_local(self, cfg: DistConfig) -> int:
        return math.prod(self.local_shape(cfg))

    def padded_len(self, cfg: DistConfig) -> int:
        quantum = cfg.fsdp_size * LANE
        return -(-self.numel_local(cfg) // quantum) * quantum

    def chunk_len(self, cfg: DistConfig) -> int:
        return self.padded_len(cfg) // cfg.fsdp_size

    def storage_shape(self, cfg: DistConfig) -> tuple[int, ...]:
        if self.tp_dim is None:
            return (self.padded_len(cfg),)
        return (cfg.tp_size, self.padded_len(cfg))

    def shard_shape(self, cfg: DistConfig) -> tuple[int, ...]:
        """One rank's part of the storage."""
        if self.tp_dim is None:
            return (self.chunk_len(cfg),)
        return (1, self.chunk_len(cfg))


# --------------------------------------------------------------------------
# Layout transforms (exact inverses).
# --------------------------------------------------------------------------
def to_storage(full: torch.Tensor, meta: ParamMeta,
               cfg: DistConfig) -> torch.Tensor:
    """Logical full param -> storage layout (flat/padded/TP-stacked), in
    the meta's dtype."""
    full = full.to(meta.dtype)
    if tuple(full.shape) != meta.global_shape:
        raise ValueError(f"{meta.name}: expected {meta.global_shape}, got "
                         f"{tuple(full.shape)}")
    pad = meta.padded_len(cfg)
    if meta.tp_dim is None:
        flat = full.reshape(-1)
        return torch.nn.functional.pad(flat, (0, pad - flat.numel()))
    tp = cfg.tp_size
    moved = full.movedim(meta.tp_dim, 0)
    blk = moved.reshape(tp, moved.shape[0] // tp, *moved.shape[1:])
    flat = blk.movedim(1, meta.tp_dim + 1).reshape(tp, -1)
    return torch.nn.functional.pad(flat, (0, pad - flat.shape[1]))


def from_storage(storage: torch.Tensor, meta: ParamMeta,
                 cfg: DistConfig) -> torch.Tensor:
    """Inverse of `to_storage`."""
    local = meta.local_shape(cfg)
    n = meta.numel_local(cfg)
    if meta.tp_dim is None:
        return storage[:n].reshape(local)
    tp = cfg.tp_size
    blk = storage[:, :n].reshape(tp, *local).movedim(meta.tp_dim + 1, 1)
    merged = blk.reshape(tp * blk.shape[1], *blk.shape[2:])
    return merged.movedim(0, meta.tp_dim)


def unflatten_local(flat: torch.Tensor, meta: ParamMeta,
                    cfg: DistConfig) -> torch.Tensor:
    """Gathered padded flat (padded_len,) -> TP-local compute tensor."""
    return flat[: meta.numel_local(cfg)].reshape(meta.local_shape(cfg))


# --------------------------------------------------------------------------
# Tree helpers: params, metas, grads and moments travel as nested dicts.
# --------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """Maps `fn` over the leaves of parallel nested dicts (params, metas and
    caches travel as such trees, keyed like the reference's pytrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def named_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) in the reference's flatten order: sorted keys, names
    joined with '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(named_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def unflatten_like(template, values) -> dict:
    """A tree shaped like `template` whose leaves, in `named_leaves` order,
    are `values`."""
    return _build(template, iter(values))


def _build(t, it):
    # module level, not a closure: a self-referencing inner function forms
    # a reference cycle that holds `values` (a step's whole gradient tree)
    # until Python's cycle collector happens to run
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def abstract_storage(metas, cfg: DistConfig, n_layers: int | None = None):
    """Storage-layout tensors on the meta device (shapes and dtypes only)."""
    def one(m: ParamMeta):
        shape = m.storage_shape(cfg)
        if n_layers is not None:
            shape = (n_layers, *shape)
        return torch.empty(shape, dtype=m.dtype, device="meta")
    return tree_map(one, metas)
