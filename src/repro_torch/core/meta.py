"""Parameter metadata (the `ParamMeta` record of `repro.core.meta`).

The serving port keeps parameters as logical full tensors, so only the
logical description is carried: no flat ZeRO-3 storage layout yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    name: str
    global_shape: tuple[int, ...]     # logical full shape (after head padding)
    tp_dim: int | None = None         # which logical dim is TP-sharded
    dtype: torch.dtype = torch.float32


def tree_map(fn, tree, *rest):
    """Maps `fn` over the leaves of parallel nested dicts (params, metas and
    caches travel as such trees, keyed like the reference's pytrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
