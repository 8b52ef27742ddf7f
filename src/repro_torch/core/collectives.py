"""FSDP collectives: the paper's ``ReplicateComputation`` on
`torch.distributed` (port of `repro.core.collectives`).

Three layers, bottom-up:

  1. raw pack / all-gather / unpack / reduce-scatter helpers;
  2. `gather_group` — a `torch.autograd.Function` that gathers a GROUP of
     parameter shards (group of one == the paper's per-parameter
     parametrization; group of many == a bucket: one flat buffer, ONE
     all-gather, copy-out slices).  Its forward casts the shards to
     `param_dtype` (when `gather_in_param_dtype`) and all-gathers; its
     backward is the matching single reduce-scatter in `reduce_dtype`,
     divided by the data-parallel degree (Partial(avg)), cast back to the
     storage dtype;
  3. `replicate` / `replicate_tree` — per-parameter and bucketed wrappers.

At tp = pp = 1 the FSDP domain is every rank of the world, so the
collectives run on the default process group (`core/dist.make_mesh` made
or checked it).  They are real collectives at world size 1 too.  The
module counters `gathers` and `reduce_scatters` count the collectives
issued, so a test can see the remat policy re-gather in the backward.

Under ``remat="fsdp_only"`` (`core/remat.py`) the gathered tensors are
dropped after their forward use and gathered again in the backward: the
remat scope packs every saved tensor that lies in a gathered buffer as a
handle (`_Bucket`), and the first unpack in the backward re-issues that
bucket's all-gather once; the bucket's reduce-scatter releases it.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.dist import DistConfig
from repro_torch.core.meta import (ParamMeta, flatten_local, leaves,
                                   named_leaves, unflatten_like,
                                   unflatten_local)

gathers = 0
reduce_scatters = 0

# the single-tensor collectives (newer torch renames *_into_tensor /
# *_tensor to *_single)
all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _squeeze_tp(shard: torch.Tensor, meta: ParamMeta) -> torch.Tensor:
    """A TP param's shard is (1, chunk) -> (chunk,)."""
    return shard[0] if meta.tp_dim is not None else shard


# ---------------------------------------------------------------------------
# 1. Raw primitives (no autograd attached).
# ---------------------------------------------------------------------------
def pack_shards(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-param local chunks into one flat bucket buffer."""
    if len(shards) == 1:
        return shards[0].reshape(-1)
    return torch.cat([s.reshape(-1) for s in shards])


def gather_flat(buf: torch.Tensor, cfg: DistConfig) -> torch.Tensor:
    """One all-gather of the bucket buffer -> (fsdp_size, bucket_len)."""
    global gathers
    out = torch.empty((cfg.fsdp_size, buf.numel()), dtype=buf.dtype,
                      device=buf.device)
    all_gather_single(out.view(-1), buf.contiguous())
    gathers += 1
    return out


def unpack_gathered(g: torch.Tensor, metas: Sequence[ParamMeta],
                    cfg: DistConfig) -> list[torch.Tensor]:
    """Copy-out: slice the (fsdp, bucket_len) buffer back into params."""
    outs, off = [], 0
    for m in metas:
        chunk = m.chunk_len(cfg)
        outs.append(unflatten_local(g[:, off:off + chunk].reshape(-1), m,
                                    cfg))
        off += chunk
    return outs


def pack_grads(grads: Sequence[torch.Tensor], metas: Sequence[ParamMeta],
               cfg: DistConfig) -> torch.Tensor:
    """Copy-in: full TP-local grads -> (fsdp, bucket_len) RS layout."""
    cols = [flatten_local(g, m, cfg).reshape(cfg.fsdp_size, m.chunk_len(cfg))
            for g, m in zip(grads, metas)]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def reduce_scatter_flat(ct: torch.Tensor, cfg: DistConfig) -> torch.Tensor:
    """One reduce-scatter (sum) of the grad bucket -> local (bucket_len,)."""
    global reduce_scatters
    out = torch.empty(ct.shape[1], dtype=ct.dtype, device=ct.device)
    reduce_scatter_single(out, ct.contiguous().view(-1))
    reduce_scatters += 1
    return out


def gather_group_fwd_raw(shards: Sequence[torch.Tensor],
                         metas: Sequence[ParamMeta],
                         cfg: DistConfig) -> list[torch.Tensor]:
    """Pack -> one all-gather -> unpack; returns the compute tensors."""
    flats = [_squeeze_tp(s, m) for s, m in zip(shards, metas)]
    if cfg.gather_in_param_dtype:
        flats = [f.to(cfg.param_dtype) for f in flats]
    outs = unpack_gathered(gather_flat(pack_shards(flats), cfg), metas, cfg)
    if not cfg.gather_in_param_dtype:
        outs = [o.to(cfg.param_dtype) for o in outs]
    return outs


def reduce_group_bwd_raw(grads_full: Sequence[torch.Tensor],
                         metas: Sequence[ParamMeta], cfg: DistConfig,
                         shard_shapes: Sequence[tuple]) -> list[torch.Tensor]:
    """Pack grads -> one reduce-scatter in reduce_dtype, mean over the
    data-parallel ranks -> per-param local chunks in the storage dtype."""
    ct = pack_grads([g.to(cfg.reduce_dtype) for g in grads_full], metas, cfg)
    local = reduce_scatter_flat(ct, cfg) / cfg.dp_total
    outs, off = [], 0
    for m, ss in zip(metas, shard_shapes):
        chunk = m.chunk_len(cfg)
        outs.append(local[off:off + chunk].reshape(ss).to(m.dtype))
        off += chunk
    return outs


# ---------------------------------------------------------------------------
# 2. The differentiable bucket gather (paper's parametrization).
# ---------------------------------------------------------------------------
class _Bucket:
    """One gathered bucket under a `fsdp_only` remat scope: re-gathers on
    the first backward use, drops the re-gathered tensors at its
    reduce-scatter."""

    def __init__(self, shards, metas, cfg):
        self.shards, self.metas, self.cfg = shards, metas, cfg
        self.outs = None

    def regathered(self) -> list[torch.Tensor]:
        if self.outs is None:
            with torch.no_grad():
                self.outs = gather_group_fwd_raw(self.shards, self.metas,
                                                 self.cfg)
        return self.outs

    def release(self) -> None:
        self.outs = None


class RegatherScope:
    """Saved-tensor hooks that store any tensor lying in a gathered bucket
    as (bucket, output index, size, stride, offset) instead of keeping the
    gathered storage alive (`core/remat.py`, policy ``fsdp_only``)."""

    def __init__(self):
        self.storages: dict[tuple, tuple[_Bucket, int]] = {}

    @staticmethod
    def _key(t: torch.Tensor) -> tuple:
        return t.device, t.untyped_storage().data_ptr()

    def register(self, bucket: _Bucket, outs) -> None:
        for j, o in enumerate(outs):
            self.storages.setdefault(self._key(o), (bucket, j))

    def pack(self, t: torch.Tensor):
        hit = self.storages.get(self._key(t))
        if hit is None:
            return t
        bucket, j = hit
        return (bucket, j, t.size(), t.stride(), t.storage_offset())

    @staticmethod
    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        bucket, j, size, stride, offset = packed
        return bucket.regathered()[j].as_strided(size, stride, offset)


_SCOPES: list[RegatherScope] = []


@contextlib.contextmanager
def regather_scope():
    """Inside: gathered tensors that autograd saves are stored as handles
    and gathered again on their first backward use."""
    scope = RegatherScope()
    _SCOPES.append(scope)
    try:
        with torch.autograd.graph.saved_tensors_hooks(scope.pack,
                                                      scope.unpack):
            yield
    finally:
        _SCOPES.pop()


class _GatherGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, metas, cfg, bucket, *shards):
        ctx.metas, ctx.cfg, ctx.bucket = metas, cfg, bucket
        ctx.shard_shapes = [tuple(s.shape) for s in shards]
        return tuple(gather_group_fwd_raw(shards, metas, cfg))

    @staticmethod
    def backward(ctx, *cts):
        if ctx.bucket is not None:
            ctx.bucket.release()
        grads = reduce_group_bwd_raw(cts, ctx.metas, ctx.cfg,
                                     ctx.shard_shapes)
        return (None, None, None, *grads)


def gather_group(shards: Sequence[torch.Tensor], metas: Sequence[ParamMeta],
                 cfg: DistConfig) -> list[torch.Tensor]:
    """Gather one bucket of shards; d(outputs) -> reduce-scattered
    d(shards)."""
    scope = _SCOPES[-1] if _SCOPES else None
    bucket = _Bucket(tuple(shards), tuple(metas), cfg) if scope else None
    outs = _GatherGroup.apply(tuple(metas), cfg, bucket, *shards)
    if scope is not None:
        scope.register(bucket, outs)
    return list(outs)


# ---------------------------------------------------------------------------
# 3. Convenience wrappers.
# ---------------------------------------------------------------------------
def replicate(shard: torch.Tensor, meta: ParamMeta,
              cfg: DistConfig) -> torch.Tensor:
    """shard -> full TP-local tensor; d(full) -> reduce-scattered d(shard)."""
    (out,) = gather_group((shard,), (meta,), cfg)
    return out


def replicate_tree(shards_tree, metas_tree, cfg: DistConfig, plan=None):
    """Gather a whole tree of shards, bucketed per `plan` (a BucketPlan) or
    per-parameter when plan is None."""
    shard_leaves = leaves(shards_tree)
    metas = [m for _, m in named_leaves(metas_tree)]
    groups = plan.index_groups(metas_tree) if plan is not None \
        else [[i] for i in range(len(shard_leaves))]
    out: list = [None] * len(shard_leaves)
    for grp in groups:
        for i, g in zip(grp, gather_group([shard_leaves[i] for i in grp],
                                          [metas[i] for i in grp], cfg)):
            out[i] = g
    return unflatten_like(metas_tree, out)
