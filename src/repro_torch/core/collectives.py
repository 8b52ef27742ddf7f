"""FSDP collectives: the paper's ``ReplicateComputation`` on
`torch.distributed` (port of `repro.core.collectives`).

Three layers, bottom-up:

  1. raw pack / all-gather / unpack / reduce-scatter helpers, and the
     forward / backward halves a bucket's collectives are built from
     (`gather_group_start` and `pack_grad_bucket` + `finalize_grad_bucket`,
     which `core/stack.py`'s prefetch schedule issues at separate points,
     as async collectives);
  2. `gather_group` — a `torch.autograd.Function` that gathers a GROUP of
     parameter shards (group of one == the paper's per-parameter
     parametrization; group of many == a bucket: one flat buffer, ONE
     all-gather, copy-out slices).  Its forward casts the shards to
     `param_dtype` (when `gather_in_param_dtype`) and all-gathers; its
     backward is the matching single reduce-scatter in `rs_dtype`,
     divided by the data-parallel degree (Partial(avg)), cast back to the
     storage dtype;
  3. `replicate` / `replicate_tree` — per-parameter and bucketed wrappers.

Quantized collectives (`DistConfig.comm_precision`; every collective
takes a `precision` argument, None = the config's; the bucketed paths pass
each bucket's own, `BucketPlan.group_precisions`, which the per-bucket
planner of `comm_precision="auto"` sets): the all-gather round-trips the
packed buffer through the wire codec with round-to-nearest before the
gather (every rank decodes identical params), the reduce-scatter round-trips the packed
(fsdp, len) gradient buffer with stochastic rounding before the reduce
(`kernels/quant`: the CUDA kernels on the card).  Decoding commutes with
the gather and with a sum of contributions each quantized once, so the
local round-trip is what the wire would deliver.  The reference packs the
TP-sharded and the TP-replicated params of a bucket into separate buffers
(`_vma_classes`); the port's one collective carries the whole bucket.
The gradient buffer holds the classes' column blocks side by side, and
the stochastic codec round-trips each block in place as the reference's
own (fsdp, len) class buffer (the seed and the flat index depend on it);
the round-to-nearest codec is chunk-local, so one pass over the bucket
gives the same bytes.

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

from repro_torch.core.dist import DistConfig, precision_codecs
from repro_torch.core.meta import (ParamMeta, leaves, named_leaves,
                                   unflatten_like, unflatten_local)
from repro_torch.kernels.quant import ops as quant_ops

gathers = 0
reduce_scatters = 0

# the single-tensor collectives (newer torch renames *_into_tensor /
# *_tensor to *_single)
all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def default_precision(cfg: DistConfig) -> str:
    """The wire precision of a collective whose bucket carries none: the
    config's own, with 'auto' degrading to bf16."""
    return "bf16" if cfg.comm_precision == "auto" else cfg.comm_precision


def _vma_classes(metas: Sequence[ParamMeta]) -> list[list[int]]:
    """A bucket's TP-sharded and TP-replicated params, each class in
    order, classes in order of first appearance (the reference's buffer
    split)."""
    cls: dict[bool, list[int]] = {}
    for i, m in enumerate(metas):
        cls.setdefault(m.tp_dim is not None, []).append(i)
    return list(cls.values())


def _squeeze_tp(shard: torch.Tensor, meta: ParamMeta) -> torch.Tensor:
    """A TP param's shard is (1, chunk) -> (chunk,)."""
    return shard[0] if meta.tp_dim is not None else shard


# ---------------------------------------------------------------------------
# 1. Raw primitives (no autograd attached).
# ---------------------------------------------------------------------------
def pack_shards(shards: Sequence[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """Concatenate per-param local chunks into one flat bucket buffer in
    `dtype`, each chunk cast while it is copied in."""
    if len(shards) == 1 and shards[0].dtype == dtype:
        return shards[0].reshape(-1)
    out = torch.empty(sum(s.numel() for s in shards), dtype=dtype,
                      device=shards[0].device)
    off = 0
    for s in shards:
        out[off:off + s.numel()].copy_(s.reshape(-1))
        off += s.numel()
    return out


def gather_flat(buf: torch.Tensor, cfg: DistConfig, async_op: bool = False):
    """One all-gather of the bucket buffer -> ((fsdp_size, bucket_len), the
    collective's `Work` to wait on before use when `async_op`, else None)."""
    global gathers
    out = torch.empty((cfg.fsdp_size, buf.numel()), dtype=buf.dtype,
                      device=buf.device)
    work = all_gather_single(out.view(-1), buf.contiguous(),
                             async_op=async_op)
    gathers += 1
    return out, work


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
               cfg: DistConfig, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """Copy-in: full TP-local grads -> (fsdp, bucket_len) RS layout in
    `dtype` (the grads' own by default).  Each grad is copied (and cast)
    once, straight into its column block: row r of the block is the r-th
    `chunk_len` run of the grad flattened and zero-padded to `padded_len`,
    so no cast, padded or per-param copy is made besides the buffer."""
    chunks = [m.chunk_len(cfg) for m in metas]
    out = torch.empty((cfg.fsdp_size, sum(chunks)),
                      dtype=dtype or grads[0].dtype, device=grads[0].device)
    off = 0
    for g, m, chunk in zip(grads, metas, chunks):
        flat, n = g.reshape(-1), m.numel_local(cfg)
        full, rem = divmod(n, chunk)
        blk = out[:, off:off + chunk]
        blk[:full].copy_(flat[:full * chunk].view(full, chunk))
        if full < cfg.fsdp_size:      # the padding is zeros
            blk[full:].zero_()
            blk[full, :rem].copy_(flat[full * chunk:])
        off += chunk
    return out


def reduce_scatter_flat(ct: torch.Tensor, cfg: DistConfig,
                        async_op: bool = False):
    """One reduce-scatter (sum) of the grad bucket -> (local (bucket_len,),
    the collective's `Work` when `async_op`, else None)."""
    global reduce_scatters
    out = torch.empty(ct.shape[1], dtype=ct.dtype, device=ct.device)
    work = reduce_scatter_single(out, ct.contiguous().view(-1),
                                 async_op=async_op)
    reduce_scatters += 1
    return out, work


# ---------------------------------------------------------------------------
# Forward / backward halves shared by `gather_group` and core/stack.py.
# ---------------------------------------------------------------------------
class GatherWork:
    """An issued bucket all-gather.  Holds the collective's `Work`, its
    input and its output until `wait`, which returns the compute tensors."""

    def __init__(self, work, buf, out, metas, cfg):
        self.work, self.buf, self.out = work, buf, out
        self.metas, self.cfg = metas, cfg

    def wait(self) -> list[torch.Tensor]:
        if self.work is not None:
            self.work.wait()
        self.work = self.buf = None
        outs = unpack_gathered(self.out, self.metas, self.cfg)
        if not self.cfg.gather_in_param_dtype:
            outs = [o.to(self.cfg.param_dtype) for o in outs]
        return outs


def gather_group_start(shards: Sequence[torch.Tensor],
                       metas: Sequence[ParamMeta], cfg: DistConfig,
                       precision: str | None = None,
                       async_op: bool = False) -> GatherWork:
    """Pack -> codec round-trip (RTN) -> one all-gather, issued; `.wait()`
    unpacks the compute tensors.

    `precision` is the bucket's wire precision (None = the config's)."""
    ag_codec, _ = precision_codecs(precision or default_precision(cfg))
    flats = [_squeeze_tp(s, m) for s, m in zip(shards, metas)]
    buf = pack_shards(flats, cfg.param_dtype if cfg.gather_in_param_dtype
                      else flats[0].dtype)
    # RTN is chunk-local and every param's chunk is a whole number of
    # QCHUNK = LANE groups, so one round-trip over the bucket equals the
    # reference's one per class buffer, bit for bit
    buf = quant_ops.roundtrip(buf, ag_codec, stochastic=False)
    out, work = gather_flat(buf, cfg, async_op)
    return GatherWork(work, buf, out, metas, cfg)


def rs_dtype(cfg: DistConfig) -> torch.dtype:
    """The reduce-scatter's dtype: bf16 under `grad_compression` (summed
    in bf16, accumulated in reduce_dtype afterwards), else reduce_dtype."""
    return torch.bfloat16 if cfg.grad_compression else cfg.reduce_dtype


def pack_grad_bucket(grads_full: Sequence[torch.Tensor],
                     metas: Sequence[ParamMeta],
                     cfg: DistConfig) -> torch.Tensor:
    """Copy-in: full TP-local grads -> one (fsdp, len) buffer in rs_dtype,
    its columns class by class (`_vma_classes`)."""
    order = [i for idxs in _vma_classes(metas) for i in idxs]
    return pack_grads([grads_full[i] for i in order],
                      [metas[i] for i in order], cfg, rs_dtype(cfg))


class ReduceWork:
    """An issued bucket reduce-scatter.  `wait` returns the per-param
    local grad chunks (mean over the data-parallel ranks) in the storage
    dtype."""

    def __init__(self, work, ct, out, metas, cfg, shard_shapes):
        self.work, self.ct, self.out = work, ct, out
        self.metas, self.cfg, self.shard_shapes = metas, cfg, shard_shapes

    def wait(self) -> list[torch.Tensor]:
        if self.work is not None:
            self.work.wait()
        self.work = self.ct = None
        cfg = self.cfg
        # Partial(avg): with a per-rank local-mean loss this is the
        # global-batch mean gradient
        local = self.out.to(cfg.reduce_dtype) / cfg.dp_total
        outs: list = [None] * len(self.metas)
        off = 0
        for i in (i for idxs in _vma_classes(self.metas) for i in idxs):
            m = self.metas[i]
            chunk = m.chunk_len(cfg)
            outs[i] = local[off:off + chunk].reshape(
                self.shard_shapes[i]).to(m.dtype)
            off += chunk
        return outs


def finalize_grad_bucket(ct: torch.Tensor, metas: Sequence[ParamMeta],
                         cfg: DistConfig, shard_shapes: Sequence[tuple],
                         precision: str | None = None,
                         async_op: bool = False) -> ReduceWork:
    """Codec round-trip (stochastic) of each class's block of the packed
    buffer, in place -> one reduce-scatter of the bucket, issued; `.wait()`
    returns the local grad chunks."""
    _, rs_codec = precision_codecs(precision or default_precision(cfg))
    if rs_codec is not None:
        off = 0
        for idxs in _vma_classes(metas):
            n = sum(metas[i].chunk_len(cfg) for i in idxs)
            block = ct[:, off:off + n]
            # a view when the block is contiguous (one class, or one rank)
            buf = block.contiguous()
            quant_ops.roundtrip(buf, rs_codec, stochastic=True, out=buf)
            block.copy_(buf)
            off += n
    out, work = reduce_scatter_flat(ct, cfg, async_op)
    return ReduceWork(work, ct, out, metas, cfg, shard_shapes)


def reduce_group_bwd_raw(grads_full: Sequence[torch.Tensor],
                         metas: Sequence[ParamMeta], cfg: DistConfig,
                         shard_shapes: Sequence[tuple],
                         precision: str | None = None) -> list[torch.Tensor]:
    """Pack grads -> one reduce-scatter (mean) -> per-param local chunks in
    the storage dtype."""
    return finalize_grad_bucket(pack_grad_bucket(grads_full, metas, cfg),
                                metas, cfg, shard_shapes, precision).wait()


# ---------------------------------------------------------------------------
# 2. The differentiable bucket gather (paper's parametrization).
# ---------------------------------------------------------------------------
class _Bucket:
    """One gathered bucket under a `fsdp_only` remat scope: re-gathers on
    the first backward use, drops the re-gathered tensors at its
    reduce-scatter."""

    def __init__(self, shards, metas, cfg, precision):
        self.shards, self.metas, self.cfg = shards, metas, cfg
        self.precision = precision
        self.outs = None

    def regathered(self) -> list[torch.Tensor]:
        if self.outs is None:
            with torch.no_grad():
                self.outs = gather_group_start(self.shards, self.metas,
                                               self.cfg,
                                               self.precision).wait()
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
    def forward(ctx, metas, cfg, precision, bucket, *shards):
        ctx.metas, ctx.cfg, ctx.bucket = metas, cfg, bucket
        ctx.precision = precision
        ctx.shard_shapes = [tuple(s.shape) for s in shards]
        return tuple(gather_group_start(shards, metas, cfg,
                                        precision).wait())

    @staticmethod
    def backward(ctx, *cts):
        if ctx.bucket is not None:
            ctx.bucket.release()
        grads = reduce_group_bwd_raw(cts, ctx.metas, ctx.cfg,
                                     ctx.shard_shapes, ctx.precision)
        return (None, None, None, None, *grads)


def gather_group(shards: Sequence[torch.Tensor], metas: Sequence[ParamMeta],
                 cfg: DistConfig,
                 precision: str | None = None) -> list[torch.Tensor]:
    """Gather one bucket of shards at `precision` (None = the config's);
    d(outputs) -> reduce-scattered d(shards)."""
    scope = _SCOPES[-1] if _SCOPES else None
    bucket = _Bucket(tuple(shards), tuple(metas), cfg, precision) \
        if scope else None
    outs = _GatherGroup.apply(tuple(metas), cfg, precision, bucket, *shards)
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
    """Gather a whole tree of shards, bucketed per `plan` (a BucketPlan,
    each bucket at its own precision) or per-parameter at the config's
    precision when plan is None."""
    shard_leaves = leaves(shards_tree)
    metas = [m for _, m in named_leaves(metas_tree)]
    if plan is None:
        groups = [[i] for i in range(len(shard_leaves))]
        precisions = [default_precision(cfg)] * len(groups)
    else:
        groups = plan.index_groups(metas_tree)
        precisions = plan.group_precisions(metas_tree, cfg)
    out: list = [None] * len(shard_leaves)
    for grp, prec in zip(groups, precisions):
        for i, g in zip(grp, gather_group([shard_leaves[i] for i in grp],
                                          [metas[i] for i in grp], cfg,
                                          prec)):
            out[i] = g
    return unflatten_like(metas_tree, out)
