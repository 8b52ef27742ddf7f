"""Paged KV cache: fixed-size pages in a pooled arena (port of
`repro.core.serving.pages`).

Layout: every cache leaf the dense prefill emits as ``(L, B, T, *rest)``
becomes an arena pool leaf ``(L, dp_shards * (n_pages_local + 1), page,
*rest)``: each data shard owns its own pool (page ids are local to the
shard), and the last pool row of every shard is a scratch page that
inactive batch rows (page-table entries -1) write to and nothing reads.
The port serves at world size 1, so there is one shard; the layout math
takes any `dp_shards`, as the planners do.

Device side (called from `models/dense.py::_kv_writer`):
`scatter_tokens` commits new K/V IN PLACE at the slots the page table maps
logical positions to; `gather_tokens` reads the table's full logical
window back as a dense (B, max_pages*page, ...) view: for every allocated
position it holds exactly what the dense cache holds, which is what makes
paged-vs-dense decode parity-checkable bit for bit.  Both take index
tensors that `scatter_index` / `gather_index` build once a step.  fp8
leaves are indexed through a byte view (the copies move bits only).

Host side: `PagePool` (free list + refcounts, shared pages for the prefix
cache), `dense_to_pages` (repage a prefilled dense cache into an arena on
the cache's device: the load path and the parity harness),
`arena_abstract` (the arena's shapes and dtypes from the dense cache's).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Cache trees: (k, v) tuples, gemma2's ((k, v), (k, v)), codec dicts
# ---------------------------------------------------------------------------
def kv_map(fn, tree, *rest):
    """Maps `fn` over the tensor leaves of parallel cache trees (tuples,
    lists and dicts)."""
    if isinstance(tree, dict):
        return {k: kv_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(kv_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def kv_leaves(tree) -> list:
    """The leaves of a cache tree, in `kv_map` order."""
    out = []
    kv_map(out.append, tree)
    return out


def _raw(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors indexed as bytes: gathers and scatters move bits only."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeroed tensor; fp8 through a byte tensor (0x00 is +0.0 in e4m3)."""
    if dtype == torch.float8_e4m3fn:
        return torch.zeros(shape, dtype=torch.uint8,
                           device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Device gather/scatter over page indices
# ---------------------------------------------------------------------------
def scatter_index(table: torch.Tensor, qpos: torch.Tensor, page: int,
                  n_rows: int):
    """(pool row, slot) of each (B, C) logical position: table (B,
    max_pages) local page ids, -1 = unallocated, routed to the scratch row
    `n_rows - 1` so inactive rows never corrupt live pages."""
    table, qpos = table.long(), qpos.long()
    ib = torch.arange(qpos.shape[0], device=qpos.device)[:, None]
    pid = table[ib, (qpos // page).clamp(0, table.shape[1] - 1)]
    pid = torch.where(pid < 0, n_rows - 1, pid)
    return pid, qpos % page


def gather_index(table: torch.Tensor, page: int, n_rows: int):
    """Flat pool-token index (B * max_pages * page,) of the table's logical
    window; unallocated entries read pool row 0 (clipped), which callers
    mask by position."""
    safe = table.long().clamp(0, n_rows - 1)
    idx = safe[:, :, None] * page + torch.arange(page, device=table.device)
    return idx.reshape(-1)


def put_tokens(pool, pid, slot, val):
    """pool[pid, slot] = val, in place (duplicate scratch targets: any one
    of the writers wins; nothing reads the scratch row)."""
    _raw(pool).index_put_((pid, slot), _raw(val.to(pool.dtype)))
    return pool


def put_layer(leaf, i: int, val) -> None:
    """leaf[i, :, :S] = val (B, S, ...), in place: a prefill's layer into
    the first S positions of a stacked cache (L, B, T, ...)."""
    _raw(leaf[i, :, :val.shape[1]]).copy_(_raw(val.to(leaf.dtype)))


def take_tokens(pool, idx, batch: int):
    """Rows `idx` of the pool's flat token view as (batch, -1, *rest)."""
    flat = _raw(pool).reshape(pool.shape[0] * pool.shape[1],
                              *pool.shape[2:])
    out = flat.index_select(0, idx).reshape(batch, -1, *pool.shape[2:])
    return out.view(pool.dtype) if out.dtype != pool.dtype else out


def scatter_tokens(pool, table, qpos, val, page: int):
    """Commit val (B, C, *rest) at logical positions qpos (B, C), in place.

    pool: (n_pages+1, page, *rest), last row = scratch; table: (B,
    max_pages) int local page ids, -1 = unallocated.  Returns the pool."""
    pid, slot = scatter_index(table, qpos, page, pool.shape[0])
    return put_tokens(pool, pid, slot, val)


def gather_tokens(pool, table, page: int):
    """Read the table's logical window: (B, max_pages*page, *rest).

    Unallocated entries gather pool row 0; callers mask by position, and
    the scheduler's invariant (every position <= pos is backed by an
    allocated page) keeps the masked-in region exact."""
    return take_tokens(pool, gather_index(table, page, pool.shape[0]),
                       table.shape[0])


# ---------------------------------------------------------------------------
# Abstract arena layout (plan time)
# ---------------------------------------------------------------------------
def arena_abstract(cache_abs, n_pages_local: int, page: int,
                   dp_shards: int):
    """The arena's leaves (tensors on the meta device: shapes and dtypes)
    from the dense cache's: each leaf (L, B, T, *rest) -> (L,
    dp_shards*(n_pages_local+1), page, *rest).  The reference also returns
    the partition specs, which apply unchanged (dim 1 rides the data axes
    for pages as for the batch); the port has no specs."""
    np_global = dp_shards * (n_pages_local + 1)
    return kv_map(lambda a: torch.empty(
        (a.shape[0], np_global, page, *a.shape[3:]), dtype=a.dtype,
        device="meta"), cache_abs)


# ---------------------------------------------------------------------------
# Host page pool
# ---------------------------------------------------------------------------
class PagePool:
    """Free-list + refcount page allocator for ONE data shard's pool.

    Pages are the unit of both allocation and sharing: the prefix cache
    retains full pages by bumping refcounts, so `release` only returns a
    page to the free list when its last reference drops.  The scratch
    page is NOT managed here: it sits past `n_pages` in the arena."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._ref = np.zeros(n_pages, dtype=np.int64)

    @property
    def used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages (refcount 1 each) or None, never partial."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._ref[ids] = 1
        return ids

    def retain(self, pid: int) -> None:
        assert self._ref[pid] > 0, f"retain of free page {pid}"
        self._ref[pid] += 1

    def release(self, pid: int) -> bool:
        """Drop one reference; True when the page actually freed."""
        assert self._ref[pid] > 0, f"release of free page {pid}"
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            return True
        return False

    def release_all(self, pids) -> None:
        for p in pids:
            self.release(p)

    def check(self) -> None:
        """Invariant: every page is exactly free or referenced."""
        free = set(self._free)
        assert len(free) == len(self._free), "double-free"
        for pid in range(self.n_pages):
            assert (pid in free) == (self._ref[pid] == 0), pid


# ---------------------------------------------------------------------------
# Repage a dense cache: the load path and the parity harness
# ---------------------------------------------------------------------------
def dense_to_pages(cache, lengths, page: int, n_pages_local: int,
                   max_pages: int, dp_shards: int = 1):
    """Scatter a prefilled dense cache into a fresh arena on its device.

    cache: tree of (L, B, T, *rest) tensors; lengths: (B,) valid prefix per
    sequence.  Rows are dealt to data shards contiguously (shard = b //
    (B/dp_shards)) and each shard allocates from its own pool, so the
    returned table holds LOCAL page ids.  Returns (arena tree, tables (B,
    max_pages) int32 on the cache's device, pools per shard)."""
    leaves = kv_leaves(cache)
    B = leaves[0].shape[1]
    dev = leaves[0].device
    assert B % dp_shards == 0
    rows_per = B // dp_shards
    pools = [PagePool(n_pages_local) for _ in range(dp_shards)]
    np1 = n_pages_local + 1
    tables = np.full((B, max_pages), -1, dtype=np.int32)
    # one (arena row, batch row, first position, count) copy per page
    copies = []
    for b in range(B):
        shard = b // rows_per
        n = int(lengths[b])
        n_needed = -(-n // page) if n else 0
        assert n_needed <= max_pages, (b, lengths[b])
        ids = pools[shard].alloc(n_needed)
        assert ids is not None, "arena too small for dense_to_pages"
        for j, pid in enumerate(ids):
            tables[b, j] = pid
            copies.append((shard * np1 + pid, b, j * page,
                           min(page, n - j * page)))

    def repage(lf):
        out = zeros((lf.shape[0], dp_shards * np1, page, *lf.shape[3:]),
                    lf.dtype, dev)
        dst, src = _raw(out), _raw(lf)
        for row, b, lo, m in copies:
            dst[:, row, :m] = src[:, b, lo:lo + m]
        return out

    arena = kv_map(repage, cache)
    return arena, torch.from_numpy(tables).to(dev), pools
