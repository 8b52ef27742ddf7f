"""Prefix caching via page-table sharing (port of
`repro.core.serving.prefix`; host code, unchanged).

Only FULL pages are shareable: a page is immutable once all `page` slots
are written (decode only ever appends past it), so two sequences whose
prompts agree on the first k*page tokens can point their first k page-
table entries at the same pool pages.  The cache holds one reference per
cached page (PagePool refcounts), sequences holding a hit add their own,
and release drops back to the cache's reference — nothing is copied.

Keys are hash-chains over page-sized token chunks, so lookup walks the
longest cached prefix in O(pages).  Eviction is LRU, deepest chain
entries first (evicting a parent strands its children until their own
LRU turn — they stay refcounted, just unreachable; documented cost of
keeping the structure a flat map instead of a trie)."""

from __future__ import annotations

from collections import OrderedDict


def _chain_keys(prompt, page: int):
    """Hash-chain keys for each FULL page of the prompt."""
    keys = []
    k = ()
    for j in range(len(prompt) // page):
        k = (k, tuple(prompt[j * page:(j + 1) * page]))
        keys.append(k)
    return keys


class PrefixCache:
    def __init__(self, capacity_pages: int | None = None):
        self.capacity = capacity_pages
        self._lru: OrderedDict = OrderedDict()   # key -> page id
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._lru)

    def lookup(self, prompt, pool, page: int) -> list[int]:
        """Longest cached full-page prefix of `prompt`; retains every
        returned page on behalf of the caller's sequence."""
        out = []
        for key in _chain_keys(prompt, page):
            pid = self._lru.get(key)
            if pid is None:
                self.misses += 1
                break
            self._lru.move_to_end(key)
            pool.retain(pid)
            out.append(pid)
            self.hits += 1
        return out

    def insert(self, prompt, table, pool, page: int) -> int:
        """Cache the full prompt pages of a finished/prefilled sequence
        (retaining them) — call BEFORE the sequence releases its table.
        Returns how many new pages were cached."""
        added = 0
        for j, key in enumerate(_chain_keys(prompt, page)):
            if j >= len(table):
                break
            if key in self._lru:
                self._lru.move_to_end(key)
                continue
            pool.retain(table[j])
            self._lru[key] = table[j]
            added += 1
        if self.capacity is not None:
            self.reclaim(pool, max(0, len(self._lru) - self.capacity))
        return added

    def reclaim(self, pool, n: int) -> int:
        """Release up to n cached pages (LRU-first, deepest chains first
        among equally-stale entries) back to the pool.  Returns how many
        pages actually went back to the free list."""
        freed = 0
        for _ in range(min(n, len(self._lru))):
            key, pid = self._lru.popitem(last=False)
            if pool.release(pid):
                freed += 1
        return freed
