"""Host-side bookkeeping for the paged KV pool: the refcounted
shared-prefix cache.

The device side of paging (the page pool, the per-row page table, the
copy-on-write scatter) lives in ``models.transformer`` /
``models.attention``; this module owns the *host* policy half: which
page-aligned prompt prefixes are cached, who holds references to a
physical page, and which cache entries give their pages back under pool
pressure.

Sharing model (copy-on-write by construction, not by trapping writes):

  * a cache entry keys the hash of a prompt's first ``c * page_size``
    tokens and holds the page-id chain materializing exactly those
    tokens' K/V. Only *fully prompt-covered* pages are ever registered
    (``c * page_size <= len(prompt)``), and decode writes for the owning
    row land at positions ``>= len(prompt)`` — so a registered page is
    never written again by anyone, and "copy on write" degenerates to
    "never write a shared page; write your own suffix pages".
  * refcounts: every row using a page holds one ref, and every cache
    entry whose chain contains the page holds one ref. A page returns to
    the free list exactly at refcount zero — a row retiring releases its
    refs immediately, but pages a cache entry still references stay
    resident for future hits.
  * eviction is LRU over cache entries, triggered by the engine only
    under pool pressure (an allocation that would otherwise fail):
    popping an entry drops its refs, freeing whichever of its pages no
    live row still uses.

A *hit* on admission means the request's leading page-list entries point
at the shared pages and its prefill starts at ``c * page_size`` (the
engine gathers the shared pages into a flat view and runs
``prefill_extend`` over the suffix only). The lookup caps the usable
prefix at ``(len(prompt) - 1) // page_size`` pages: the last prompt
token's logits must still be computed to sample the first generated
token, so at least one suffix token always prefills.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Callable, Optional

import numpy as np


def _digest(prompt: np.ndarray, n_tokens: int) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(prompt[:n_tokens]).tobytes(),
                           digest_size=16).digest()


class PrefixCache:
    """Refcount-aware LRU map from page-aligned prompt-prefix hashes to
    physical page chains. Single-threaded (the engine's driver thread);
    ``stats()`` is safe to read from anywhere."""

    def __init__(self, page_size: int, max_entries: int = 512):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self._ps = page_size
        self._max = max_entries
        # key -> tuple of physical page ids (the chain holds one ref per
        # page; insertion order doubles as LRU order via move_to_end).
        self._entries: "collections.OrderedDict[bytes, tuple[int, ...]]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray) -> list[int]:
        """Longest cached page chain covering a strict prefix of
        ``prompt``. Returns the physical page ids ([] = miss). The caller
        owns taking a ref on each returned page."""
        c_max = (len(prompt) - 1) // self._ps
        for c in range(c_max, 0, -1):
            chain = self._entries.get(_digest(prompt, c * self._ps))
            if chain is not None:
                self._entries.move_to_end(_digest(prompt, c * self._ps))
                self.hits += 1
                return list(chain)
        self.misses += 1
        return []

    def insert(self, prompt: np.ndarray, row_pages: list[int],
               incref: Callable[[int], None],
               decref: Callable[[int], None]) -> None:
        """Register every page-aligned prefix of ``prompt`` that the
        row's pages fully cover. Chains for prefixes already cached are
        just touched (their pages are the shared ones the row reused)."""
        for c in range(1, len(prompt) // self._ps + 1):
            key = _digest(prompt, c * self._ps)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            chain = tuple(row_pages[:c])
            for pid in chain:
                incref(pid)
            self._entries[key] = chain
            while len(self._entries) > self._max:
                self.evict_one(decref)

    def evict_one(self, decref: Callable[[int], None]) -> bool:
        """Drop the least-recently-used entry, releasing its page refs
        (pages only actually free once no live row uses them). Returns
        False when the cache is empty."""
        if not self._entries:
            return False
        _, chain = self._entries.popitem(last=False)
        for pid in chain:
            decref(pid)
        self.evictions += 1
        return True

    def clear(self, decref: Callable[[int], None]) -> None:
        while self._entries:
            _, chain = self._entries.popitem(last=False)
            for pid in chain:
                decref(pid)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}
