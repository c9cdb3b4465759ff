"""Refcounted page pool: shared ownership over the paged KV tensors —
counterpart of ``paddle_tpu/kvcache/pool.py``.

``ops.paged_attention.PagedKVCacheManager`` hands every page to exactly
one sequence and returns it to the free list on ``free()``. Prefix reuse
needs three states, so this subclass turns the pool into a
reference-counted cache:

* **live** — refcount > 0: one page may back MANY sequences at once
  (``allocate(..., shared=...)`` increments instead of popping the free
  list);
* **cached** — refcount == 0 but held by the radix tree (:mod:`.radix`):
  resident, reusable, evictable under pressure;
* **free** — on the free list.

The conservation invariant the whole subsystem is anchored on::

    free + live + cached(ref==0)  ==  num_pages - 1      (page 0 reserved)

is checked by :meth:`check_conservation` (the serving engine runs it
after every step when the cache is enabled), together with: refcounts
never negative, refcounts exactly equal to block-table occurrences, and
the three sets pairwise disjoint.

Copy-on-write lives here too (:meth:`copy_page`): when a new sequence's
suffix must write INTO a shared page (full-prompt cache hit — the last
prompt token is recomputed to produce logits, and its slot sits
mid-page), the cache layer copies the page on the device and the
sequence appends into its private copy; the original stays immutable
for other sharers.

The speculative tail (``grow_to``, ``truncate_pages``) takes and
returns pages under shared ownership. Page migration (the prefill ->
decode KV handoff, ``PrefixCache.import_prefix``) stages pages with
``take_free_pages`` / ``give_back_pages`` and moves one page's slabs
with ``export_page`` (device -> host numpy) and ``write_page`` (host ->
the pool, in place on the current stream: the engines' CUDA graphs keep
the pool's addresses, so nothing is captured again).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set

from ..core.host_arrays import from_host, to_host
from ..ops.paged_attention import HeadShards, PagedKVCacheManager


class RefcountedKVCacheManager(PagedKVCacheManager):
    """See module docstring. Drop-in for ``PagedKVCacheManager`` — the
    exclusive-ownership surface (``allocate``/``extend``/``free``/
    ``block_tables``) keeps its contract; sharing is opt-in per call."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._refs: Dict[int, int] = {}     # page -> live refcount (> 0)
        self._cached: Set[int] = set()      # pages owned by the radix tree

    # -- allocation with sharing --------------------------------------------

    def allocate(self, seq_id, n_tokens: int,
                 shared: Sequence[int] = ()) -> List[int]:
        """Reserve pages for ``n_tokens``; the leading ``shared`` pages are
        borrowed (refcount bumped, NOT popped from the free list) and only
        the remainder comes from free pages. Block table = shared + owned."""
        need = self.pages_for(n_tokens) - len(shared)
        if need < 0:
            raise ValueError(
                f"{len(shared)} shared pages exceed the "
                f"{self.pages_for(n_tokens)} this sequence spans")
        if len(self._free) < need:
            self._oom("allocate", need)
            raise MemoryError(
                f"KV pool exhausted: need {need} pages, "
                f"{len(self._free)} free")
        table = [int(p) for p in shared]
        for p in table:
            self._refs[p] = self._refs.get(p, 0) + 1
        for _ in range(need):
            p = self._free.pop()
            self._refs[p] = self._refs.get(p, 0) + 1
            table.append(p)
        self._tables[seq_id] = table
        self._lens[seq_id] = n_tokens
        return table

    def extend(self, seq_id, n_new: int = 1) -> None:
        new_len = self._lens[seq_id] + n_new
        need = self.pages_for(new_len) - len(self._tables[seq_id])
        for _ in range(need):
            if not self._free:
                self._oom("extend", 1)
                raise MemoryError("KV pool exhausted on extend")
            p = self._free.pop()
            self._refs[p] = self._refs.get(p, 0) + 1
            self._tables[seq_id].append(p)
        self._lens[seq_id] = new_len

    def free(self, seq_id) -> None:
        """Release a sequence: decrement every page it holds; a page whose
        refcount reaches 0 returns to the free list UNLESS the radix tree
        caches it (then it stays resident, evictable)."""
        for p in self._tables.pop(seq_id):
            r = self._refs.get(p, 0) - 1
            if r < 0:
                raise RuntimeError(f"page {p} refcount went negative")
            if r == 0:
                self._refs.pop(p)
                if p not in self._cached:
                    self._free.append(p)
            else:
                self._refs[p] = r
        self._lens.pop(seq_id)

    def grow_to(self, seq_id, n_tokens: int) -> List[int]:
        """Speculative tail growth: appended pages come fresh from the
        free list at refcount 1 (a drafted span is written exclusively;
        sharing happens only at admission and through the radix tree).
        Committed length untouched; see the base class."""
        added = super().grow_to(seq_id, n_tokens)
        for p in added:
            self._refs[p] = self._refs.get(p, 0) + 1
        return added

    def truncate_pages(self, seq_id, keep_pages: int) -> List[int]:
        """Speculative rollback: each stranded page is dereferenced and
        returns to the free list only at refcount 0 and only if the radix
        tree does not cache it (the release rule of :meth:`free`).
        Returns the pages actually freed."""
        table = self._tables[seq_id]
        freed: List[int] = []
        while len(table) > keep_pages:
            p = table.pop()
            r = self._refs.get(p, 0) - 1
            if r < 0:
                raise RuntimeError(f"page {p} refcount went negative")
            if r == 0:
                self._refs.pop(p)
                if p not in self._cached:
                    self._free.append(p)
                    freed.append(p)
            else:
                self._refs[p] = r
        if self._lens.get(seq_id, 0) > keep_pages * self.page_size:
            self._lens[seq_id] = keep_pages * self.page_size
        return freed

    # -- cache-side hooks (PrefixCache / eviction policy only) ---------------

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def adopt_cached(self, page: int) -> None:
        """The radix tree now indexes ``page``: it survives refcount 0."""
        self._cached.add(page)

    def evict_cached(self, page: int) -> None:
        """The radix tree dropped ``page``: back to the free list if no
        live sequence still shares it (else it frees on last release)."""
        self._cached.discard(page)
        if self._refs.get(page, 0) == 0:
            self._free.append(page)

    def copy_page(self, src: int, dst: int) -> None:
        """Device-side COW: copy ``src``'s slab (every layer) into
        ``dst``, in place: one page slab moves, never the whole pool. A
        head-sharded pool copies on every chip."""
        for pool in (self.k_pages, self.v_pages):
            if isinstance(pool, HeadShards):
                pool.copy_within((slice(None), dst), (slice(None), src))
            else:
                pool[:, dst].copy_(pool[:, src])

    # -- page-granular export/import (migration) -----------------------------

    def take_free_pages(self, n: int) -> List[int]:
        """Reserve ``n`` pages off the free list WITHOUT binding them to a
        sequence or bumping refcounts — the migration import's staging
        step. The caller owns them transiently and must hand every one
        back (``give_back_pages``) or into the radix tree
        (``adopt_cached``); anything else breaks conservation, which is
        exactly what makes partial-transfer rollback auditable."""
        if n < 0:
            raise ValueError(f"cannot take {n} pages")
        if len(self._free) < n:
            self._oom("import", n)
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, "
                f"{len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def give_back_pages(self, pages: Sequence[int]) -> None:
        """Return staged pages (from ``take_free_pages``) to the free
        list — the rollback half of an aborted import."""
        for p in pages:
            if p == 0 or p in self._refs or p in self._cached:
                raise RuntimeError(
                    f"page {p} is not a staged page (reserved/live/cached)")
        self._free.extend(pages)

    def export_page(self, page: int):
        """Read one page's K and V slabs (every layer) off the device as
        a ``(k_slab, v_slab)`` pair of host arrays — the wire format's
        payload unit (bf16 as ``core.host_arrays.BFLOAT16``). Waits for
        the work queued on the current stream."""
        return to_host(self.k_pages[:, page]), to_host(self.v_pages[:, page])

    def write_page(self, page: int, k_slab, v_slab) -> None:
        """Write a host-provided slab pair into ``page``, in place on the
        current stream (bf16 bit patterns move unchanged); a head-sharded
        pool takes each chip's heads into its slab."""
        for pool, slab in ((self.k_pages, k_slab), (self.v_pages, v_slab)):
            src = from_host(slab, pool.dtype, pool.device)
            want = (pool.shape[0],) + tuple(pool.shape[2:])
            if tuple(src.shape) != want:
                raise ValueError(
                    f"slab shape {tuple(src.shape)} != page geometry "
                    f"{want}")
            if isinstance(pool, HeadShards):
                pool.write((slice(None), page), src)
            else:
                pool[:, page].copy_(src)

    # -- accounting ----------------------------------------------------------

    @property
    def num_live_pages(self) -> int:
        return len(self._refs)

    @property
    def num_cached_pages(self) -> int:
        """Resident-but-unreferenced (evictable) cached pages."""
        return sum(1 for p in self._cached if p not in self._refs)

    def check_conservation(self) -> None:
        """Assert the pool's books balance (module docstring). Raises
        ``RuntimeError`` with a full breakdown on any violation."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("duplicate pages on the free list")
        if any(r <= 0 for r in self._refs.values()):
            raise RuntimeError("non-positive refcount retained")
        live = set(self._refs)
        cached0 = {p for p in self._cached if p not in live}
        if free & live or free & cached0:
            raise RuntimeError(
                f"page state overlap: free∩live={free & live}, "
                f"free∩cached={free & cached0}")
        if 0 in free | live | self._cached:
            raise RuntimeError("reserved page 0 entered circulation")
        counts: Dict[int, int] = {}
        for table in self._tables.values():
            for p in table:
                counts[p] = counts.get(p, 0) + 1
        if counts != self._refs:
            raise RuntimeError(
                f"refcounts diverge from block-table occupancy: "
                f"refs={self._refs} tables={counts}")
        total = len(free) + len(live) + len(cached0)
        if total != self.usable_pages:
            raise RuntimeError(
                f"page conservation violated: {len(free)} free + "
                f"{len(live)} live + {len(cached0)} cached = {total} "
                f"!= {self.usable_pages} usable")
