"""PrefixCache: the radix index, refcounted pool and eviction policy
wired together behind the three calls the serving engine makes —
counterpart of ``paddle_tpu/kvcache/cache.py``.

* :meth:`lookup` (admission) — longest reusable cached prefix for a
  prompt, capped at ``len(prompt) - 1`` tokens so at least one suffix
  token runs through the model (logits for sampling must come from
  somewhere). When the cap lands MID-page — a full-prompt match with the
  prompt a whole number of pages — the last matched page cannot be shared
  read-write, so lookup hands back a ``cow_src``: the engine copies that
  page on the device (:meth:`RefcountedKVCacheManager.copy_page`) and the
  sequence appends into its private copy.
* :meth:`insert` (retire) — index a finished sequence's full token blocks;
  newly adopted pages survive release as cached, blocks already indexed
  under another page are left alone (the duplicate frees with the
  sequence).
* :meth:`evict` (pressure) — LRU leaves back to the free list until the
  deficit is covered or nothing evictable remains.

Telemetry: :attr:`stats` counts hits, misses, evictions, COW copies and
cached tokens, and :meth:`update_gauges` keeps the free/live/cached page
split in :attr:`gauges`; both feed the process registry's
``paddle_kvcache_*`` families too, and an admitted hit and an eviction
emit ``cache_hit`` / ``cache_evict`` events. :meth:`PrefixCache.import_prefix`
adopts a prefix whose pages another engine exported (the prefill ->
decode KV handoff), all-or-nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..observability.events import emit_event
from ..observability.registry import get_registry
from .policy import LRUEvictionPolicy
from .pool import RefcountedKVCacheManager
from .radix import RadixTree


class PrefixCache:
    """See module docstring."""

    def __init__(self, mgr: RefcountedKVCacheManager,
                 policy: Optional[LRUEvictionPolicy] = None):
        self.mgr = mgr
        self.page_size = mgr.page_size
        self.tree = RadixTree(mgr.page_size)
        self.policy = policy or LRUEvictionPolicy()
        #: counters (the JAX package's registry counters' local mirrors)
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "evictions": 0, "cow_copies": 0,
            "cached_tokens": 0,
        }
        #: the page pool split as of the last :meth:`update_gauges`
        self.gauges: Dict[str, int] = {}
        reg = get_registry()
        self._c_hits = reg.counter(
            "paddle_kvcache_hits_total",
            "admissions that reused >=1 cached prefix page")
        self._c_misses = reg.counter(
            "paddle_kvcache_misses_total",
            "admissions with no reusable cached prefix")
        self._c_evict = reg.counter(
            "paddle_kvcache_evictions_total",
            "cached pages LRU-evicted back to the free list")
        self._c_cow = reg.counter(
            "paddle_kvcache_cow_copies_total",
            "copy-on-write page copies (suffix append into a shared page)")
        self._c_cached_tokens = reg.counter(
            "paddle_kvcache_cached_tokens_total",
            "prompt tokens served from cache instead of prefill")
        self._g_pages = reg.gauge(
            "paddle_kvcache_pages",
            "page pool split: free / live (refcounted) / cached (evictable)",
            labels=("state",))

    # -- admission ------------------------------------------------------------

    def _capped_match(self, prompt: Sequence[int], touch: bool
                      ) -> Tuple[List[int], int, Optional[int]]:
        lp = len(prompt)
        nodes = self.tree.match(prompt, touch=touch)
        pages = [nd.page for nd in nodes]
        if pages and len(pages) * self.page_size >= lp:
            # full-prompt match: the last prompt token must be recomputed
            # for logits and its slot sits inside the final matched page —
            # share all but that page and copy-on-write its content
            return pages[:-1], lp - 1, pages[-1]
        return pages, len(pages) * self.page_size, None

    def lookup(self, prompt: Sequence[int]
               ) -> Tuple[List[int], int, Optional[int]]:
        """Reusable prefix for ``prompt``: ``(shared_pages, cached_tokens,
        cow_src)``. Refreshes LRU stamps; counters are bumped by
        :meth:`record` only when the request actually admits (a blocked
        head-of-queue request is looked up every step — counting those
        would fabricate hits)."""
        return self._capped_match(prompt, touch=True)

    def peek(self, prompt: Sequence[int]
             ) -> Tuple[List[int], int, Optional[int]]:
        """Sizing-only view for admission control: same ``(shared_pages,
        cached_tokens, cow_src)`` shape as :meth:`lookup` but without
        touching LRU or stats."""
        return self._capped_match(prompt, touch=False)

    def record(self, request_id, prompt_len: int, cached_tokens: int,
               shared_pages: int, cow: bool, trace_id: str = "") -> None:
        """Account one ADMITTED request's lookup outcome (counters, and a
        ``cache_hit`` event for a hit)."""
        if cow:
            self.stats["cow_copies"] += 1
            self._c_cow.inc()
        if cached_tokens > 0:
            self.stats["hits"] += 1
            self.stats["cached_tokens"] += cached_tokens
            self._c_hits.inc()
            self._c_cached_tokens.inc(cached_tokens)
            emit_event("cache_hit", request_id=request_id,
                       trace_id=trace_id, prompt_len=prompt_len,
                       cached_tokens=cached_tokens, pages=shared_pages,
                       cow=cow)
        else:
            self.stats["misses"] += 1
            self._c_misses.inc()

    # -- retire ---------------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index a finished sequence's prefix (full blocks only; the
        ragged tail page frees with the sequence). Returns the number of
        pages the tree adopted."""
        adopted, _dup = self.tree.insert(tokens, pages)
        for p in adopted:
            self.mgr.adopt_cached(p)
        return len(adopted)

    # -- migration import -----------------------------------------------------

    def _slab_shape(self) -> Tuple[int, ...]:
        """Expected shape of ONE page's K (or V) slab: the pool array
        minus its page axis — ``(layers, page_size, kv_heads, head_dim)``."""
        s = tuple(self.mgr.k_pages.shape)
        return (s[0],) + s[2:]

    def import_prefix(self, tokens: Sequence[int], k_slabs: Sequence,
                      v_slabs: Sequence) -> Dict[str, int]:
        """Adopt a migrated prefix into THIS host's cache: ``k_slabs[i]``/
        ``v_slabs[i]`` hold the KV for ``tokens``' i-th full block.
        Blocks the radix tree already caches are skipped (their payload
        is dropped, not written — the destination replays only pages it
        lacks); the remainder is staged off the free list, written
        device-side, and indexed.

        All-or-nothing: geometry is validated before the pool is
        touched, and any failure mid-import hands every staged page back
        (``give_back_pages``) so a half-transferred payload can never
        leak — ``check_conservation`` runs on every exit path that
        mutated the pool. Returns ``{imported_pages, skipped_pages,
        imported_bytes, evicted_pages}``."""
        ps = self.page_size
        n_blocks = len(k_slabs)
        if len(v_slabs) != n_blocks:
            raise ValueError(
                f"K/V slab count mismatch: {n_blocks} != {len(v_slabs)}")
        if len(tokens) < n_blocks * ps:
            raise ValueError(
                f"{len(tokens)} tokens cannot cover {n_blocks} "
                f"full blocks of {ps}")
        want = self._slab_shape()
        for i in range(n_blocks):
            for name, slab in (("k", k_slabs[i]), ("v", v_slabs[i])):
                got = tuple(getattr(slab, "shape", ()))
                if got != want:
                    raise ValueError(
                        f"{name}_slab[{i}] shape {got} != pool page "
                        f"geometry {want}")
        blocks = list(tokens[:n_blocks * ps])
        matched = self.tree.match(blocks, touch=False)
        n_have = len(matched)
        n_new = n_blocks - n_have
        out = {"imported_pages": 0, "skipped_pages": n_have,
               "imported_bytes": 0, "evicted_pages": 0}
        if n_new <= 0:
            return out
        protect = [nd.page for nd in matched]
        deficit = n_new - self.mgr.num_free_pages
        if deficit > 0:
            out["evicted_pages"] = self.evict(deficit, protect=protect)
        staged = self.mgr.take_free_pages(n_new)
        try:
            for j, p in enumerate(staged):
                i = n_have + j
                self.mgr.write_page(p, k_slabs[i], v_slabs[i])
            adopted, dup = self.tree.insert(blocks, protect + staged)
        except Exception:
            self.mgr.give_back_pages(staged)
            self.mgr.check_conservation()
            raise
        for p in adopted:
            self.mgr.adopt_cached(p)
        if dup:
            # a block raced into the tree under another page between
            # match and insert — the staged copy is redundant
            self.mgr.give_back_pages(dup)
        out["imported_pages"] = len(adopted)
        out["imported_bytes"] = len(adopted) * self.mgr.page_nbytes
        self.mgr.check_conservation()
        return out

    # -- pressure -------------------------------------------------------------

    def evict(self, n_pages: int, protect: Sequence[int] = ()) -> int:
        """Return up to ``n_pages`` cached pages to the free list, LRU
        leaves first; ``protect`` shields pages an in-flight admission is
        about to share. Returns the number actually freed."""
        victims = self.policy.select(self.tree, self.mgr.refcount,
                                     n_pages, protect)
        for victim in victims:        # children precede parents
            self.tree.remove(victim)
            self.mgr.evict_cached(victim.page)
        freed = len(victims)
        if freed:
            self.stats["evictions"] += freed
            self._c_evict.inc(freed)
            emit_event("cache_evict", pages=freed,
                       cached_left=self.mgr.num_cached_pages)
        return freed

    @property
    def evictable_pages(self) -> int:
        return self.mgr.num_cached_pages

    # -- telemetry ------------------------------------------------------------

    def update_gauges(self) -> None:
        """Refresh the free/live/cached page split in :attr:`gauges` and
        the registry."""
        self.gauges = {"free": self.mgr.num_free_pages,
                       "live": self.mgr.num_live_pages,
                       "cached": self.mgr.num_cached_pages}
        for state, n in self.gauges.items():
            self._g_pages.set(n, state=state)

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.stats)
        out["cached_pages"] = self.mgr.num_cached_pages
        out["tree_nodes"] = len(self.tree)
        return out

    def statusz(self) -> Dict[str, object]:
        """The hit/evict stats plus the live page-pool ownership split."""
        out: Dict[str, object] = dict(self.snapshot())
        out["pages"] = {"usable": self.mgr.usable_pages,
                        "free": self.mgr.num_free_pages,
                        "live": self.mgr.num_live_pages,
                        "cached": self.mgr.num_cached_pages}
        return out
