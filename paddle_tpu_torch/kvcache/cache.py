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
split in :attr:`gauges`. The JAX package also feeds these into its
process-global metrics registry (``paddle_kvcache_*``) and emits
``cache_hit``/``cache_evict`` events; both come with the observability
slice. ``import_prefix`` (migrating a prefix from another host) comes
with multi-host serving.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..ops._common import not_ported as _later
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

    def record(self, cached_tokens: int, cow: bool) -> None:
        """Account one ADMITTED request's lookup outcome."""
        if cow:
            self.stats["cow_copies"] += 1
        if cached_tokens > 0:
            self.stats["hits"] += 1
            self.stats["cached_tokens"] += cached_tokens
        else:
            self.stats["misses"] += 1

    # -- retire ---------------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index a finished sequence's prefix (full blocks only; the
        ragged tail page frees with the sequence). Returns the number of
        pages the tree adopted."""
        adopted, _dup = self.tree.insert(tokens, pages)
        for p in adopted:
            self.mgr.adopt_cached(p)
        return len(adopted)

    def import_prefix(self, tokens, k_slabs, v_slabs):
        raise _later("PrefixCache.import_prefix (page migration)",
                     "multi-host serving")

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
        self.stats["evictions"] += len(victims)
        return len(victims)

    @property
    def evictable_pages(self) -> int:
        return self.mgr.num_cached_pages

    # -- telemetry ------------------------------------------------------------

    def update_gauges(self) -> None:
        """Refresh the free/live/cached page split in :attr:`gauges`."""
        self.gauges = {"free": self.mgr.num_free_pages,
                       "live": self.mgr.num_live_pages,
                       "cached": self.mgr.num_cached_pages}

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
