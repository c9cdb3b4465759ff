"""``paddle_tpu_torch.kvcache`` — refcounted prefix cache for the paged KV
pool, counterpart of ``paddle_tpu.kvcache``.

Shared system prompts and multi-turn prefixes are prefilled once; every
later request with the same leading tokens borrows the resident pages
and computes only its suffix.

* :mod:`.radix` — token-block radix tree mapping prompt prefixes to page
  lists at ``page_size`` granularity;
* :mod:`.pool` — :class:`RefcountedKVCacheManager`, the page pool with
  shared ownership (refcounts, cached-at-refcount-0 residency,
  device-side copy-on-write) and the conservation invariant
  ``free + live + cached == num_pages - 1``;
* :mod:`.policy` — :class:`LRUEvictionPolicy` over evictable radix
  leaves;
* :mod:`.cache` — :class:`PrefixCache`, the lookup/insert/evict surface
  the engine drives.

Enable it per engine::

    eng = ContinuousBatchingEngine(cfg, gen_cfg, num_slots=8,
                                   prefix_cache=True)
    eng.cache.snapshot()   # {'hits': ..., 'cached_tokens': ..., ...}
"""

from .cache import PrefixCache  # noqa: F401
from .policy import LRUEvictionPolicy  # noqa: F401
from .pool import RefcountedKVCacheManager  # noqa: F401
from .radix import RadixNode, RadixTree  # noqa: F401

__all__ = [
    "PrefixCache", "LRUEvictionPolicy", "RefcountedKVCacheManager",
    "RadixNode", "RadixTree",
]
