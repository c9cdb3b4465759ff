"""Eviction policy: which cached pages die when the pool runs dry —
counterpart of ``paddle_tpu/kvcache/policy.py``, pure host code carried
over as it is.

The cache keeps finished prefixes resident as long as pages are plentiful
— caching is free until allocation pressure appears, so the policy is
invoked only from the admission paths (engine/scheduler) when fresh pages
run short. Strategy here: **LRU over evictable leaves**. Only radix
leaves are candidates (dropping an interior node would orphan the cached
blocks beneath it), and only pages no live sequence references (a pinned
page frees no memory and its node would lose a still-hot prefix).
Removing a leaf can expose its parent as the next candidate, so deep cold
chains unwind oldest-first.
"""

from __future__ import annotations

import heapq
from typing import Iterable, List, Set

from .radix import RadixNode, RadixTree


class LRUEvictionPolicy:
    """Pick the least-recently-used evictable leaves (module docstring).

    Stateless: LRU stamps live on the radix nodes; ``protect`` lets an
    admission in flight shield the pages it is about to share (their
    refcounts rise only once the sequence's table is built)."""

    def select(self, tree: RadixTree, refcount, n: int,
               protect: Iterable[int] = ()) -> List[RadixNode]:
        """Up to ``n`` victims, coldest-first, children before parents —
        ONE leaf scan plus a heap, not a rescan per victim (eviction runs
        on the admission hot path exactly when the system is loaded).
        Parents whose children are all selected join the candidate heap
        (simulated removal; the caller performs the real detach in the
        returned order)."""
        protected: Set[int] = {p for p in protect if p is not None}

        def evictable(node: RadixNode) -> bool:
            return node.page not in protected and refcount(node.page) == 0

        heap = [(leaf.last_access, id(leaf), leaf)
                for leaf in tree.leaves() if evictable(leaf)]
        heapq.heapify(heap)
        victims: List[RadixNode] = []
        live_children: dict = {}      # id(parent) -> not-yet-selected count
        while heap and len(victims) < n:
            _, _, node = heapq.heappop(heap)
            victims.append(node)
            parent = node.parent
            if parent is None or parent is tree.root:
                continue
            left = live_children.get(id(parent), len(parent.children)) - 1
            live_children[id(parent)] = left
            if left == 0 and evictable(parent):
                heapq.heappush(heap,
                               (parent.last_access, id(parent), parent))
        return victims
