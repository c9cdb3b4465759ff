"""Token-block radix tree: prompt prefixes -> resident KV page lists —
counterpart of ``paddle_tpu/kvcache/radix.py``, pure host code carried
over as it is.

The prefix cache's index (the tree SGLang's RadixAttention and the TPU
ragged-paged-attention layout in PAPERS.md make cheap to exploit): one
node per ``page_size``-token block, child edges keyed by the block's token
tuple, each node holding the physical page id whose KV encodes exactly
those tokens at their absolute positions. A prefix lookup walks full
blocks from the root; the matched node path IS the list of reusable
pages. Page ownership/refcounts live in :mod:`.pool`; this module is pure
host-side index structure (no device arrays, no refcounts).

Blocks are only ever cached WHOLE — a page whose tokens are partially
garbage can never be indexed, so a match is always byte-trustworthy.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class RadixNode:
    """One cached token block: ``key`` (the block's token tuple) edges
    from ``parent``; ``page`` is the physical page holding its KV."""

    __slots__ = ("children", "parent", "key", "page", "last_access")

    def __init__(self, parent: Optional["RadixNode"] = None,
                 key: Optional[Tuple[int, ...]] = None,
                 page: Optional[int] = None, last_access: int = 0):
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.key = key
        self.page = page
        self.last_access = last_access

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def depth_tokens(self, page_size: int) -> int:
        """Prefix length (tokens) this node's block completes."""
        n, node = 0, self
        while node.parent is not None:
            n += page_size
            node = node.parent
        return n


class RadixTree:
    """See module docstring. ``last_access`` stamps come from a logical
    clock (monotone int) so LRU ordering is deterministic under tests."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = RadixNode()
        self._clock = 0
        self._by_page: Dict[int, RadixNode] = {}

    def __len__(self) -> int:
        return len(self._by_page)

    @property
    def pages(self) -> List[int]:
        return list(self._by_page)

    def tick(self) -> int:
        self._clock += 1
        return self._clock

    def _block(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens: Sequence[int], touch: bool = True
              ) -> List[RadixNode]:
        """Longest cached full-block prefix of ``tokens``: the node path
        root-outward. ``touch`` refreshes LRU stamps (peek-style callers —
        admission sizing — pass False so sizing never distorts LRU)."""
        node, out = self.root, []
        stamp = self.tick() if touch else None
        for i in range(len(tokens) // self.page_size):
            child = node.children.get(self._block(tokens, i))
            if child is None:
                break
            if stamp is not None:
                child.last_access = stamp
            out.append(child)
            node = child
        return out

    def insert(self, tokens: Sequence[int], pages: Sequence[int]
               ) -> Tuple[List[int], List[int]]:
        """Index ``tokens``'s full blocks, adopting ``pages[i]`` for each
        block not yet cached. Returns ``(adopted, duplicates)`` page-id
        lists: *adopted* pages are now owned by the tree (the caller must
        mark them cached in the pool); *duplicates* back blocks already
        cached under a DIFFERENT page — redundant KV the caller lets the
        pool free when the sequence releases."""
        node = self.root
        stamp = self.tick()
        adopted: List[int] = []
        dup: List[int] = []
        for i in range(min(len(tokens) // self.page_size, len(pages))):
            blk = self._block(tokens, i)
            child = node.children.get(blk)
            if child is None:
                child = RadixNode(parent=node, key=blk, page=int(pages[i]),
                                  last_access=stamp)
                node.children[blk] = child
                self._by_page[child.page] = child
                adopted.append(child.page)
            else:
                child.last_access = stamp
                if int(pages[i]) != child.page:
                    dup.append(int(pages[i]))
            node = child
        return adopted, dup

    def remove(self, node: RadixNode) -> None:
        """Detach a LEAF node (eviction). Interior nodes must keep their
        place or descendants' prefixes would dangle."""
        if node.children:
            raise ValueError("cannot remove an interior radix node")
        if node.parent is None:
            raise ValueError("cannot remove the radix root")
        del node.parent.children[node.key]
        self._by_page.pop(node.page, None)
        node.parent = None

    def leaves(self) -> Iterator[RadixNode]:
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node
