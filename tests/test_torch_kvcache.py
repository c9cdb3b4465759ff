"""The prefix cache (``paddle_tpu_torch.kvcache``): the radix index,
refcounted shared ownership, copy-on-write and LRU eviction, mirrored
from the JAX package's own tests (tests/test_kvcache.py), and a property
test that drives the JAX ``RefcountedKVCacheManager`` + ``PrefixCache``
and the port's with the same random sequence of operations and compares
lookups, block tables, refcounts and free counts after every one."""

import numpy as np
import pytest
import torch

from paddle_tpu import kvcache as jkv
from paddle_tpu_torch.kvcache import (LRUEvictionPolicy, PrefixCache,
                                      RefcountedKVCacheManager, RadixTree)
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


def _mgr(num_pages=12, page_size=4):
    # tiny tensors: 1 layer, 1 kv head, dim 2 — metadata is the test
    return RefcountedKVCacheManager(1, num_pages, page_size, 1, 2,
                                    dtype=torch.float32, device="cpu")


def _toks(*blocks):
    out = []
    for b in blocks:
        out.extend(b)
    return out


# ---------------------------------------------------------------------------
# radix tree
# ---------------------------------------------------------------------------

def test_radix_match_full_blocks_only():
    t = RadixTree(page_size=4)
    t.insert([1, 2, 3, 4, 5, 6, 7, 8], [10, 11])
    assert [n.page for n in t.match([1, 2, 3, 4, 5, 6, 7, 8, 9])] == [10, 11]
    assert [n.page for n in t.match([1, 2, 3, 4, 9, 9, 9, 9])] == [10]
    assert t.match([1, 2, 3]) == []
    assert t.match([2, 2, 3, 4]) == []


def test_radix_insert_reports_duplicates_not_adoption():
    t = RadixTree(page_size=2)
    assert t.insert([1, 2, 3, 4], [5, 6]) == ([5, 6], [])
    adopted, dup = t.insert([1, 2, 3, 4, 9, 9], [7, 8, 9])
    assert adopted == [9] and dup == [7, 8]
    assert len(t) == 3


def test_radix_remove_leaf_only():
    t = RadixTree(page_size=2)
    t.insert([1, 2, 3, 4], [5, 6])
    inner = t.match([1, 2])[0]
    with pytest.raises(ValueError):
        t.remove(inner)
    leaf = t.match([1, 2, 3, 4])[-1]
    t.remove(leaf)
    assert t.match([1, 2, 3, 4]) == [inner]
    t.remove(inner)
    assert len(t) == 0


# ---------------------------------------------------------------------------
# refcounted pool
# ---------------------------------------------------------------------------

def test_shared_allocation_refcounts_and_release():
    mgr = _mgr(num_pages=8, page_size=4)
    a = mgr.allocate("a", 8)
    b = mgr.allocate("b", 12, shared=a)
    assert b[:2] == a and len(b) == 3
    assert mgr.refcount(a[0]) == 2 and mgr.refcount(b[2]) == 1
    mgr.free("a")
    assert mgr.refcount(a[0]) == 1
    mgr.check_conservation()
    mgr.free("b")
    assert mgr.num_free_pages == mgr.usable_pages
    mgr.check_conservation()


def test_cached_pages_survive_release_and_evict_to_free():
    mgr = _mgr(num_pages=6, page_size=4)
    pages = mgr.allocate("a", 8)
    for p in pages:
        mgr.adopt_cached(p)
    mgr.free("a")
    assert mgr.num_free_pages == mgr.usable_pages - 2
    assert mgr.num_cached_pages == 2 and mgr.num_live_pages == 0
    mgr.check_conservation()
    mgr.evict_cached(pages[0])
    assert mgr.num_free_pages == mgr.usable_pages - 1
    mgr.check_conservation()


def test_conservation_detects_a_leaked_table():
    mgr = _mgr()
    mgr.allocate("a", 4)
    mgr._tables.pop("a")                           # leak: refs != tables
    with pytest.raises(RuntimeError, match="diverge"):
        mgr.check_conservation()


def test_shared_allocation_larger_than_the_span_raises():
    mgr = _mgr()
    a = mgr.allocate("a", 8)
    with pytest.raises(ValueError, match="exceed"):
        mgr.allocate("b", 4, shared=a)
    with pytest.raises(MemoryError):
        mgr.allocate("c", 100)
    mgr.check_conservation()


def test_copy_page_copies_one_slab_in_place():
    mgr = RefcountedKVCacheManager(2, 6, 4, 1, 2, dtype=torch.float32,
                                   device="cpu")
    k_before, v_before = mgr.k_pages, mgr.v_pages
    mgr.k_pages[:, 1] = 7.0
    mgr.v_pages[:, 1] = 3.0
    mgr.k_pages[:, 3] = 5.0
    mgr.copy_page(1, 2)
    assert mgr.k_pages is k_before and mgr.v_pages is v_before
    assert bool((mgr.k_pages[:, 2] == 7.0).all())
    assert bool((mgr.v_pages[:, 2] == 3.0).all())
    assert bool((mgr.k_pages[:, 3] == 5.0).all())   # other pages untouched


# ---------------------------------------------------------------------------
# prefix cache orchestration
# ---------------------------------------------------------------------------

def test_lookup_caps_full_prompt_match_with_cow():
    mgr = _mgr(num_pages=12, page_size=4)
    cache = PrefixCache(mgr)
    prompt = list(range(1, 9))                     # exactly 2 blocks
    table = mgr.allocate(0, 8)
    cache.insert(prompt, table)
    mgr.free(0)
    shared, n_cached, cow = cache.lookup(prompt)
    assert shared == table[:1] and n_cached == 7 and cow == table[1]
    shared, n_cached, cow = cache.lookup(prompt + [77])
    assert shared == table and n_cached == 8 and cow is None
    assert cache.peek(prompt + [77]) == (table, 8, None)


def test_lru_eviction_prefers_coldest_leaf():
    mgr = _mgr(num_pages=12, page_size=4)
    cache = PrefixCache(mgr)
    pa = _toks(range(4), range(4))
    pb = _toks(range(10, 14), range(20, 24))
    cache.insert(pa, mgr.allocate("a", 8))
    mgr.free("a")
    cache.insert(pb, mgr.allocate("b", 8))
    mgr.free("b")
    cache.lookup(pa + [9])                         # touch A: B is now LRU
    assert cache.evict(1) == 1
    assert len(cache.tree.match(pb, touch=False)) == 1
    assert len(cache.tree.match(pa, touch=False)) == 2
    mgr.check_conservation()


def test_evict_respects_protect_and_pinned_pages():
    mgr = _mgr(num_pages=12, page_size=4)
    cache = PrefixCache(mgr)
    prompt = _toks(range(4), range(4))
    table = mgr.allocate("a", 8)
    cache.insert(prompt, table)
    mgr.free("a")
    assert cache.evict(5, protect=table) == 0
    mgr.allocate("b", 8, shared=table)
    assert cache.evict(5) == 0
    mgr.free("b")
    assert cache.evict(5) == 2
    assert mgr.num_free_pages == mgr.usable_pages
    assert cache.snapshot()["evictions"] == 2
    mgr.check_conservation()


def test_stats_gauges_and_statusz():
    mgr = _mgr(num_pages=12, page_size=4)
    cache = PrefixCache(mgr)
    cache.insert(list(range(8)), mgr.allocate("a", 8))
    cache.record(0, 8, 8, 2, False)
    cache.record(1, 8, 0, 0, False)
    cache.record(2, 8, 7, 1, True)
    cache.update_gauges()
    assert cache.gauges == {"free": 9, "live": 2, "cached": 0}
    snap = cache.snapshot()
    assert (snap["hits"], snap["misses"], snap["cow_copies"],
            snap["cached_tokens"], snap["tree_nodes"]) == (2, 1, 1, 15, 2)
    assert cache.statusz()["pages"] == {"usable": 11, "free": 9, "live": 2,
                                        "cached": 0}
    # no slab to adopt: nothing moves and the books still balance
    assert cache.import_prefix([1, 2, 3, 4], [], []) == {
        "imported_pages": 0, "skipped_pages": 0, "imported_bytes": 0,
        "evicted_pages": 0}
    mgr.check_conservation()


# ---------------------------------------------------------------------------
# the same random operations through the JAX cache and the port's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_match_jax_cache(seed):
    """admit (lookup -> evict under pressure -> shared allocate -> COW
    bookkeeping), retire (insert then free), cancel (free only) and
    explicit evictions, as the engines drive them, in a seed-made order
    over prompts that share prefixes. Every step: identical lookups,
    tables, refcounts, free/cached counts, and both books balance."""
    rng = np.random.RandomState(seed)
    P, PS = 20, 4
    jm = jkv.RefcountedKVCacheManager(1, P, PS, 1, 2)
    jc = jkv.PrefixCache(jm)
    tm = RefcountedKVCacheManager(1, P, PS, 1, 2, dtype=torch.float32,
                                  device="cpu")
    tc = PrefixCache(tm, LRUEvictionPolicy())
    stems = [list(rng.randint(1, 50, size=n)) for n in (8, 12, 5)]
    live = []
    hits = 0
    for i in range(60):
        op = rng.choice(["admit", "admit", "retire", "cancel", "evict"])
        if op == "admit":
            stem = stems[rng.randint(len(stems))]
            prompt = stem[:rng.randint(1, len(stem) + 1)] + list(
                rng.randint(1, 50, size=rng.randint(0, 6)))
            if not prompt:
                continue
            total = len(prompt) + int(rng.randint(1, 6))
            got = tc.lookup(prompt)
            assert got == jc.lookup(prompt)
            shared, _, cow = got
            hits += bool(shared) or cow is not None
            need = tm.pages_for(total) - len(shared)
            if tm.num_free_pages < need:
                n = need - tm.num_free_pages
                assert tc.evict(n, protect=shared + [cow]) == jc.evict(
                    n, protect=shared + [cow])
            if tm.num_free_pages < need:
                continue
            assert (tm.allocate(i, total, shared=shared)
                    == jm.allocate(i, total, shared=shared))
            live.append((i, prompt))
        elif op in ("retire", "cancel") and live:
            sid, prompt = live.pop(rng.randint(len(live)))
            if op == "retire":
                toks = prompt + [7] * (len(tm.sequence_pages(sid)) * PS
                                       - len(prompt))
                assert (tc.insert(toks, tm.sequence_pages(sid))
                        == jc.insert(toks, jm.sequence_pages(sid)))
            tm.free(sid)
            jm.free(sid)
        elif op == "evict":
            n = int(rng.randint(1, 4))
            assert tc.evict(n) == jc.evict(n)
        assert tm.num_free_pages == jm.num_free_pages
        assert tm.num_cached_pages == jm.num_cached_pages
        assert tm.num_live_pages == jm.num_live_pages
        for sid, _ in live:
            assert tm.sequence_pages(sid) == jm.sequence_pages(sid)
            for p in tm.sequence_pages(sid):
                assert tm.refcount(p) == jm.refcount(p)
        tm.check_conservation()
        jm.check_conservation()
    assert tc.snapshot()["evictions"] == jc.snapshot()["evictions"] > 0
    assert len(tc.tree) == len(jc.tree)
    assert hits > 0
