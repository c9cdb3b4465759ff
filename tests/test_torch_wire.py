"""The wire format and page migration: ``paddle_tpu_torch.serving.wire``
and the port's refcounted pool (``export_page``/``write_page``/
``take_free_pages``/``give_back_pages``, ``PrefixCache.import_prefix``)
against the JAX package's, on the CPU.

Every case of the JAX package's ``tests/test_wire.py`` runs through both
stacks and must give the same frames byte for byte, the same structured
error codes in the same order, and the same page bytes after export and
import. Then each package decodes the other's page, grammar and
telemetry frames (bf16 pools included) and re-encodes them to the same
bytes. The port carries bf16 as ``core.host_arrays.BFLOAT16`` bit
patterns; the JAX package as ``ml_dtypes.bfloat16``: the test builds
both from the same bits."""

import ast
import struct
from pathlib import Path
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.serving.wire as JW
import paddle_tpu_torch.serving.wire as TW
from paddle_tpu.inference import constrain as JC
from paddle_tpu.kvcache.cache import PrefixCache as JCache
from paddle_tpu.kvcache.pool import RefcountedKVCacheManager as JMgr
from paddle_tpu_torch.core.host_arrays import BFLOAT16, from_host, to_host
from paddle_tpu_torch.inference import constrain as TC
from paddle_tpu_torch.kvcache.cache import PrefixCache as TCache
from paddle_tpu_torch.kvcache.pool import RefcountedKVCacheManager as TMgr
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

REPO = Path(__file__).resolve().parents[1]


def _jax_mgr(num_pages=12, page_size=4, dtype="bfloat16"):
    import jax.numpy as jnp
    return JMgr(1, num_pages, page_size, 1, 2, dtype=getattr(jnp, dtype))


def _torch_mgr(num_pages=12, page_size=4, dtype="bfloat16"):
    return TMgr(1, num_pages, page_size, 1, 2,
                dtype=getattr(torch, dtype), device="cpu")


def _jax_host(bits_or_f32, dtype):
    a = np.asarray(bits_or_f32)
    return a.view(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _torch_host(bits_or_f32, dtype):
    a = np.asarray(bits_or_f32)
    return a.view(BFLOAT16) if dtype == "bfloat16" else a


STACKS = {
    "jax": SimpleNamespace(name="jax", W=JW, mgr=_jax_mgr, Cache=JCache,
                           C=JC, host=_jax_host),
    "torch": SimpleNamespace(name="torch", W=TW, mgr=_torch_mgr,
                             Cache=TCache, C=TC, host=_torch_host),
}
DTYPES = ("bfloat16", "float32")


def _content(shape, seed, dtype):
    """Page content both stacks can hold exactly: bf16 as the uint16
    patterns of rounded normals, fp32 as normals."""
    x = np.random.RandomState(seed).standard_normal(shape)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16).view(np.uint16)
    return x.astype(np.float32)


def _slab_shape(mgr):
    s = tuple(mgr.k_pages.shape)
    return (s[0],) + s[2:]


def _fill_pages(st, mgr, pages, seed=0, dtype="bfloat16"):
    """The reference's ``_fill_pages``: recognisable per-page content."""
    rng = np.random.RandomState(seed)
    for p in pages:
        k = _content(_slab_shape(mgr), rng.randint(1 << 30), dtype)
        v = _content(_slab_shape(mgr), rng.randint(1 << 30), dtype)
        mgr.write_page(p, st.host(k, dtype), st.host(v, dtype))


def _b(a):
    return np.asarray(a).tobytes()


def _image(mgr):
    """Every page's bytes and the free list, for conservation checks."""
    # the free LIST (not just its count) is the conservation point
    # tpu-lint: disable=private-kvcache
    free = sorted(mgr._free)
    pages = [_b(mgr.export_page(p)[0]) + _b(mgr.export_page(p)[1])
             for p in range(1, mgr.num_pages)]
    return pages, free, mgr.num_free_pages


def _code(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the code is the result
        return type(e).__name__, getattr(e, "code", None)
    return None


# ---------------------------------------------------------------------------
# cases (the JAX package's tests/test_wire.py)
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def message_roundtrip_meta_and_arrays(st):
    arrays = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
              "b": np.random.RandomState(0).standard_normal(
                  (2, 5)).astype(np.float32),
              "flags": np.array([True, False, True])}
    meta = {"rid": 7, "nested": {"x": [1, 2, 3]}, "s": "héllo"}
    buf = st.W.encode_message("submit", meta, arrays)
    kind, m, arrs = st.W.decode_message(buf)
    assert kind == "submit" and m == meta and set(arrs) == set(arrays)
    for name in arrays:
        np.testing.assert_array_equal(arrs[name], arrays[name])
        assert arrs[name].dtype == arrays[name].dtype
    return dict(buf=buf)


@case
def bfloat16_travels_bit_faithfully(st):
    bits = np.arange(8, dtype=np.float32).astype(
        ml_dtypes.bfloat16).view(np.uint16)
    a = st.host(bits, "bfloat16")
    buf = st.W.encode_message("kv", {}, {"a": a})
    _, _, arrs = st.W.decode_message(buf)
    assert arrs["a"].dtype == a.dtype
    assert arrs["a"].tobytes() == a.tobytes()
    return dict(buf=buf)


@case
def empty_frame_roundtrip(st):
    buf = st.W.encode_message("heartbeat")
    assert st.W.decode_message(buf) == ("heartbeat", {}, {})
    return dict(buf=buf)


@case
def ordered_integrity_rejection(st):
    """truncated preamble / body, bad magic, version skew, payload and
    header corruption, and the magic-before-version-before-CRC order."""
    W = st.W
    out = {}
    buf = W.encode_message("x", {"a": 1})
    out["preamble"] = _code(lambda: W.decode_message(
        buf[:W.PREAMBLE_NBYTES - 1]))
    body = W.encode_message("x", {"a": 1}, {"p": np.zeros(64, np.float32)})
    out["body"] = _code(lambda: W.decode_message(body[:-10]))
    bad = bytearray(W.encode_message("x"))
    bad[:4] = b"EVIL"
    out["magic"] = _code(lambda: W.decode_message(bytes(bad)))
    skew = bytearray(W.encode_message("x", {"a": 1}))
    struct.pack_into("<H", skew, 4, W.WIRE_VERSION + 1)
    try:
        W.decode_message(bytes(skew))
    except W.WireError as err:
        assert str(W.WIRE_VERSION + 1) in err.detail
        out["skew"] = err.as_dict()
    pay = bytearray(W.encode_message("kv", {},
                                     {"p": np.ones(32, np.float32)}))
    pay[-3] ^= 0xFF
    out["payload"] = _code(lambda: W.decode_message(bytes(pay)))
    hdr = bytearray(W.encode_message("kv", {"deep": {"meta": [1, 2]}}))
    hdr[W.PREAMBLE_NBYTES + 2] ^= 0xFF
    out["header"] = _code(lambda: W.decode_message(bytes(hdr)))
    order = bytearray(W.encode_message("x"))
    order[:4] = b"EVIL"
    struct.pack_into("<H", order, 4, 99)
    order[-1] ^= 0xFF
    out["order"] = _code(lambda: W.decode_message(bytes(order)))
    out["unknown"] = _code(lambda: W.WireError("not_a_code", "x"))
    assert out["preamble"] == ("WireError", "truncated")
    assert out["body"][1] in ("truncated", "checksum_mismatch")
    assert out["magic"] == out["order"] == ("WireError", "bad_magic")
    assert out["skew"]["code"] == "version_skew"
    assert out["payload"] == out["header"] == ("WireError",
                                               "checksum_mismatch")
    assert out["unknown"] == ("ValueError", None)
    return out


def _pages_roundtrip(st, dtype):
    src = st.mgr(num_pages=16, page_size=4, dtype=dtype)
    base = src.allocate("a", 8)
    src.allocate("b", 8, shared=base)
    assert src.refcount(base[0]) == 2
    cow_dst = src.take_free_pages(1)[0]
    _fill_pages(st, src, base + [cow_dst], seed=1, dtype=dtype)
    src.copy_page(base[1], cow_dst)
    spec = src.grow_to("a", 12)
    _fill_pages(st, src, spec, seed=2, dtype=dtype)
    pages = base + [cow_dst] + spec
    want = {p: src.export_page(p) for p in pages}
    buf = st.W.encode_pages("migrate", {"rid": 1},
                            *zip(*(want[p] for p in pages)))
    kind, meta, arrays = st.W.decode_message(buf)
    assert kind == "migrate" and meta["n_pages"] == len(pages)
    ks, vs = st.W.decode_pages(meta, arrays)
    dst = st.mgr(num_pages=16, page_size=4, dtype=dtype)
    staged = dst.take_free_pages(len(pages))
    for p, k, v in zip(staged, ks, vs):
        dst.write_page(p, k, v)
    for p_src, p_dst in zip(pages, staged):
        wk, wv = want[p_src]
        gk, gv = dst.export_page(p_dst)
        assert _b(gk) == _b(wk) and _b(gv) == _b(wv)
    k_parent = dst.export_page(staged[1])[0]
    k_cow = dst.export_page(staged[2])[0]
    assert _b(k_parent) != _b(k_cow)
    dst.give_back_pages(staged)
    dst.check_conservation()
    src.free("b")
    src.free("a")
    src.give_back_pages([cow_dst])
    src.check_conservation()
    return dict(buf=buf, pages=pages, staged=staged,
                export=[_b(a) for p in pages for a in want[p]])


@case
def pages_roundtrip_cow_shared_and_spec_tail_bf16(st):
    return _pages_roundtrip(st, "bfloat16")


@case
def pages_roundtrip_cow_shared_and_spec_tail_fp32(st):
    return _pages_roundtrip(st, "float32")


@case
def import_prefix_lands_in_cache_and_dedups(st):
    src = st.mgr(num_pages=16, page_size=4)
    tokens = list(range(1, 13))
    table = src.allocate("a", 12)
    _fill_pages(st, src, table, seed=3)
    slabs = [src.export_page(p) for p in table]
    ks, vs = [k for k, _ in slabs], [v for _, v in slabs]
    dst = st.mgr(num_pages=16, page_size=4)
    cache = st.Cache(dst)
    free0 = dst.num_free_pages
    out = cache.import_prefix(tokens, ks, vs)
    assert out["imported_pages"] == 3 and out["skipped_pages"] == 0
    assert dst.num_free_pages == free0 - 3
    out2 = cache.import_prefix(tokens, ks, vs)
    assert out2["imported_pages"] == 0 and out2["skipped_pages"] == 3
    shared, n_cached, cow = cache.lookup(tokens + [99])
    assert n_cached == 12 and cow is None
    for got, p_src in zip(shared, table):
        assert _b(dst.export_page(got)[0]) == _b(src.export_page(p_src)[0])
    dst.check_conservation()
    return dict(out=out, out2=out2, shared=shared, image=_image(dst))


@case
def rejected_frame_leaves_destination_byte_conserved(st):
    src = st.mgr()
    table = src.allocate("a", 8)
    _fill_pages(st, src, table, seed=4)
    slabs = [src.export_page(p) for p in table]
    buf = st.W.encode_pages("migrate", {"tokens": list(range(8))},
                            [k for k, _ in slabs], [v for _, v in slabs])
    dst = st.mgr()
    cache = st.Cache(dst)
    before = _image(dst)
    codes = []
    for bad in (buf[:len(buf) // 2],
                bytes(bytearray(buf[:-1]) + bytearray([buf[-1] ^ 0xFF]))):
        with pytest.raises(st.W.WireError) as ei:
            kind, meta, arrays = st.W.decode_message(bad)
            cache.import_prefix(meta["tokens"],
                                *st.W.decode_pages(meta, arrays))
        codes.append(ei.value.code)
        assert _image(dst) == before
        dst.check_conservation()
    return dict(buf=buf, codes=codes)


@case
def partial_import_rolls_back_staged_pages(st):
    src = st.mgr()
    table = src.allocate("a", 12)
    _fill_pages(st, src, table, seed=5)
    slabs = [src.export_page(p) for p in table]
    dst = st.mgr()
    cache = st.Cache(dst)
    before = _image(dst)
    calls = {"n": 0}
    real = dst.write_page

    def dying_write(page, k, v):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("DCN transfer died mid-page")
        real(page, k, v)

    dst.write_page = dying_write
    with pytest.raises(RuntimeError, match="mid-page"):
        cache.import_prefix(list(range(12)), [k for k, _ in slabs],
                            [v for _, v in slabs])
    after = _image(dst)
    assert after[1:] == before[1:]
    assert len(cache.tree) == 0
    dst.check_conservation()
    return dict(free=after[1], written=calls["n"])


@case
def import_validates_geometry_before_touching_pool(st):
    dst = st.mgr(page_size=4)
    cache = st.Cache(dst)
    free0 = dst.num_free_pages
    bad = np.zeros((1, 8, 1, 2), np.float32)
    ok = np.zeros((1, 4, 1, 2), np.float32)
    errs = [_code(lambda: cache.import_prefix(list(range(8)), [bad, bad],
                                              [bad, bad])),
            _code(lambda: cache.import_prefix([1, 2, 3], [ok], [ok]))]
    assert errs == [("ValueError", None)] * 2
    assert dst.num_free_pages == free0
    dst.check_conservation()
    return dict(errs=errs)


def _dfa(st, pattern, letters, n_vocab):
    vocab = ["<eos>"] + list(letters)
    vocab += [f"t{i}" for i in range(len(vocab), n_vocab)]
    return st.C.compile_regex(pattern, vocab, eos_token_id=0)


@case
def grammar_roundtrip_preserves_fingerprint_and_masks(st):
    dfa = _dfa(st, "(ab|cd)*e", "abcde", 32)
    meta, arrays = st.W.grammar_to_wire(dfa)
    buf = st.W.encode_message("submit", {"grammar": meta}, arrays)
    _, m, arrs = st.W.decode_message(buf)
    back = st.W.grammar_from_wire(m["grammar"], arrs)
    assert back.fingerprint == dfa.fingerprint
    assert back.start == dfa.start and back.pattern == dfa.pattern
    np.testing.assert_array_equal(back.trans, dfa.trans)
    np.testing.assert_array_equal(back.accepting, dfa.accepting)
    return dict(buf=buf)


@case
def grammar_frame_missing_array_is_schema_error(st):
    dfa = _dfa(st, "ab*", "ab", 16)
    meta, arrays = st.W.grammar_to_wire(dfa)
    arrays.pop("grammar_accepting")
    return dict(err=_code(lambda: st.W.grammar_from_wire(meta, arrays)))


def _telemetry_frame(n_spans=2):
    return {
        "host_id": 3, "pid": 4242, "seq": 7, "t_ns": 123456789,
        "metrics_text": "# TYPE x_total counter\nx_total 1\n",
        "gauges": {"queue_depth": 2.0}, "signals": {}, "events": [],
        "memory": {"kv_live": 4096},
        "spans": [{"name": "engine.prefill", "event_type": "UserDefined",
                   "start_ns": 100 + i, "end_ns": 200 + i,
                   "trace_id": "req-1", "args": {"request_id": i}}
                  for i in range(n_spans)],
    }


@case
def telemetry_roundtrip_and_rejections(st):
    W = st.W
    frame = _telemetry_frame()
    buf = W.encode_telemetry(frame)
    assert W.decode_telemetry(buf) == frame
    out = dict(buf=buf)
    out["trunc"] = [_code(lambda: W.decode_telemetry(
        buf[:W.PREAMBLE_NBYTES - 1])), _code(
        lambda: W.decode_telemetry(buf[:-10]))]
    meta, arrays = W.telemetry_to_wire(_telemetry_frame())
    meta["telemetry_version"] = W.TELEMETRY_VERSION + 1
    out["skew"] = _code(lambda: W.telemetry_from_wire(meta, arrays))
    skew = bytearray(W.encode_telemetry(_telemetry_frame()))
    struct.pack_into("<H", skew, 4, W.WIRE_VERSION + 1)
    out["envelope_skew"] = _code(lambda: W.decode_telemetry(bytes(skew)))
    missing = []
    for key in ("host_id", "pid", "seq", "t_ns"):
        meta, arrays = W.telemetry_to_wire(_telemetry_frame())
        del meta["telemetry"][key]
        try:
            W.telemetry_from_wire(meta, arrays)
        except W.WireError as e:
            missing.append((e.code, key in e.detail))
    out["missing"] = missing
    cols = []
    meta, arrays = W.telemetry_to_wire(_telemetry_frame())
    meta["span_types"] = meta["span_types"][:-1]
    cols.append(_code(lambda: W.telemetry_from_wire(meta, arrays)))
    meta2, arrays2 = W.telemetry_to_wire(_telemetry_frame())
    arrays2.pop("span_end_ns")
    cols.append(_code(lambda: W.telemetry_from_wire(meta2, arrays2)))
    meta3, arrays3 = W.telemetry_to_wire(_telemetry_frame())
    arrays3["span_start_ns"] = arrays3["span_start_ns"][:-1]
    cols.append(_code(lambda: W.telemetry_from_wire(meta3, arrays3)))
    out["cols"] = cols
    out["foreign"] = _code(lambda: W.decode_telemetry(
        W.encode_message("kv", {"a": 1})))
    assert out["skew"] == out["envelope_skew"] == ("WireError",
                                                   "version_skew")
    assert missing == [("schema", True)] * 4
    assert cols == [("WireError", "schema")] * 3
    assert out["foreign"] == ("WireError", "schema")
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax_stack(name):
    want = CASES[name](STACKS["jax"])
    got = CASES[name](STACKS["torch"])
    assert got == want


# ---------------------------------------------------------------------------
# cross-decoding: each package reads the other's frames
# ---------------------------------------------------------------------------

def _page_frame(st, dtype):
    mgr = st.mgr(num_pages=8, page_size=4, dtype=dtype)
    table = mgr.allocate("a", 12)
    _fill_pages(st, mgr, table, seed=9, dtype=dtype)
    ks, vs = zip(*(mgr.export_page(p) for p in table))
    return st.W.encode_pages("kv_handoff", {"tokens": list(range(1, 13)),
                                            "kv_dtype": dtype},
                             list(ks), list(vs))


def _grammar_frame(st):
    meta, arrays = st.W.grammar_to_wire(_dfa(st, "(ab|cd)*e", "abcde",
                                             32))
    return st.W.encode_message("submit", {"grammar": meta}, arrays)


FRAMES = {
    "pages_bf16": lambda st: _page_frame(st, "bfloat16"),
    "pages_fp32": lambda st: _page_frame(st, "float32"),
    "pages_default_dtype": lambda st: st.W.encode_pages(
        "kv", {}, [st.host(_content((1, 4, 1, 2), 1, "bfloat16"),
                           "bfloat16")],
        [st.host(_content((1, 4, 1, 2), 2, "bfloat16"), "bfloat16")]),
    "grammar": _grammar_frame,
    "telemetry": lambda st: st.W.encode_telemetry(_telemetry_frame()),
}


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_each_package_decodes_the_others_frames(frame, writer, reader):
    """The writer's frame equals the reader's own frame for the same
    content byte for byte; the reader decodes it, and its re-encoding of
    what it decoded is the same bytes again (bf16 included)."""
    w, r = STACKS[writer], STACKS[reader]
    buf = FRAMES[frame](w)
    assert buf == FRAMES[frame](r)
    kind, meta, arrays = r.W.decode_message(buf)
    if frame == "telemetry":
        assert r.W.decode_telemetry(buf) == _telemetry_frame()
        again = r.W.encode_telemetry(r.W.decode_telemetry(buf))
    elif frame == "grammar":
        dfa = r.W.grammar_from_wire(meta["grammar"], arrays)
        m2, a2 = r.W.grammar_to_wire(dfa)
        again = r.W.encode_message(kind, {"grammar": m2}, a2)
    else:
        ks, vs = r.W.decode_pages(meta, arrays)
        # what encode_pages adds itself (n_pages; a defaulted kv_dtype)
        added = ("n_pages", "kv_dtype") if frame == "pages_default_dtype" \
            else ("n_pages",)
        meta = {k: v for k, v in meta.items() if k not in added}
        again = r.W.encode_pages(kind, meta, ks, vs)
    assert again == buf


@pytest.mark.parametrize("dtype", DTYPES)
def test_pages_framed_by_one_package_import_into_the_others_cache(dtype):
    """A prefix exported from the JAX pool lands in the port's cache and
    the reverse, with every page byte equal to its source and both pools
    conserved."""
    for w, r in (("jax", "torch"), ("torch", "jax")):
        W, R = STACKS[w], STACKS[r]
        src = W.mgr(num_pages=8, page_size=4, dtype=dtype)
        table = src.allocate("a", 8)
        _fill_pages(W, src, table, seed=11, dtype=dtype)
        ks, vs = zip(*(src.export_page(p) for p in table))
        buf = W.W.encode_pages("kv_handoff", {"tokens": list(range(1, 9)),
                                              "kv_dtype": dtype},
                               list(ks), list(vs))
        kind, meta, arrays = R.W.decode_message(buf)
        dst = R.mgr(num_pages=8, page_size=4, dtype=dtype)
        cache = R.Cache(dst)
        out = cache.import_prefix(meta["tokens"],
                                  *R.W.decode_pages(meta, arrays))
        assert out["imported_pages"] == 2
        shared, n_cached, _ = cache.lookup(list(range(1, 9)) + [5])
        assert n_cached == 8
        for p_dst, p_src in zip(shared, table):
            for a, b in zip(dst.export_page(p_dst), src.export_page(p_src)):
                assert _b(a) == _b(b)
        dst.check_conservation()
        src.check_conservation()


def test_host_arrays_move_bf16_bits_unchanged():
    t = torch.randn(3, 5, dtype=torch.float32).to(torch.bfloat16)[:, 1:4]
    h = to_host(t)
    assert h.dtype == BFLOAT16 and h.shape == (3, 3)
    assert torch.equal(from_host(h, torch.bfloat16), t)
    ref = h.view(np.uint16).view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        ref.astype(np.float32), t.to(torch.float32).numpy())
    f = torch.randn(2, 4)
    assert np.array_equal(to_host(f), f.numpy())


def test_write_page_refuses_a_slab_of_another_geometry():
    mgr = _torch_mgr(dtype="float32")
    with pytest.raises(ValueError, match="geometry"):
        mgr.write_page(1, np.zeros((1, 8, 1, 2), np.float32),
                       np.zeros((1, 8, 1, 2), np.float32))
    mgr.check_conservation()


def test_no_port_module_imports_ml_dtypes():
    """bf16 crosses the wire without ``ml_dtypes``: no module of the port
    imports it (the card's machine does not have it)."""
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), \
                path
