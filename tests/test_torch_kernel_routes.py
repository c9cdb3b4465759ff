"""The pure functions that pick a kernel's work before a launch, on the
CPU: the ragged kernel's tile list (``ragged_tiles``, the plain form of
the scan each CUDA kernel runs over the token axis) against a numpy
reference on random layouts, its tile size and routes, the decode key
split's chunking (``decode_split``), the weight-gradient kernel's route
and row split, and the LayerNorm backward's launch (``ln_bwd_config``).
On the card, tests/test_torch_gpu.py holds the kernels' own tile map to
``ragged_tiles`` and each route to its plain version."""

import inspect

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_linear as fl
from paddle_tpu_torch.ops import layer_norm_fused as ln
from paddle_tpu_torch.ops import paged_attention as pa


def _tiles_numpy(token_row, n_rows, ts):
    """Each token's tile start (-1 for a pad), by walking the axis: a run
    is a stretch of consecutive tokens of one row, a tile every ts-th
    token of a run."""
    out = np.full(len(token_row), -1, np.int64)
    run_first, tile = -1, -1
    for t, r in enumerate(token_row):
        if not 0 <= r < n_rows:
            run_first = -1
            continue
        if t == 0 or token_row[t - 1] != r:
            run_first = t
        if (t - run_first) % ts == 0:
            tile = t
        out[t] = tile
    return out


def _layout(rng, n_rows, runs, pad_between, tail_pads):
    """A token axis of the given run lengths (rows drawn at random, so a
    row may own several runs), pads between runs with probability
    ``pad_between``, and ``tail_pads`` pads at the end. Neighbouring runs
    of one row merge into one, as the kernels see them."""
    rows = []
    for n in runs:
        rows += [int(rng.randint(n_rows))] * n
        if rng.rand() < pad_between:
            rows += [-1] * int(rng.randint(1, 4))
    rows += [-1] * tail_pads
    return np.asarray(rows, np.int32)


_RUNS = [1, 63, 64, 65, 200, 1, 1, 7, 130]


@pytest.mark.parametrize("ts", [64, 16, 8, 2, 1])
@pytest.mark.parametrize("seed", range(6))
def test_ragged_tiles_match_numpy(ts, seed):
    rng = np.random.RandomState(seed)
    runs = list(rng.permutation(_RUNS))
    token_row = _layout(rng, n_rows=5, runs=runs, pad_between=0.4,
                        tail_pads=int(rng.randint(0, 70)))
    got = pa.ragged_tiles(torch.from_numpy(token_row), 5, ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _tiles_numpy(token_row, 5, ts))


@pytest.mark.parametrize("layout", ["interleaved", "runs", "pads_only",
                                    "out_of_range"])
def test_ragged_tiles_layouts(layout):
    """Rows alternating token by token (every tile one token), a
    scheduler-like packing (prefill runs of 63/64/65/200 and decode
    tokens, T = 436, not a multiple of 64), all pads, and rows past the
    tables (pads too)."""
    if layout == "interleaved":
        token_row = np.tile(np.array([0, 1, 2], np.int32), 40)
    elif layout == "runs":
        token_row = np.asarray([0] * 63 + [1] + [2] * 64 + [3] * 65
                               + [4] * 200 + [5, 6, 7] + [-1] * 40,
                               np.int32)
    elif layout == "pads_only":
        token_row = np.full(100, -1, np.int32)
    else:
        token_row = np.asarray([0, 0, 9, 9, 1, -5, 1, 1], np.int32)
    n_rows = 8
    for ts in (64, 32, 4, 1):
        got = pa.ragged_tiles(torch.from_numpy(token_row), n_rows, ts)
        want = _tiles_numpy(token_row, n_rows, ts)
        np.testing.assert_array_equal(got.numpy(), want)
        # every tile: consecutive tokens of one row, at most ts of them
        for start in set(want[want >= 0]):
            members = np.nonzero(want == start)[0]
            assert members[0] == start
            assert np.array_equal(members, np.arange(start,
                                                     start + len(members)))
            assert len(members) <= ts
            assert len(set(token_row[members])) == 1
    if layout == "interleaved":
        assert np.array_equal(want, np.arange(len(token_row)))
    if layout == "runs":
        starts = sorted(set(_tiles_numpy(token_row, n_rows, 64)) - {-1})
        assert starts == [0, 63, 64, 128, 192, 193, 257, 321, 385, 393,
                          394, 395]


@pytest.mark.parametrize("dtype,page,nh,nkv,want", [
    (torch.bfloat16, 16, 32, 32, 64),     # Llama-2-7B: 64 tokens a tile
    (torch.bfloat16, 16, 32, 8, 16),      # GQA 4: 16 tokens x 4 heads
    (torch.float16, 16, 8, 2, 16),
    (torch.bfloat16, 64, 8, 1, 8),
    (torch.bfloat16, 8, 64, 1, 1),        # a group of 64 heads: one token
    (torch.bfloat16, 4, 32, 32, 1),       # a page under 8 slots
    (torch.bfloat16, 12, 32, 32, 1),      # a page that does not divide 64
    (torch.bfloat16, 128, 32, 32, 1),
    (torch.bfloat16, 16, 12, 4, 1),       # a group of 3 heads
    (torch.float32, 16, 32, 32, 1),       # fp32 pools: the key split
])
def test_ragged_tile_size_and_route(dtype, page, nh, nkv, want):
    assert pa.ragged_tile_size(dtype, page, nh, nkv) == want
    routes = pa.ragged_route(dtype, page, nh, nkv)
    assert routes == (("wgmma", "key_split") if want > 1
                      else ("key_split",))
    assert set(routes) <= set(pa.RAGGED_ROUTES)


# (span, batch, nh, nkv, SMs, blocks an SM, slots): the legacy 7B decode
# step (MHA and GQA), the unified step's 256 tokens over 8 rows, a span of
# one page, spans that are not a multiple of 128, a large batch, a group of
# 3 heads
_SPLITS = [
    (1024, 8, 32, 32, 132, 3, None), (1024, 8, 32, 8, 132, 2, None),
    (1024, 8, 32, 32, 132, 3, 256), (1024, 8, 32, 8, 132, 1, 256),
    (16, 1, 4, 4, 132, 4, None), (37, 3, 12, 4, 132, 3, None),
    (4100, 2, 64, 8, 132, 2, 2048), (512, 512, 32, 32, 132, 3, None),
    (1, 1, 1, 1, 1, 1, None), (96, 6, 8, 2, 114, 8, 40),
]


@pytest.mark.parametrize("case", _SPLITS, ids=str)
def test_decode_split_covers_the_span(case):
    """Every key of the span falls in exactly one chunk (chunks of a
    whole number of 128-key steps, the last one holding the span's end),
    the grid is never empty and stays within one wave of resident blocks
    unless one chunk already fills it, and the scratch stays within
    DECODE_MAX_STATES states unless there is one chunk (no scratch)."""
    span, batch, nh, nkv, sms, per_sm, slots = case
    chunk, n_chunks = pa.decode_split(span, batch, nh, nkv, sms, per_sm,
                                      slots)
    assert chunk % pa.DECODE_CHUNK_KEYS == 0 and n_chunks >= 1
    assert (n_chunks - 1) * chunk < span <= n_chunks * chunk
    owner = np.arange(span) // chunk
    assert np.array_equal(np.bincount(owner, minlength=n_chunks) > 0,
                          np.ones(n_chunks, bool))
    assert n_chunks == 1 or (slots or batch) * n_chunks * nh \
        <= pa.DECODE_MAX_STATES
    groups = nh // pa.decode_rep(nh, nkv)
    assert n_chunks == 1 or batch * groups * n_chunks <= per_sm * sms


@pytest.mark.parametrize("case,want", [
    # the 7B legacy decode step, 8 rows: MHA's 256 blocks already fill
    # most of a wave of 3 an SM; GQA 4's 64 blocks take 4 parts
    ((1024, 8, 32, 32, 132, 3), (1024, 1)),
    ((1024, 8, 32, 8, 132, 2), (256, 4)),
    ((1024, 8, 32, 8, 132, 8), (128, 8)),      # at most a part a 128 keys
    ((1024, 1, 32, 32, 132, 3), (128, 8)),     # one long row
    ((1024, 8, 32, 8, 132, 2, 2048), (512, 2)),  # the scratch's limit
    ((1024, 256, 32, 32, 132, 3), (1024, 1)),  # the card already full
    ((16, 1, 4, 4, 132, 4), (128, 1)),         # a span under one step
])
def test_decode_split_choices(case, want):
    assert pa.decode_split(*case) == want


def test_decode_split_reads_host_integers_only():
    """The split is a function of integers (no tensor, no lengths), so
    the wrappers choose a grid without reading anything from the card;
    more SMs or more blocks an SM never give fewer chunks, a longer span
    never fewer keys a chunk."""
    params = inspect.signature(pa.decode_split).parameters
    assert list(params) == ["span", "batch", "nh", "nkv", "sm_count",
                            "per_sm", "slots"]
    rng = np.random.RandomState(0)
    for _ in range(200):
        span = int(rng.randint(1, 9000))
        batch = int(rng.randint(1, 300))
        nkv = int(rng.choice([1, 2, 4, 8, 32]))
        nh = nkv * int(rng.choice([1, 2, 3, 4, 8]))
        sms = int(rng.randint(1, 200))
        per_sm = int(rng.randint(1, 9))
        a = pa.decode_split(span, batch, nh, nkv, sms, per_sm)
        assert a == pa.decode_split(span, batch, nh, nkv, sms, per_sm)
        assert all(isinstance(x, int) for x in a)
        assert pa.decode_split(span, batch, nh, nkv, 2 * sms, per_sm)[1] \
            >= a[1]
        assert pa.decode_split(span, batch, nh, nkv, sms, 2 * per_sm)[1] \
            >= a[1]
        assert pa.decode_split(2 * span, batch, nh, nkv, sms, per_sm)[0] \
            >= a[0]


@pytest.mark.parametrize("nh,nkv,want", [(32, 32, 1), (32, 16, 2),
                                         (32, 8, 4), (16, 2, 4), (12, 4, 1),
                                         (24, 4, 2)])
def test_decode_rep(nh, nkv, want):
    assert pa.decode_rep(nh, nkv) == want


@pytest.mark.parametrize("rows,h,want", [
    (8192, 1024, (4, 264, 4)),      # BERT-large: a warp a row, 4 rows
    (8192, 768, (4, 264, 4)),       # ERNIE-base: BLOCK_H 1024
    (5, 1000, (4, 2, 4)),           # rows not a multiple of the tile
    (37, 1024, (4, 10, 4)),
    (600, 256, (4, 150, 4)),
    (3, 2048, (2, 2, 4)),           # two warps a row
    (16384, 4096, (1, 264, 4)),     # four warps a row
    (1, 64, (1, 1, 1)),
])
def test_ln_bwd_config(rows, h, want):
    """Tiles of whole rows (a power of two, never more rows than there
    are), one warp a row up to 32 elements a lane, four warps a tile, two
    programs per SM and never more programs than tiles."""
    cfg = ln.ln_bwd_config(rows, h, 132)
    assert (cfg.rows_per_tile, cfg.programs, cfg.num_warps) == want
    block_h = 1 << (h - 1).bit_length()
    tiles = -(-rows // cfg.rows_per_tile)
    assert cfg.rows_per_tile & (cfg.rows_per_tile - 1) == 0
    assert 1 <= cfg.programs <= tiles
    assert cfg.num_warps == cfg.rows_per_tile * max(1, block_h // 1024)


@pytest.mark.parametrize("rows,din,dout,dtype,aligned,want", [
    (4096, 4096, 4096, torch.bfloat16, True, "wgmma"),
    (4096, 4096, 11008, torch.bfloat16, True, "wgmma"),
    (4096, 11008, 4096, torch.float16, True, "wgmma"),
    (1000, 4096, 1000, torch.bfloat16, True, "wgmma"),  # 2000 B rows
    (37, 13, 29, torch.bfloat16, True, "wmma"),          # 26 B rows
    (64, 8, 12, torch.bfloat16, True, "wmma"),
    (0, 64, 48, torch.bfloat16, True, "wmma"),           # no rows
    (64, 64, 64, torch.bfloat16, False, "wmma"),         # a base off 16 B
    (4096, 4096, 4096, torch.float32, True, "fma"),      # never TF32
    (37, 13, 29, torch.float32, True, "fma"),
])
def test_grad_add_route(rows, din, dout, dtype, aligned, want):
    assert fl.grad_add_route(rows, din, dout, dtype, aligned) == want
    assert want in fl.GRAD_ADD_ROUTES


@pytest.mark.parametrize("rows,din,dout,want", [
    (4096, 4096, 4096, 1),      # 512 tiles: four waves
    (4096, 11008, 4096, 1),
    (1000, 4096, 1000, 1),      # 128 tiles, 16 slices: too few to split
    (8192, 512, 512, 16),       # 8 tiles
    (4096, 1024, 1024, 4),
    (600, 512, 512, 1),
    (64, 8, 16, 1),
])
def test_grad_add_split(rows, din, dout, want):
    split = fl.grad_add_split(rows, din, dout, sms=132)
    assert split == want
    slices = -(-rows // 64)
    per = -(-slices // split)
    # every part walks at least one slice, and the parts cover the rows
    assert (split - 1) * per < slices <= split * per
    tiles = -(-din // 128) * -(-dout // 256)
    assert split == 1 or (tiles * split <= 132 and per >= 8)


def test_library_name_hashes_every_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every header under csrc/,
    so an edit to a shared header (sm90.cuh, paged_decode.cuh) rebuilds
    every library, and an unrelated source does not change it."""
    from paddle_tpu_torch.ops import _common
    monkeypatch.setattr(_common, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    (tmp_path / "b.cu").write_text("// b\n")
    first = _common._so_path("a")
    assert _common._so_path("a") == first
    (tmp_path / "b.cu").write_text("// b, edited\n")
    assert _common._so_path("a") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _common._so_path("a") != first
    (tmp_path / "g.cuh").write_text("// a new header\n")
    assert _common._so_path("a") not in (first,)


def test_ptxas_report_reads_each_entry(monkeypatch):
    """The smoke run's register and spill check reads nvcc's -Xptxas -v
    report per entry function."""
    from paddle_tpu_torch.ops import _common
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN6gemm9014grad_add_"
        "wgmmaI13__nv_bfloat16fLb0EEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN6gemm9014grad_add_wgmma",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
        "8key_splitIfLi128ELi2EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_18key_split",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 8320 bytes smem",
    ])
    monkeypatch.setattr(_common, "build_cuda_sources", lambda names: None)
    monkeypatch.setitem(_common.build_logs, "fake", log)
    got = _common.ptxas_report("fake")
    assert got == {
        "_ZN6gemm9014grad_add_wgmmaI13__nv_bfloat16fLb0EEEvNS_6ParamsE":
            dict(registers=168, spill_stores=0, spill_loads=0),
        "_ZN12_GLOBAL__N_18key_splitIfLi128ELi2EEEvPKT_":
            dict(registers=64, spill_stores=4, spill_loads=12)}
