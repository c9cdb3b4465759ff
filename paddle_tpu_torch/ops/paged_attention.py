"""Paged attention + the block-table KV-cache manager — counterpart of
``paddle_tpu/ops/paged_attention.py``.

KV lives in fixed-size pages of one pre-allocated pool per layer; each
sequence owns a list of pages through its block table, and page 0 is
the reserved pad page that padded block-table slots and pad tokens
point at.

Two attention ops, each a hand-written CUDA kernel with a plain PyTorch
version beside it (CPU tensors take the plain version, CUDA tensors
launch the kernel; see each source's header for what bounds it on the
card and what its design does about it):

* :func:`ragged_paged_attention` serves the engine's unified step: one
  call covers a flat axis of packed tokens from mixed prefill and decode
  rows, each attending to ITS row's pages under the one mask rule
  ``key_pos <= positions[t]`` (``csrc/ragged_paged_attention.cu``:
  wgmma tiles for runs of a row's prompt tokens, the flash-decoding key
  split of ``csrc/paged_decode.cuh`` for the tokens flagged ``decoding``:
  the route follows the token, so a token's bits do not depend on how
  the engine packed it);
* :func:`paged_attention` serves the legacy pipeline's decode step: one
  query per row over ``pos < seq_len`` (``csrc/paged_decode_attention.cu``:
  the same key split, a row's keys cut into chunks walked by blocks of
  their own, then merged in chunk order). :func:`decode_split` picks the
  chunk from host integers; :func:`paged_attention_split_plain` is the
  split-then-merge arithmetic in plain PyTorch.

:func:`paged_write` and :func:`paged_prefill_attention_plain` (the
legacy pipeline's K/V scatter and its prefix-cache suffix prefill) are
plain PyTorch on every device, as their JAX counterparts are XLA code
with no Pallas kernel behind them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ._common import (check_cuda_tensor, count_launches, load_cuda_library,
                      resolve_device, sm_count)

_NEG_INF = -1e30  # additive mask fill — the same value as the kernels'

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 token_row, positions, kv_lens=None,
                                 scale: Optional[float] = None):
    """Gather/mask composition of ``ragged_paged_attention_array``.

    q:            (T, nh, d)   — packed queries (pad slots: token_row -1)
    k_pages:      (P, page, nkv, d)
    v_pages:      (P, page, nkv, d)
    block_tables: (R, max_pages) int32 (pad: reserved page 0)
    token_row:    (T,) int32 — owning row per token; -1 = pad slot
    positions:    (T,) int32 — absolute KV position per token
    kv_lens:      (R,) int32 — page-skip hint for the kernel; unused here
    Returns (T, nh, d) in the pool dtype.

    Like the JAX array path, the probabilities are cast to ``v``'s dtype
    before P·V (the kernel keeps them in fp32; in bf16 that is the
    difference the card-side comparison allows for). Unlike the JAX
    array path, pad slots come out exactly 0, as from the Pallas kernel
    and the CUDA kernel, so the three agree on every row.
    """
    del kv_lens
    t, nh, d = q.shape
    page = k_pages.shape[1]
    nkv = k_pages.shape[2]
    n_rows, max_pages = block_tables.shape
    rep = nh // nkv
    s = scale if scale is not None else 1.0 / math.sqrt(d)

    valid = token_row >= 0
    row_c = token_row.long().clamp(0, n_rows - 1)
    bt_tok = block_tables.long()[row_c]                     # (T, W)
    k = k_pages[bt_tok].reshape(t, max_pages * page, nkv, d)
    v = v_pages[bt_tok].reshape(t, max_pages * page, nkv, d)

    key_pos = torch.arange(max_pages * page, device=q.device)[None, :]
    mask = (key_pos <= positions.long()[:, None]) & valid[:, None]
    qg = q.reshape(t, nkv, rep, d)
    scores = torch.einsum("tgrd,tsgd->tgrs", qg.float(), k.float()) * s
    scores = scores.masked_fill(~mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tgrs,tsgd->tgrd", probs.to(v.dtype), v)
    out = out.reshape(t, nh, d)
    return torch.where(valid[:, None, None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

#: wgmma rows of the tensor-core route: a tile's tokens times the GQA
#: group's heads (``csrc/ragged_paged_attention.cu``)
_TILE_ROWS = 64
#: the kernels' routes, each counted in ``route_launches``
RAGGED_ROUTES = ("wgmma", "key_split")


def ragged_tile_size(dtype, page: int, nh: int, nkv: int) -> int:
    """Tokens a tile of the ragged kernel, chosen from dtype and shapes
    before the launch: ``64 / (nh / nkv)`` where the tensor-core route
    takes the call (bf16/fp16 pools, a page of at least 8 slots that
    divides 64, a GQA group that divides 64), so that a tile's tokens
    times the group's heads fill wgmma's 64 rows; else 1, every token its
    own tile on the key-split route. (A page under 8 slots would start a
    TMA box inside a 1024-byte swizzle atom.)"""
    rep = nh // nkv
    if (dtype in (torch.bfloat16, torch.float16) and page % 8 == 0
            and _TILE_ROWS % page == 0 and _TILE_ROWS % rep == 0):
        return _TILE_ROWS // rep
    return 1


def ragged_route(dtype, page: int, nh: int, nkv: int) -> Tuple[str, ...]:
    """The kernels one call launches: the wgmma kernel for tiles of two
    or more tokens where :func:`ragged_tile_size` allows them, and always
    the key split (single-token tiles and pad slots)."""
    if ragged_tile_size(dtype, page, nh, nkv) > 1:
        return RAGGED_ROUTES
    return ("key_split",)


#: a split's chunk is a whole number of these keys (two load steps of a
#: block at bf16 d 128, 8 warps x 2 keys x 4 unrolled loads each; on the
#: H100 64-key chunks ran slower than 128 at every shape of the smoke's
#: decode batch)
DECODE_CHUNK_KEYS = 128
#: most fp32 chunk states (a token, a chunk, a head) one call's scratch
#: holds: 68 MB at d 128
DECODE_MAX_STATES = 1 << 17


def decode_rep(nh: int, nkv: int) -> int:
    """Query heads a key-split block holds: the largest of 4, 2, 1 that
    divides the GQA group, so that they share one kv head (the kernels'
    ``decode::block_rep``)."""
    rep = nh // nkv
    return 4 if rep % 4 == 0 else 2 if rep % 2 == 0 else 1


def decode_split(span: int, batch: int, nh: int, nkv: int, sm_count: int,
                 per_sm: int, slots: Optional[int] = None) -> Tuple[int, int]:
    """``(chunk, n_chunks)`` of the key split: a token of L keys is cut
    into ``ceil(L / chunk)`` parts of equal length, each walked by a
    block of its own; ``n_chunks = ceil(span / chunk)`` is the most parts
    a token can have.

    Chosen from host integers only (the table's span ``width·page``, the
    rows, the heads, the card's SM count and the ``per_sm`` blocks of the
    kernel one SM holds; never the lengths, which live on the card): as
    many parts as keep ``batch`` rows of the whole span within one wave
    of resident blocks (a part that waits for a later wave, or for its
    block's earlier items, costs more than it saves), each chunk a
    multiple of ``DECODE_CHUNK_KEYS`` keys, and no more than the scratch
    of ``slots`` tokens (default ``batch``) holds in ``DECODE_MAX_STATES``
    states. One chunk (``chunk >= span``) writes every row from its split
    block, with no merge."""
    slots = batch if slots is None else slots
    groups = nh // decode_rep(nh, nkv)
    most = -(-span // DECODE_CHUNK_KEYS)
    fill = per_sm * sm_count // max(1, batch * groups)
    room = DECODE_MAX_STATES // max(1, slots * nh)
    n = max(1, min(most, fill, room))
    chunk = -(-(-(-span // n)) // DECODE_CHUNK_KEYS) * DECODE_CHUNK_KEYS
    return chunk, -(-span // chunk)


def _split_scratch(slots, n_chunks, nh, d, device):
    """The split's fp32 chunk states and each token's chunk count, or
    ``(None, None)`` for one chunk."""
    if n_chunks == 1:
        return None, None
    part = torch.empty(slots * n_chunks * nh * (d + 2), dtype=torch.float32,
                       device=device)
    return part, torch.empty(slots, dtype=torch.int32, device=device)


def _chunking(span, chunk, default):
    """``(chunk, n_chunks)``: ``default()`` (decode_split's) unless the
    caller forces a chunk size."""
    if chunk is None:
        return default()
    if chunk < 1:
        raise ValueError(f"chunk must be a positive key count, got {chunk}")
    return chunk, -(-span // chunk)


def ragged_tiles(token_row, n_rows: int, ts: int, decoding):
    """The tiles of the flat token axis, in plain torch ops (no host
    sync): each token's tile start, -1 for a pad slot (a row outside
    ``[0, n_rows)``). A run is a stretch of consecutive tokens of one
    row; a token that ``decoding`` (bool (T,)) flags is a run of its
    own; a tile starts at every ``ts``-th token of a run. This is what
    the kernels' warp scan finds; ``tile_map`` of
    :func:`ragged_paged_attention_kernel` reports the kernels' own."""
    row = token_row.long()
    idx = torch.arange(row.shape[0], device=row.device)
    valid = (row >= 0) & (row < n_rows)
    prev = torch.cat([row.new_full((1,), -2), row[:-1]])
    dec = decoding.bool()
    run_start = valid & ((prev != row) | dec
                         | torch.cat([dec.new_zeros(1), dec[:-1]]))
    first = torch.cummax(torch.where(run_start, idx, torch.zeros_like(idx)),
                         0).values
    tile_start = valid & ((idx - first) % ts == 0)
    start = torch.cummax(torch.where(tile_start, idx, torch.zeros_like(idx)),
                         0).values
    return torch.where(valid, start, torch.full_like(start, -1)).int()


_launch_fn = None


def _kernel_fn():
    global _launch_fn
    if _launch_fn is None:
        fn = load_cuda_library("ragged_paged_attention") \
            .ragged_paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(library: str, symbol: str, nh: int, nkv: int,
                   head_dim: int, dtype) -> int:
    """Blocks of a key-split kernel one SM holds (the card's occupancy),
    from ``symbol`` of ``csrc/<library>.cu``."""
    fn = getattr(load_cuda_library(library), symbol)
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(nh, nkv, head_dim, _KERNEL_DTYPES[dtype])
    if n < 1:
        raise RuntimeError(f"{symbol}: no kernel for nh={nh} nkv={nkv} "
                           f"d={head_dim} {dtype}")
    return n


def ragged_split(n_tokens: int, n_rows: int, span: int, nh: int, nkv: int,
                 head_dim: int, dtype, device) -> Tuple[int, int]:
    """The ragged kernel's key split, ``(chunk, n_chunks)``:
    :func:`decode_split` with the rows as the batch (the tokens that
    decode are found on the card, at most one a row on the engine's
    packing), a scratch for every token, and the blocks per SM that the
    key-split kernel's persistent grid holds."""
    return decode_split(span, min(n_tokens, n_rows), nh, nkv,
                        sm_count(device),
                        _blocks_per_sm("ragged_paged_attention",
                                       "ragged_key_split_blocks_per_sm", nh,
                                       nkv, head_dim, dtype), slots=n_tokens)


def paged_split(batch: int, span: int, nh: int, nkv: int, head_dim: int,
                dtype, device) -> Tuple[int, int]:
    """The paged decode kernel's key split, ``(chunk, n_chunks)``:
    :func:`decode_split` with the blocks per SM its split kernel holds."""
    return decode_split(span, batch, nh, nkv, sm_count(device),
                        _blocks_per_sm("paged_decode_attention",
                                       "paged_decode_blocks_per_sm", nh, nkv,
                                       head_dim, dtype))


def ragged_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory a block of the wgmma kernel takes at this
    head dim (for the smoke run's report)."""
    fn = load_cuda_library("ragged_paged_attention") \
        .ragged_paged_attention_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim)


def _check_paged_inputs(q, k_pages, v_pages, block_tables, meta):
    """The checks both paged kernels' wrappers share: q (rows, nh, d) and
    the pools (P, page, nkv, d) in one kernel dtype, d 64 or 128, whole
    GQA groups, int32 tables and 1-D int32 metadata (``meta``: name ->
    tensor), one device, contiguous, q and the pools 16-byte aligned."""
    check_cuda_tensor("k_pages", k_pages, tuple(_KERNEL_DTYPES), ndim=4)
    check_cuda_tensor("v_pages", v_pages, (k_pages.dtype,), ndim=4)
    check_cuda_tensor("q", q, (k_pages.dtype,), ndim=3)
    check_cuda_tensor("block_tables", block_tables, (torch.int32,), ndim=2)
    for name, a in meta.items():
        check_cuda_tensor(name, a, (torch.int32,), ndim=1)
    nh, d = q.shape[1:]
    nkv, d_kv = k_pages.shape[2:]
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if d_kv != d or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {d_kv}); the kernel takes "
                         f"{_KERNEL_HEAD_DIMS}")
    if nh % nkv:
        raise ValueError(f"nh={nh} must be a multiple of nkv={nkv}")
    if any(a.device != q.device
           for a in (k_pages, v_pages, block_tables, *meta.values())):
        raise ValueError("all inputs must be on one device")
    if any(a.data_ptr() % 16 for a in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must be 16-byte aligned")


def ragged_paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                  token_row, positions, kv_lens, decoding,
                                  scale: Optional[float] = None,
                                  route: Optional[str] = None,
                                  tile_map=None, chunk: Optional[int] = None):
    """Launch the CUDA kernels (same contract as the plain version; the
    output is allocated here in the pool dtype). ``decoding``, a bool
    (T,) tensor, routes each token: a flagged token (a decode step's, a
    speculative span's) takes the key split alone, whatever its
    neighbours; every other token takes the wgmma tiles of its run where
    the call takes them, a lone one too (all false: every token on the
    tiles). So a token's output is the same bits wherever the engine
    packs it: a speculative span's tokens equal the same tokens decoded
    one at a time. ``route=None`` takes :func:`ragged_route`'s kernels;
    ``"key_split"`` sends every token through the key split (any dtype
    and page size). ``tile_map``, an
    int32 (T,) tensor, receives each token's tile start as the kernels
    found it (-1 for pads). ``chunk`` forces the key split's chunk size
    (default :func:`ragged_split`'s). Counts one call in
    ``ragged_paged_attention.launches`` and one launch per kernel in
    ``ragged_paged_attention.route_launches`` (``"merge"``: the merge of
    split tokens, launched whenever the span takes more than one
    chunk)."""
    _check_paged_inputs(q, k_pages, v_pages, block_tables,
                        dict(token_row=token_row, positions=positions,
                             kv_lens=kv_lens))
    if decoding is None:
        raise ValueError("the kernels route each token by its decoding "
                         "flag: pass a (T,) bool tensor")
    check_cuda_tensor("decoding", decoding, (torch.bool,), ndim=1)
    if decoding.shape[0] != q.shape[0] or decoding.device != q.device:
        raise ValueError("decoding must be (T,) on q's device")
    t, nh, d = q.shape
    n_pages, page, nkv, _ = k_pages.shape
    n_rows, width = block_tables.shape
    if token_row.shape[0] != t or positions.shape[0] != t \
            or kv_lens.shape[0] != n_rows:
        raise ValueError("token metadata does not match q / block_tables")
    if n_rows == 0 or width == 0:
        raise ValueError("block_tables must have a row and a page")
    routes = ragged_route(k_pages.dtype, page, nh, nkv)
    if route is not None:
        if route != "key_split" and route not in routes:
            raise ValueError(f"route {route!r} does not take this call "
                             f"(it takes {routes})")
        routes = (route,) if route == "key_split" else routes
    ts = (ragged_tile_size(k_pages.dtype, page, nh, nkv)
          if "wgmma" in routes else 1)
    if tile_map is not None:
        check_cuda_tensor("tile_map", tile_map, (torch.int32,), ndim=1)
        if tile_map.shape[0] != t or tile_map.device != q.device:
            raise ValueError("tile_map must be (T,) on q's device")
    span = width * page
    chunk, n_chunks = _chunking(span, chunk, lambda: ragged_split(
        t, n_rows, span, nh, nkv, d, k_pages.dtype, q.device))
    part, n_split = _split_scratch(t, n_chunks, nh, d, q.device)
    tensors = (q, k_pages, v_pages, block_tables, token_row, positions,
               kv_lens)
    out = torch.empty((t, nh, d), dtype=k_pages.dtype, device=q.device)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        *(a.data_ptr() for a in tensors), decoding.data_ptr(),
        out.data_ptr(),
        *(None if a is None else a.data_ptr()
          for a in (tile_map, part, n_split)),
        t, n_rows, width, n_pages, page, nh, nkv, d,
        _KERNEL_DTYPES[k_pages.dtype], ts, chunk, n_chunks, s, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    ragged_paged_attention.launches += 1
    if t:
        for r in routes + (("merge",) if n_chunks > 1 else ()):
            ragged_paged_attention.route_launches[r] += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, token_row,
                           positions, kv_lens, scale: Optional[float] = None,
                           mesh=None, mp_axis: str = "mp", *, decoding=None):
    """CPU tensors: the plain version (a token's result does not depend
    on its route there; ``decoding`` is unused). CUDA tensors: the CUDA
    kernels, which need ``decoding``
    (:func:`ragged_paged_attention_kernel`).

    ``mesh`` (a ``parallel.mesh.ServingMesh`` whose ``mp_axis`` degree
    is above 1) runs the head-sharded wrapper of the reference
    (``_ragged_paged_attention_shard_mapped``, l.383): each chip runs
    the op on its whole GQA groups (:func:`ragged_paged_attention_chips`)
    and the outputs are joined on the head axis on ``q``'s device.
    There is no collective: attention has no sum across heads. The
    pools are :class:`HeadShards` (a sharded manager's) or whole
    tensors, which are cut into one contiguous slab a chip first."""
    if mesh is not None and mesh.shape.get(mp_axis, 1) > 1:
        chips = mesh.shape[mp_axis]
        devs = mesh.devices.reshape(-1).tolist()
        ks, vs = (p.slabs if isinstance(p, HeadShards)
                  else HeadShards.split(p, devs).slabs
                  for p in (k_pages, v_pages))
        outs = ragged_paged_attention_chips(
            split_heads(q, chips, devs), ks, vs, block_tables, token_row,
            positions, kv_lens, scale, decoding=decoding)
        return torch.cat([o.to(q.device) for o in outs], dim=1)
    if q.is_cuda:
        return ragged_paged_attention_kernel(
            q, k_pages, v_pages, block_tables, token_row, positions,
            kv_lens, decoding, scale)
    return ragged_paged_attention_plain(
        q, k_pages, v_pages, block_tables, token_row, positions, kv_lens,
        scale)


def split_heads(x, chips: int, devices) -> List[torch.Tensor]:
    """``x`` (..., heads, d) cut into ``chips`` contiguous head slabs in
    chip order, each on its chip's device."""
    n = x.shape[-2]
    if n % chips:
        raise ValueError(f"{n} heads do not split over {chips} chips")
    k = n // chips
    return [x[..., c * k:(c + 1) * k, :].to(devices[c]).contiguous()
            for c in range(chips)]


def ragged_paged_attention_chips(qs, k_slabs, v_slabs, block_tables,
                                 token_row, positions, kv_lens,
                                 scale: Optional[float] = None, *,
                                 decoding=None) -> List[torch.Tensor]:
    """The op on every chip of a serving mesh: chip ``c`` runs it on its
    query heads ``qs[c]`` (T, nh/n, d) and its pool slabs (P, page,
    nkv/n, d), each on the chip's device (the row metadata is
    replicated: copied to a chip's device where it lies elsewhere).
    Returns the chips' outputs (T, nh/n, d), in chip order. Each chip's
    kernel reads only its own contiguous slab."""
    meta = {}
    outs = []
    for q, kp, vp in zip(qs, k_slabs, v_slabs):
        dev = q.device
        if dev not in meta:
            meta[dev] = [None if a is None else a.to(dev) for a in (
                block_tables, token_row, positions, kv_lens, decoding)]
        bt, tr, pos, kvl, dec = meta[dev]
        outs.append(ragged_paged_attention(q, kp, vp, bt, tr, pos, kvl,
                                           scale, decoding=dec))
    return outs


class HeadShards:
    """A tensor cut on its head axis (the second last) over the chips of
    a serving mesh: ``slabs[c]`` is chip ``c``'s contiguous slab on its
    device. The reference keeps one global array placed over the
    devices; here each chip's slab is a tensor of its own, and
    ``shape``, ``dtype`` and ``nbytes`` describe the global tensor.
    Indexing gives the global tensor's part, its heads joined in chip
    order on the first chip's device (a copy: write through
    :meth:`write`)."""

    def __init__(self, slabs):
        self.slabs = list(slabs)

    @classmethod
    def split(cls, x, devices) -> "HeadShards":
        return cls(split_heads(x, len(devices), devices))

    @property
    def shape(self) -> torch.Size:
        s = list(self.slabs[0].shape)
        s[-2] = sum(t.shape[-2] for t in self.slabs)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.slabs[0].dtype

    @property
    def device(self):
        return self.slabs[0].device

    @property
    def nbytes(self) -> int:
        return sum(int(t.nbytes) for t in self.slabs)

    def __getitem__(self, idx):
        dev = self.slabs[0].device
        return torch.cat([t[idx].to(dev) for t in self.slabs], dim=-2)

    def write(self, idx, value) -> None:
        """``global[idx] = value``: each chip's heads of ``value`` into
        its slab, in place."""
        off = 0
        for t in self.slabs:
            k = t.shape[-2]
            t[idx] = value[..., off:off + k, :].to(t.device)
            off += k

    def copy_within(self, idx_dst, idx_src) -> None:
        """``global[idx_dst] = global[idx_src]``, chip by chip, in
        place."""
        for t in self.slabs:
            t[idx_dst].copy_(t[idx_src])


#: op calls on the card since the last reset (the plain version never
#: counts), and kernel launches by route and of the key split's merge
count_launches(ragged_paged_attention, RAGGED_ROUTES + ("merge",))


# ---------------------------------------------------------------------------
# The legacy pipeline: one-query paged decode, the K/V scatter, and the
# prefix-cache suffix prefill
# ---------------------------------------------------------------------------

def _grouped_attention(q, k, v, mask, scale):
    """The shared body of the two legacy plain versions: fp32 scores,
    GQA without repeated KV, masked lanes at ``_NEG_INF``, probabilities
    cast to ``v``'s dtype before P·V (the JAX array paths' rounding).

    q (B, T, nkv, rep, d); k, v (B, S, nkv, d); mask (B, T, S).
    Returns (B, T, nkv, rep, d) in v's dtype."""
    scores = torch.einsum("btgrd,bsgd->bgrts", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrts,bsgd->btgrd", probs.to(v.dtype), v)


def paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                          scale: Optional[float] = None):
    """Decode-time attention over paged KV, ``paged_attention_array``'s
    gather/mask composition.

    q:            (B, nh, d)        — one query token per sequence
    k_pages:      (P, page, nkv, d) — one layer's page pool
    v_pages:      (P, page, nkv, d)
    block_tables: (B, W) int32 — page ids per sequence (pad: 0)
    seq_lens:     (B,) int32 — valid KV length per sequence; keys at
                  positions ``< seq_len`` (so at most ``W·page``) count
    Returns (B, nh, d) in the pool dtype.

    A row with ``seq_len <= 0`` comes out exactly 0, as from the Pallas
    kernel (``safe_l``) and the CUDA kernel; the JAX array path gives
    such a row the mean of its gathered V."""
    b, nh, d = q.shape
    page, nkv = k_pages.shape[1], k_pages.shape[2]
    width = block_tables.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, width * page, nkv, d)
    v = v_pages[bt].reshape(b, width * page, nkv, d)
    key_pos = torch.arange(width * page, device=q.device)
    mask = key_pos[None, None, :] < seq_lens.long()[:, None, None]
    out = _grouped_attention(q.reshape(b, 1, nkv, nh // nkv, d), k, v, mask,
                             s).reshape(b, nh, d)
    empty = (seq_lens <= 0)[:, None, None]
    return torch.where(empty, torch.zeros_like(out), out)


def paged_attention_split_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                chunk: int, scale: Optional[float] = None):
    """The key split's arithmetic (``csrc/paged_decode.cuh``) in plain
    PyTorch, same contract as :func:`paged_attention_plain`: each row's
    ``L = min(seq_len, W·page)`` keys cut into ``ceil(L / chunk)`` parts
    of ``ceil(L / parts)`` keys; per part the fp32 state ``(m, l, acc)``
    (its largest score, ``Σ exp(s − m)`` and ``Σ exp(s − m)·v``); then
    the parts folded online in order, ``M' = max(M, m)``, ``l' = l·e^(M −
    M') + l_part·e^(m − M')`` and the same for ``acc``; the output
    ``acc / l`` in the pool dtype. The probabilities stay fp32, as in the
    kernel (the array path rounds them to the pool dtype). A row with no
    key comes out exactly 0."""
    b, nh, d = q.shape
    page, nkv = k_pages.shape[1], k_pages.shape[2]
    width = block_tables.shape[1]
    span = width * page
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, span, nkv, d).float()
    v = v_pages[bt].reshape(b, span, nkv, d).float()
    n_keys = seq_lens.long().clamp(0, span)
    parts = torch.clamp(-(-n_keys // chunk), min=1)
    size = -(-n_keys // parts)                               # keys a part
    key_pos = torch.arange(span, device=q.device)
    qg = q.reshape(b, nkv, nh // nkv, d).float()
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k) * s
    mx = torch.full(scores.shape[:3], _NEG_INF, device=q.device)
    total_l = torch.zeros_like(mx)
    total = torch.zeros(*scores.shape[:3], d, device=q.device)
    for c in range(-(-span // chunk)):
        lo = (c * size)[:, None]
        sel = ((key_pos >= lo) & (key_pos < torch.minimum(
            lo + size[:, None], n_keys[:, None])))[:, None, None, :]
        m = scores.masked_fill(~sel, _NEG_INF).amax(dim=-1)
        p = torch.where(sel, torch.exp(scores - m[..., None]),
                        torch.zeros_like(scores))
        m_new = torch.maximum(mx, m)
        a_old, a = torch.exp(mx - m_new), torch.exp(m - m_new)
        total_l = total_l * a_old + p.sum(dim=-1) * a
        total = (total * a_old[..., None]
                 + torch.einsum("bgrs,bsgd->bgrd", p, v) * a[..., None])
        mx = m_new
    safe_l = torch.where(total_l == 0, torch.ones_like(total_l), total_l)
    return (total / safe_l[..., None]).reshape(b, nh, d).to(k_pages.dtype)


def paged_prefill_attention_plain(q, k_pages, v_pages, block_tables, q_start,
                                  scale: Optional[float] = None):
    """Chunked/suffix prefill attention over paged KV —
    ``paged_prefill_attention_array``. The prefix-cache path: suffix
    queries at absolute positions ``q_start + t`` attend to the cached
    prefix pages AND the suffix's own (already scattered) K/V under
    ``key_pos <= q_start + t`` over the gathered page span.

    q: (B, T, nh, d); pools (P, page, nkv, d); block_tables (B, W) int32
    (pad: page 0); q_start (B,) int32. Returns (B, T, nh, d)."""
    b, t, nh, d = q.shape
    page, nkv = k_pages.shape[1], k_pages.shape[2]
    width = block_tables.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, width * page, nkv, d)
    v = v_pages[bt].reshape(b, width * page, nkv, d)
    q_pos = q_start.long()[:, None] + torch.arange(t, device=q.device)
    key_pos = torch.arange(width * page, device=q.device)
    mask = key_pos[None, None, :] <= q_pos[:, :, None]
    out = _grouped_attention(q.reshape(b, t, nkv, nh // nkv, d), k, v, mask,
                             s)
    return out.reshape(b, t, nh, d)


def paged_write(k_pages, v_pages, k_new, v_new, block_tables, positions):
    """Write one token's K/V per row into its page slot, IN PLACE (the
    JAX ``paged_write_array`` returns new pools; the port returns the
    arguments).

    k_pages/v_pages: (P, page, nkv, d); k_new/v_new: (B, nkv, d);
    block_tables (B, W); positions (B,) absolute position of each row's
    new token.

    A position at or past the table span (``W·page``) — a legacy decode
    chunk over-decoding a finished row — writes into the reserved pad
    page 0. The JAX write there is dropped (its page lookup falls out
    of range); page 0 is the place whose contents no real row reads, and
    the write never lands on a row's own slot, which a clamp to the last
    slot would overwrite."""
    page = k_pages.shape[1]
    width = block_tables.shape[1]
    pos = positions.long()
    inside = pos < width * page
    idx = torch.where(inside, pos // page, torch.zeros_like(pos))
    phys = block_tables.long().gather(1, idx[:, None])[:, 0]
    phys = torch.where(inside, phys, torch.zeros_like(phys))
    off = pos % page
    k_pages[phys, off] = k_new.to(k_pages.dtype)
    v_pages[phys, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


_decode_fn = None


def _decode_kernel_fn():
    global _decode_fn
    if _decode_fn is None:
        fn = load_cuda_library("paged_decode_attention") \
            .paged_decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _decode_fn = fn
    return _decode_fn


def paged_attention_kernel(q, k_pages, v_pages, block_tables, seq_lens,
                           scale: Optional[float] = None,
                           chunk: Optional[int] = None):
    """Launch the CUDA decode kernels (same contract as
    :func:`paged_attention_plain`; the output is allocated here in the
    pool dtype): the key split over ``(chunk, head group, row)`` blocks,
    then, where the span takes more than one chunk, the merge. ``chunk``
    forces the chunk size (default :func:`paged_split`'s; a chunk of the
    whole span is one block per row and head group, as the kernel was
    before the split). Counts one call in ``paged_attention.launches``
    and each kernel's launches in ``paged_attention.route_launches``."""
    _check_paged_inputs(q, k_pages, v_pages, block_tables,
                        dict(seq_lens=seq_lens))
    b, nh, d = q.shape
    _, page, nkv, _ = k_pages.shape
    width = block_tables.shape[1]
    if block_tables.shape[0] != b or seq_lens.shape[0] != b:
        raise ValueError("block_tables / seq_lens do not match q's rows")
    span = width * page
    chunk, n_chunks = _chunking(span, chunk, lambda: paged_split(
        b, span, nh, nkv, d, k_pages.dtype, q.device))
    part, n_split = _split_scratch(b, n_chunks, nh, d, q.device)
    tensors = (q, k_pages, v_pages, block_tables, seq_lens)
    out = torch.empty((b, nh, d), dtype=k_pages.dtype, device=q.device)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _decode_kernel_fn()(
        *(a.data_ptr() for a in tensors), out.data_ptr(),
        *(None if a is None else a.data_ptr() for a in (part, n_split)),
        b, width, page, nh, nkv, d, _KERNEL_DTYPES[k_pages.dtype], chunk,
        n_chunks, s, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    if b:
        for r in ("key_split", "merge")[:1 + (n_chunks > 1)]:
            paged_attention.route_launches[r] += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    scale: Optional[float] = None):
    """CPU tensors: the plain version. CUDA tensors: the CUDA kernel."""
    if q.is_cuda:
        return paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                      seq_lens, scale)
    return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 seq_lens, scale)


#: op calls on the card since the last reset (the plain version never
#: counts), and the launches of its two kernels
count_launches(paged_attention, ("key_split", "merge"))


# ---------------------------------------------------------------------------
# Host-side page pool (the allocator metadata; device tensors hold the data)
# ---------------------------------------------------------------------------

class PagedKVCacheManager:
    """Page pool + per-sequence block tables.

    The pools are one pre-allocated tensor pair ``(L, P, page, nkv, d)``
    on the device; this class manages only host metadata (free list,
    per-sequence page lists). Page 0 is reserved as the pad page so
    padded block-table slots always point at valid memory.
    """

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 *, device=None):
        self.page_size = page_size
        self.num_pages = num_pages
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # 0 reserved
        self._tables: dict = {}   # seq_id -> List[int]
        self._lens: dict = {}     # seq_id -> int
        self._page_nb: int = 0    # page_nbytes memo (geometry is fixed)
        #: chips the pool is head-sharded over (:meth:`shard_heads`); the
        #: memory ledger splits per-chip bytes off it
        self.mesh_chips: int = 1

    # -- allocation ---------------------------------------------------------

    def can_allocate(self, n_tokens: int) -> bool:
        """Whether ``n_tokens`` fit in the free pages now. An allocation
        that does not fit raises ``MemoryError`` (after :meth:`_oom`)."""
        return len(self._free) >= self.pages_for(n_tokens)

    @staticmethod
    def pages_needed(n_tokens: int, page_size: int) -> int:
        """Pages covering ``n_tokens`` at ``page_size`` granularity."""
        return (n_tokens + page_size - 1) // page_size

    def pages_for(self, n_tokens: int) -> int:
        return self.pages_needed(n_tokens, self.page_size)

    @property
    def usable_pages(self) -> int:
        """Allocatable pool capacity (page 0 is the reserved pad page)."""
        return self.num_pages - 1

    @property
    def page_nbytes(self) -> int:
        """Device bytes of ONE page (K and V across every layer), read
        off the pool tensors' ``nbytes`` (host metadata) and memoized:
        the memory ledger's byte unit."""
        pb = self._page_nb
        if not pb:
            pb = self._page_nb = (
                int(self.k_pages.nbytes)
                + int(self.v_pages.nbytes)) // self.num_pages
        return pb

    def _oom(self, source: str, need: int) -> None:
        """Every ``MemoryError`` this pool raises first lands in the
        memory ledger (an ``oom_pressure`` event and a once-per-reason
        flight bundle; gated on ``memory_armed`` inside)."""
        from ..observability.memory import note_oom
        note_oom(source, self, need_pages=need,
                 free_pages=len(self._free))

    def allocate(self, seq_id, n_tokens: int) -> List[int]:
        """Reserve pages for a new sequence of n_tokens (prefill)."""
        need = self.pages_for(n_tokens)
        if len(self._free) < need:
            self._oom("allocate", need)
            raise MemoryError(
                f"KV pool exhausted: need {need} pages, "
                f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = pages
        self._lens[seq_id] = n_tokens
        return pages

    def extend(self, seq_id, n_new: int = 1) -> None:
        """Grow a sequence; acquires a page on boundary crossings."""
        new_len = self._lens[seq_id] + n_new
        need = self.pages_for(new_len) - len(self._tables[seq_id])
        for _ in range(need):
            if not self._free:
                self._oom("extend", 1)
                raise MemoryError("KV pool exhausted on extend")
            self._tables[seq_id].append(self._free.pop())
        self._lens[seq_id] = new_len

    def free(self, seq_id) -> None:
        self._free.extend(reversed(self._tables.pop(seq_id)))
        self._lens.pop(seq_id)

    def sequence_pages(self, seq_id) -> List[int]:
        """The sequence's block table in token order (a copy)."""
        return list(self._tables.get(seq_id, ()))

    def sequence_len(self, seq_id) -> int:
        """Committed token length of a live sequence (0 if unknown)."""
        return int(self._lens.get(seq_id, 0))

    def seq_len(self, seq_id) -> int:
        """Token length of a live sequence; ``KeyError`` if unknown
        (the reference's l.631)."""
        return self._lens[seq_id]

    # -- speculative tail growth / rollback ----------------------------------

    def grow_to(self, seq_id, n_tokens: int) -> List[int]:
        """Make the sequence's block table cover ``n_tokens`` without
        committing them: drafted tokens write past the committed length,
        so their pages must exist before the step while the committed
        length stays put until the draft is verified. Raises
        ``MemoryError`` (table untouched) when the pool cannot cover the
        span; callers shrink the draft. Returns the pages added."""
        need = self.pages_for(n_tokens) - len(self._tables[seq_id])
        if need <= 0:
            return []
        if len(self._free) < need:
            self._oom("grow_to", need)
            raise MemoryError(
                f"KV pool exhausted on speculative grow: need {need} "
                f"pages, {len(self._free)} free")
        added = [self._free.pop() for _ in range(need)]
        self._tables[seq_id].extend(added)
        return added

    def truncate_pages(self, seq_id, keep_pages: int) -> List[int]:
        """Roll the sequence's pages back to its first ``keep_pages``: a
        page that holds only rejected draft tokens returns to the pool
        (stale K/V inside kept pages is overwritten before anything
        attends to it). The committed length is clamped into the kept
        span. Returns the pages freed."""
        table = self._tables[seq_id]
        freed: List[int] = []
        while len(table) > keep_pages:
            p = table.pop()
            self._free.append(p)
            freed.append(p)
        if self._lens.get(seq_id, 0) > keep_pages * self.page_size:
            self._lens[seq_id] = keep_pages * self.page_size
        return freed

    def check_conservation(self) -> None:
        """Exclusive-ownership audit: every usable page is either free or
        owned by exactly one sequence exactly once, the two sets are
        disjoint, and reserved page 0 never circulates."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("duplicate pages on the free list")
        owned: List[int] = []
        for table in self._tables.values():
            owned.extend(table)
        owned_set = set(owned)
        if len(owned) != len(owned_set):
            raise RuntimeError("page owned by two sequences (or twice "
                               "by one) under exclusive ownership")
        if free & owned_set:
            raise RuntimeError(
                f"page state overlap: free∩owned={free & owned_set}")
        if 0 in free | owned_set:
            raise RuntimeError("reserved page 0 entered circulation")
        total = len(free) + len(owned_set)
        if total != self.usable_pages:
            raise RuntimeError(
                f"page conservation violated: {len(free)} free + "
                f"{len(owned_set)} owned = {total} != "
                f"{self.usable_pages} usable")

    # -- multi-chip layout (tensor-parallel serving) -------------------------

    def shard_heads(self, mesh, mp_axis: str = "mp") -> None:
        """Head-shard both pools over the mesh's ``mp_axis`` (l.604):
        whole GQA (kv-head) groups per chip, each chip's share of both
        pools one contiguous tensor on its device (:class:`HeadShards`:
        the kernel reads a chip's slab, never a view of the whole pool).
        Pure layout: the page books are host-side and chip-agnostic. The
        kv-head count must divide by the degree. A degree-1 mesh keeps
        the plain tensors, on its device."""
        chips = int(mesh.shape[mp_axis])
        nkv = self.k_pages.shape[3]
        if nkv % chips:
            raise ValueError(
                f"num_kv_heads={nkv} must divide by the TP degree "
                f"{chips} (whole GQA groups per chip)")
        devs = mesh.devices.reshape(-1).tolist()
        if chips == 1:
            self.k_pages = self.k_pages.to(devs[0])
            self.v_pages = self.v_pages.to(devs[0])
        else:
            self.k_pages = HeadShards.split(self.k_pages, devs)
            self.v_pages = HeadShards.split(self.v_pages, devs)
        self.mesh_chips = chips

    # -- views --------------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def block_tables(self, seq_ids) -> Tuple[np.ndarray, np.ndarray]:
        """(block_tables (B, max_pages), seq_lens (B,)) for a batch;
        padded slots point at reserved page 0."""
        tables = [self._tables[s] for s in seq_ids]
        width = max(len(t) for t in tables)
        bt = np.zeros((len(tables), width), np.int32)
        for i, t in enumerate(tables):
            bt[i, :len(t)] = t
        lens = np.asarray([self._lens[s] for s in seq_ids], np.int32)
        return bt, lens
