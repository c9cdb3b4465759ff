"""Ragged paged attention + the block-table KV-cache manager —
counterpart of ``paddle_tpu/ops/paged_attention.py``.

KV lives in fixed-size pages of one pre-allocated pool per layer; each
sequence owns a list of pages through its block table, and page 0 is
the reserved pad page that padded block-table slots and pad tokens
point at.

:func:`ragged_paged_attention` serves the engine's unified step: one
call covers a flat axis of packed tokens from mixed prefill and decode
rows. Each token attends to ITS row's pages under the one mask rule
``key_pos <= positions[t]``. CPU tensors take the plain version
(:func:`ragged_paged_attention_plain`); CUDA tensors launch the
hand-written kernel in ``csrc/ragged_paged_attention.cu`` (see its
header for what bounds it on the card and what its design does about
it).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ._common import check_cuda_tensor, load_cuda_library, resolve_device

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

_launch_fn = None


def _kernel_fn():
    global _launch_fn
    if _launch_fn is None:
        fn = load_cuda_library("ragged_paged_attention") \
            .ragged_paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def ragged_paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                  token_row, positions, kv_lens,
                                  scale: Optional[float] = None):
    """Launch the CUDA kernel (same contract as the plain version; the
    output is allocated here in the pool dtype). Counts one launch in
    ``ragged_paged_attention.launches``."""
    check_cuda_tensor("k_pages", k_pages, tuple(_KERNEL_DTYPES), ndim=4)
    check_cuda_tensor("v_pages", v_pages, (k_pages.dtype,), ndim=4)
    check_cuda_tensor("q", q, (k_pages.dtype,), ndim=3)
    check_cuda_tensor("block_tables", block_tables, (torch.int32,), ndim=2)
    for name, a in (("token_row", token_row), ("positions", positions),
                    ("kv_lens", kv_lens)):
        check_cuda_tensor(name, a, (torch.int32,), ndim=1)
    t, nh, d = q.shape
    _, page, nkv, d_kv = k_pages.shape
    n_rows, width = block_tables.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if d_kv != d or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {d_kv}); the kernel takes "
                         f"{_KERNEL_HEAD_DIMS}")
    if nh % nkv or nh // nkv > 32:
        raise ValueError(f"nh={nh} must be a multiple of nkv={nkv}, at most "
                         "32 query heads per kv head")
    if token_row.shape[0] != t or positions.shape[0] != t \
            or kv_lens.shape[0] != n_rows:
        raise ValueError("token metadata does not match q / block_tables")
    tensors = (q, k_pages, v_pages, block_tables, token_row, positions,
               kv_lens)
    if any(a.device != q.device for a in tensors):
        raise ValueError("all inputs must be on one device")
    if any(a.data_ptr() % 16 for a in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty((t, nh, d), dtype=k_pages.dtype, device=q.device)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        *(a.data_ptr() for a in tensors), out.data_ptr(),
        t, n_rows, width, page, nh, nkv, d, _KERNEL_DTYPES[k_pages.dtype],
        s, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, token_row,
                           positions, kv_lens, scale: Optional[float] = None):
    """CPU tensors: the plain version. CUDA tensors: the CUDA kernel."""
    if q.is_cuda:
        return ragged_paged_attention_kernel(
            q, k_pages, v_pages, block_tables, token_row, positions,
            kv_lens, scale)
    return ragged_paged_attention_plain(
        q, k_pages, v_pages, block_tables, token_row, positions, kv_lens,
        scale)


#: kernel launches since the last reset (the plain version never counts)
ragged_paged_attention.launches = 0


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
                 device=None):
        self.page_size = page_size
        self.num_pages = num_pages
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # 0 reserved
        self._tables: dict = {}   # seq_id -> List[int]
        self._lens: dict = {}     # seq_id -> int

    # -- allocation ---------------------------------------------------------

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

    def allocate(self, seq_id, n_tokens: int) -> List[int]:
        """Reserve pages for a new sequence of n_tokens (prefill)."""
        need = self.pages_for(n_tokens)
        if len(self._free) < need:
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
                raise MemoryError("KV pool exhausted on extend")
            self._tables[seq_id].append(self._free.pop())
        self._lens[seq_id] = new_len

    def free(self, seq_id) -> None:
        self._free.extend(reversed(self._tables.pop(seq_id)))
        self._lens.pop(seq_id)

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
