"""Flash attention, forward and backward — counterpart of
``paddle_tpu/ops/flash_attention.py``.

Internal layout ``(BH, S, D)`` with batch·heads flattened; GQA without
repeated KV: ``k``/``v`` carry ``BH / kv_rep`` rows and query row ``b``
reads KV row ``b // kv_rep`` (consecutive query heads share a KV head).
The masks are the JAX package's: causal keeps ``row + causal_offset >=
col`` (``causal_offset = sk − sq``, end-aligned, 0 for self-attention),
keys at or past ``kv_valid`` are masked, and with segment ids ``seg_q``/
``seg_k`` (int32) only ``seg_q[row] == seg_k[col]`` is kept. The ids come
in ``_seg3``'s two layouts: one row per batch entry, ``(R, S)``, which
query row ``bh`` reads at ``bh // (BH / R)`` (heads are consecutive per
batch entry), or one ``(S,)`` row shared by every ``bh``.

Three kernels (CUDA C++, ``csrc/flash_attention.cu``) replace the Pallas
ones: the forward with its log-sum-exp (``_fwd_kernel``), dQ
(``_bwd_dq_kernel``) and dK/dV (``_bwd_dkv_kernel``). Each has its plain
PyTorch version here (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`),
which carries out the kernels' math step by step; a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises. The source's
header says what bounds the kernels on the card and what their design
does about it.

With segment ids the bf16 kernels skip tile pairs whose ids cannot meet.
They read a table of each row's [min, max] id per :data:`SEG_TILE`
positions (:func:`seg_tile_ranges`, computed here so that its exactness
is testable on the CPU); :func:`seg_tiles_disjoint` is their skip rule.

Where the JAX package pads S to a multiple of 128 and masks the padded
keys with ``kv_valid`` (``flash_attention_bhsd``) or pads the segment
ids with −1 (``flash_attention_segmented``), the kernels here
bound-check any S; the results are the same. There is no sequence
threshold like ``_pallas_ok``: the tensor's device alone picks the path.
"""

from __future__ import annotations

import ctypes
import math
import re
from typing import Optional, Tuple

import torch

from . import _common
from ._common import (_exporting, check_cuda_tensor, count_launches,
                      load_cuda_library)

_NEG_INF = -1e30  # additive mask fill — the same value as the kernels'

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)

#: positions per entry of the segment tile-range table; every tile edge of
#: the bf16 kernels is a multiple of it (``kSegTile`` in the source, checked
#: when the library loads)
SEG_TILE = 64


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _seg_rows(seg, bh):
    """Segment ids per query row: (S,) -> (1, S) shared by every bh;
    (R, S) -> (BH, S), row bh reading ``seg[bh // (BH / R)]``."""
    if seg.dim() == 1:
        return seg[None]
    return seg.repeat_interleave(bh // seg.shape[0], dim=0)


def _keep_mask(sq, sk, causal, kv_valid, causal_offset, device, seg_q=None,
               seg_k=None, bh=1):
    """The keys each query row may attend: (sq, sk) bool, or (BH or 1,
    sq, sk) with segment ids."""
    col = torch.arange(sk, device=device)[None, :]
    keep = col < (kv_valid if kv_valid is not None else sk)
    if causal:
        row = torch.arange(sq, device=device)[:, None]
        keep = keep & (row + causal_offset >= col)
    keep = keep.expand(sq, sk)
    if seg_q is None:
        return keep
    rq, rk = _seg_rows(seg_q, bh), _seg_rows(seg_k, bh)
    return keep & (rq[:, :, None] == rk[:, None, :])


def _rep_kv(t, kv_rep):
    return t if kv_rep == 1 else t.repeat_interleave(kv_rep, dim=0)


def attn_ref_kv_plain(q, k, v, scale, causal, kv_valid=None,
                      causal_offset=0):
    """``_attn_ref_kv``: fp32 scores, masked with ``-1e30``, a softmax,
    and the output in ``q.dtype``. A row with no key to attend comes out
    as the mean of ``v`` here, and as 0 from the kernels. With neither
    ``kv_valid`` nor ``causal_offset`` it is ``_attn_ref``, whose causal
    mask is end-aligned (``tril`` with ``k = sk − sq``)."""
    if kv_valid is None and causal_offset == 0:
        causal_offset = k.shape[1] - q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_valid,
                      causal_offset, q.device)
    s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_fwd_plain(q, k, v, scale, causal, kv_valid=None, causal_offset=0,
                    kv_rep=1, seg_q=None, seg_k=None):
    """The forward kernel's math in one pass: fp32 scores, masked
    probabilities exactly 0, P cast to ``v.dtype`` before P·V (fp32
    sums), and the log-sum-exp. Returns ``(out, lse)``: ``out`` in
    ``q.dtype``, ``lse`` (BH, Sq) fp32. A row with no key to attend gives
    out 0 and lse ``-1e30``, as from the kernels."""
    kr, vr = _rep_kv(k, kv_rep), _rep_kv(v, kv_rep)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_valid,
                      causal_offset, q.device, seg_q, seg_k, q.shape[0])
    s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    pv = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), vr.float())
    out = (pv / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def flash_bwd_plain(q, k, v, out, lse, do, scale, causal, kv_valid=None,
                    causal_offset=0, kv_rep=1, seg_q=None, seg_k=None):
    """The backward kernels' math: ``delta = Σ dO·O``, ``p = exp(s −
    lse)`` selected to exactly 0 where masked (a pad row's lse is −1e30,
    so its ``exp`` overflows before the selection), ``dp = dO·Vᵀ``,
    ``ds = p·(dp − delta)``; dQ = ds·K·scale, dV = pᵀ·dO, dK =
    dsᵀ·Q·scale, with dK/dV summed over each KV head's ``kv_rep`` query
    heads in fp32. ``ds`` is cast to the input dtype before dQ and dK
    and ``dO`` before dP, while dV takes P in fp32, as
    ``_bwd_dkv_kernel`` does; the bf16 kernel carries that P as a hi/lo
    pair of bf16 tiles (about 16 mantissa bits). Returns ``(dq, dk,
    dv)`` in the dtypes of ``q``, ``k`` and ``v``."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kr, vr = _rep_kv(k, kv_rep), _rep_kv(v, kv_rep)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    keep = _keep_mask(sq, sk, causal, kv_valid, causal_offset, q.device,
                      seg_q, seg_k, bh)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.to(v.dtype).float(), vr.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(),
                      kr.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    if kv_rep != 1:
        dk = dk.reshape(bh // kv_rep, kv_rep, sk, d).sum(dim=1)
        dv = dv.reshape(bh // kv_rep, kv_rep, sk, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def seg_tile_ranges(seg):
    """The bf16 kernels' segment tile-range table: ``(R, S)`` or ``(S,)``
    int32 ids -> ``(R, ceil(S / SEG_TILE), 2)`` int32, the [min, max] of
    each row's ids over positions ``[t·SEG_TILE, (t+1)·SEG_TILE)`` (only
    those below S)."""
    s = seg.shape[-1]
    rows = seg.reshape(-1, s)
    n_t = -(-s // SEG_TILE)
    pad = n_t * SEG_TILE - s
    tiles = torch.cat((rows, rows[:, -1:].expand(-1, pad)), dim=1)
    tiles = tiles.reshape(rows.shape[0], n_t, SEG_TILE)
    return torch.stack((tiles.amin(dim=-1), tiles.amax(dim=-1)),
                       dim=-1).to(torch.int32).contiguous()


def seg_tiles_disjoint(q_range, k_range):
    """The kernels' segment skip rule over ``[..., 2]`` ranges: a query
    tile and a key tile whose id ranges do not meet hold no pair with
    ``seg_q == seg_k``."""
    return (q_range[..., 1] < k_range[..., 0]) | \
        (k_range[..., 1] < q_range[..., 0])


def seg_skip_share(seg_q, seg_k):
    """The share of each segment row's (SEG_TILE × SEG_TILE) tile pairs
    that the bf16 kernels skip for their segment ids alone."""
    skip = seg_tiles_disjoint(seg_tile_ranges(seg_q)[:, :, None],
                              seg_tile_ranges(seg_k)[:, None, :])
    return float(skip.float().mean())


def seg_ref_batched_plain(q, k, v, seg, scale, causal):
    """``_seg_ref_batched``: (B, nh, S, D) attention with a per-row
    segment mask (B, S); negative ids are pads and attend nothing (their
    rows come out 0)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = seg[:, None, :, None] == seg[:, None, None, :]
    keep = keep & (seg >= 0)[:, None, :, None]
    if causal:
        n = q.shape[2]
        keep = keep & torch.ones(n, n, dtype=torch.bool,
                                 device=q.device).tril()[None, None]
    p = torch.softmax(s.masked_fill(~keep, _NEG_INF), dim=-1)
    p = torch.where(keep.any(dim=-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_launch_fns = {}

# pointer arguments of each entry point (the tensors, then seg_q, seg_k
# and their tile-range tables), then the shared scalars
_N_PTRS = {"flash_attention_fwd_launch": 9,
           "flash_attention_bwd_dq_launch": 11,
           "flash_attention_bwd_dkv_launch": 12}


def _kernel_fn(name):
    fn = _launch_fns.get(name)
    if fn is None:
        lib = load_cuda_library("flash_attention")
        tile = lib.flash_attention_seg_tile()
        if tile != SEG_TILE:
            raise RuntimeError(f"flash_attention.cu tiles segment ranges by "
                               f"{tile}, the wrapper by {SEG_TILE}")
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * _N_PTRS[name]
                       + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fns[name] = fn
    return fn


def _check_qkv(q, k, v, kv_rep):
    check_cuda_tensor("q", q, tuple(_KERNEL_DTYPES), ndim=3)
    check_cuda_tensor("k", k, (q.dtype,), ndim=3)
    check_cuda_tensor("v", v, (q.dtype,), ndim=3)
    bh, _, d = q.shape
    if not q.numel() or not k.numel():
        raise ValueError(f"empty q {tuple(q.shape)} or k {tuple(k.shape)}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d}; the kernels take "
                         f"{_KERNEL_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv_rep < 1 or k.shape[0] * kv_rep != bh:
        raise ValueError(f"k has {k.shape[0]} rows for {bh} query rows at "
                         f"kv_rep={kv_rep}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")


def _tile_ranges(seg):
    """:func:`seg_tile_ranges` of ``seg``, kept on the tensor until it is
    changed in place: the forward, dQ and dK/dV of one attention call
    read the same ids."""
    cached = getattr(seg, "_flash_tile_ranges", None)
    if cached is None or cached[0] != seg._version:
        cached = (seg._version, seg_tile_ranges(seg))
        seg._flash_tile_ranges = cached
    return cached[1]


def _check_seg(q, k, seg_q, seg_k):
    """Segment ids for the kernels: both or neither, int32, contiguous,
    (R, sq) / (R, sk) with R dividing BH, or shared (sq,) / (sk,).
    Returns the pointer arguments ``(seg_q, seg_k, q_range, k_range)``
    (the range tables for bf16 only) and ``seg_div``, the row of query
    row ``bh`` being ``bh // seg_div``."""
    bh, sq = q.shape[:2]
    if seg_q is None and seg_k is None:
        return (None,) * 4, 1
    if seg_q is None or seg_k is None:
        raise ValueError("seg_q and seg_k go together")
    check_cuda_tensor("seg_q", seg_q, (torch.int32,))
    check_cuda_tensor("seg_k", seg_k, (torch.int32,))
    if seg_q.device != q.device or seg_k.device != q.device:
        raise ValueError("segment ids must be on q's device")
    rows = 1 if seg_q.dim() == 1 else seg_q.shape[0]
    lead = () if seg_q.dim() == 1 else (rows,)
    if seg_q.shape != lead + (sq,) or seg_k.shape != lead + (k.shape[1],) \
            or bh % rows:
        raise ValueError(f"segment ids {tuple(seg_q.shape)} / "
                         f"{tuple(seg_k.shape)} do not match q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")
    ranges = (None, None)
    if q.dtype == torch.bfloat16:
        ranges = (_tile_ranges(seg_q).data_ptr(),
                  _tile_ranges(seg_k).data_ptr())
    return (seg_q.data_ptr(), seg_k.data_ptr()) + ranges, bh // rows


def _launch(name, ptrs, q, k, kv_rep, scale, causal, kv_valid,
            causal_offset, seg_q, seg_k):
    bh, sq, d = q.shape
    sk = k.shape[1]
    kv_limit = sk if kv_valid is None else max(0, min(int(kv_valid), sk))
    seg_ptrs, seg_div = _check_seg(q, k, seg_q, seg_k)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn(name)(
        *ptrs, *seg_ptrs, bh, sq, sk, d, kv_rep,
        _KERNEL_DTYPES[q.dtype], int(causal), int(causal_offset), kv_limit,
        seg_div, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def flash_fwd_kernel(q, k, v, scale, causal, kv_valid=None, causal_offset=0,
                     kv_rep=1, seg_q=None, seg_k=None):
    """Launch the forward kernel (same contract as
    :func:`flash_fwd_plain`). Counts one launch in
    ``flash_fwd_kernel.launches``."""
    _check_qkv(q, k, v, kv_rep)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()), q, k, kv_rep, scale, causal, kv_valid,
            causal_offset, seg_q, seg_k)
    flash_fwd_kernel.launches += 1
    return out, lse


def _delta(out, do):
    """``Σ dO·O`` per query row in fp32 — computed outside the kernels,
    as ``_flash_bwd_pallas`` does (l.292)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale, causal,
                        kv_valid=None, causal_offset=0, kv_rep=1, seg_q=None,
                        seg_k=None):
    """Launch the dQ kernel. Counts one launch in
    ``flash_bwd_dq_kernel.launches``."""
    _check_qkv(q, k, v, kv_rep)
    _check_bwd_extras(q, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, kv_rep, scale, causal, kv_valid, causal_offset, seg_q,
            seg_k)
    flash_bwd_dq_kernel.launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, scale, causal,
                         kv_valid=None, causal_offset=0, kv_rep=1, seg_q=None,
                         seg_k=None):
    """Launch the dK/dV kernel: one block per (KV head, key tile) walks
    its group's query heads, so the GQA sum needs no atomics. Counts one
    launch in ``flash_bwd_dkv_kernel.launches``."""
    _check_qkv(q, k, v, kv_rep)
    _check_bwd_extras(q, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_bwd_dkv_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, kv_rep, scale, causal, kv_valid, causal_offset, seg_q,
            seg_k)
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


# a kernel's mangled name: namespace, kernel, D, SEG
_ENTRY = re.compile(r"(sm90|fp32)\d+"
                    r"flash_attention_(fwd|bwd_dq|bwd_dkv)_kernelILi(\d+)"
                    r"ELb([01])")
_KINDS = {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 2}


def kernel_resources():
    """Each instantiation of the three kernels (``"bf16 fwd d128 seg"``)
    with its registers and spill bytes from nvcc's ``-Xptxas -v`` report
    of the library's build, and its dynamic shared memory a block. The
    bf16 kernels' entry count is the launch bound; their consumer
    warpgroups raise theirs with setmaxnreg (the source's header)."""
    lib = load_cuda_library("flash_attention")
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    out = {}
    for fn, res in _common.ptxas_report("flash_attention").items():
        m = _ENTRY.search(fn)
        if m is None:
            continue
        ns, kind, d, seg = m.groups()
        out[f"{'bf16' if ns == 'sm90' else 'fp32'} {kind} d{d}"
            + (" seg" if seg == "1" else "")] = dict(
                res, smem_bytes=lib.flash_attention_smem_bytes(
                    _KINDS[kind], int(d), int(ns == "sm90")))
    return out


#: kernel launches since the last reset (the plain versions never count)
count_launches(flash_fwd_kernel)
count_launches(flash_bwd_dq_kernel)
count_launches(flash_bwd_dkv_kernel)


def _check_bwd_extras(q, do, lse, delta):
    check_cuda_tensor("do", do, (q.dtype,), ndim=3)
    check_cuda_tensor("lse", lse, (torch.float32,), ndim=2)
    check_cuda_tensor("delta", delta, (torch.float32,), ndim=2)
    if do.shape != q.shape or lse.shape != q.shape[:2] \
            or delta.shape != q.shape[:2]:
        raise ValueError("do / lse / delta do not match q")
    if do.data_ptr() % 16:
        raise ValueError("do must be 16-byte aligned")


# ---------------------------------------------------------------------------
# Dispatch by device, autograd, public entry points
# ---------------------------------------------------------------------------

@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool, kv_valid: Optional[int],
                 causal_offset: int, kv_rep: int,
                 seg_q: Optional[torch.Tensor],
                 seg_k: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 5 as a custom op, the form an exported program (``jit.save``)
    holds: the plain version on the CPU, the kernel on CUDA tensors
    (counted in ``flash_fwd_kernel.launches``)."""
    return flash_fwd_plain(q, k, v, scale, causal, kv_valid, causal_offset,
                           kv_rep, seg_q, seg_k)


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_op_cuda(q, k, v, scale, causal, kv_valid, causal_offset,
                       kv_rep, seg_q, seg_k):
    return flash_fwd_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                            scale, causal, kv_valid, causal_offset, kv_rep,
                            seg_q, seg_k)


@flash_fwd_op.register_fake
def _flash_fwd_op_fake(q, k, v, scale, causal, kv_valid, causal_offset,
                       kv_rep, seg_q, seg_k):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def flash_attention_fwd(q, k, v, scale, causal, kv_valid=None,
                        causal_offset=0, kv_rep=1, seg_q=None, seg_k=None):
    """``(out, lse)``. CPU tensors: the plain version. CUDA tensors: the
    forward kernel."""
    if _exporting[0]:
        return flash_fwd_op(q, k, v, float(scale), bool(causal), kv_valid,
                            int(causal_offset), int(kv_rep), seg_q, seg_k)
    fn = flash_fwd_kernel if q.is_cuda else flash_fwd_plain
    return fn(q, k, v, scale, causal, kv_valid, causal_offset, kv_rep,
              seg_q, seg_k)


def flash_attention_bwd(q, k, v, out, lse, do, scale, causal, kv_valid=None,
                        causal_offset=0, kv_rep=1, seg_q=None, seg_k=None):
    """``(dq, dk, dv)``. CPU tensors: the plain version. CUDA tensors:
    ``delta`` in PyTorch, then the dQ and the dK/dV kernels."""
    args = (scale, causal, kv_valid, causal_offset, kv_rep, seg_q, seg_k)
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, out, lse, do, *args)
    delta = _delta(out, do)
    dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, *args)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, *args)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``_flash_bhsd_inner``'s custom_vjp (and ``run`` of
    ``flash_attention_segmented``): the forward saves ``(q, k, v, out,
    lse)`` and the segment ids; the backward computes ``delta``, then dQ
    and dK/dV. The segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_valid, causal_offset,
                kv_rep, seg_q=None, seg_k=None):
        out, lse = flash_attention_fwd(q, k, v, scale, causal, kv_valid,
                                       causal_offset, kv_rep, seg_q, seg_k)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_k)
        ctx.args = (scale, causal, kv_valid, causal_offset, kv_rep)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg_q, seg_k = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         *ctx.args, seg_q, seg_k)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_bhsd(q, k, v, scale, causal, *, kv_rep: int = 1):
    """(BH, S, D) flash attention, differentiable. ``sq != sk`` with
    ``causal`` is end-aligned (row i attends cols <= i + sk − sq), as in
    the JAX package. ``kv_rep`` > 1: k/v carry BH / kv_rep rows (GQA)."""
    sq, sk = q.shape[1], k.shape[1]
    offset = (sk - sq) if causal and sq != sk else 0
    return FlashAttentionFunction.apply(q, k, v, scale, causal, None, offset,
                                        kv_rep)


def flash_attention_segmented(q, k, v, seg_ids, scale=None, causal=False):
    """Sequence-packed batched attention, differentiable: q/k/v (B, nh,
    S, D) with per-row segment ids (B, S); tokens attend only within
    their own segment, and negative ids are pads that attend nothing
    (their rows come out 0). As in the JAX package, pads become −1 on
    the query side and −2 on the key side, so a pad never matches a pad;
    the kernels bound-check S, so nothing is padded to 128."""
    b, nh, s, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    seg = seg_ids.to(torch.int32)
    seg_q = torch.where(seg < 0, -1, seg).contiguous()
    seg_k = torch.where(seg < 0, -2, seg).contiguous()
    qf, kf, vf = (t.contiguous().reshape(b * nh, s, d) for t in (q, k, v))
    out = FlashAttentionFunction.apply(qf, kf, vf, sc, causal, None, 0, 1,
                                       seg_q, seg_k)
    return out.reshape(b, nh, s, d)


def _segments_from_cu(cu, total):
    """cu_seqlens (B+1,) -> per-token segment ids (total,) int32."""
    cu = torch.as_tensor(cu, dtype=torch.int64)
    pos = torch.arange(total, device=cu.device)
    return torch.searchsorted(cu[1:], pos, right=True).to(torch.int32)


def flash_attention_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k,
                           scale: Optional[float] = None,
                           causal: bool = True):
    """Unpadded (packed) attention, differentiable: q/k/v (total, H, D)
    with every sequence's tokens contiguous, ``cu_seqlens_*`` (B+1,)
    cumulative lengths. One call over the whole stream with one row of
    segment ids shared by every head; causal within each sequence falls
    out of the global positions, so it needs both sides packed alike."""
    tq, h, d = q.shape
    tk = k.shape[0]
    cu_q = torch.as_tensor(cu_seqlens_q).to(q.device)
    cu_k = torch.as_tensor(cu_seqlens_k).to(q.device)
    if causal and (tq != tk or not torch.equal(cu_q, cu_k)):
        raise ValueError("flash_attention_varlen: causal=True requires "
                         "cu_seqlens_q == cu_seqlens_k (self-attention "
                         "packing)")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (t.transpose(0, 1).contiguous() for t in (q, k, v))
    out = FlashAttentionFunction.apply(
        qt, kt, vt, sc, causal, None, 0, 1, _segments_from_cu(cu_q, tq),
        _segments_from_cu(cu_k, tk))
    return out.transpose(0, 1)


def sdpa_array(q, k, v, scale: Optional[float] = None, causal: bool = False):
    """(B, S, H, D) in and out — ``_sdpa_array``. GQA (fewer KV heads)
    runs without repeating KV: the kernels share each KV head across its
    group and the backward sums the group's dK/dV."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"{hq} query heads do not group over {hk} KV heads")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    # the kernels take contiguous (BH, S, D) rows (at B = 1 the reshape
    # alone would stay a strided view)
    qt = q.transpose(1, 2).contiguous().reshape(b * hq, sq, d)
    kt = k.transpose(1, 2).contiguous().reshape(b * hk, k.shape[1], d)
    vt = v.transpose(1, 2).contiguous().reshape(b * hk, v.shape[1], d)
    out = flash_attention_bhsd(qt, kt, vt, sc, causal, kv_rep=hq // hk)
    return out.reshape(b, hq, sq, d).transpose(1, 2)
