"""Flash attention, forward and backward — counterpart of
``paddle_tpu/ops/flash_attention.py``.

Internal layout ``(BH, S, D)`` with batch·heads flattened; GQA without
repeated KV: ``k``/``v`` carry ``BH / kv_rep`` rows and query row ``b``
reads KV row ``b // kv_rep`` (consecutive query heads share a KV head).
The masks are the JAX package's: causal keeps ``row + causal_offset >=
col`` (``causal_offset = sk − sq``, end-aligned, 0 for self-attention),
and keys at or past ``kv_valid`` are masked.

Three kernels (CUDA C++, ``csrc/flash_attention.cu``) replace the Pallas
ones: the forward with its log-sum-exp (``_fwd_kernel``), dQ
(``_bwd_dq_kernel``) and dK/dV (``_bwd_dkv_kernel``). Each has its plain
PyTorch version here (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`),
which carries out the kernels' math step by step; a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises. The source's
header says what bounds the kernels on the card and what their design
does about it.

Where the JAX package pads S to a multiple of 128 and masks the padded
keys with ``kv_valid`` (``flash_attention_bhsd``), the kernels here
bound-check any S; the results are the same. There is no sequence
threshold like ``_pallas_ok``: the tensor's device alone picks the path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._common import check_cuda_tensor, load_cuda_library

_NEG_INF = -1e30  # additive mask fill — the same value as the kernels'

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _keep_mask(sq, sk, causal, kv_valid, causal_offset, device):
    """(sq, sk) bool: the keys each query row may attend."""
    col = torch.arange(sk, device=device)[None, :]
    keep = col < (kv_valid if kv_valid is not None else sk)
    if causal:
        row = torch.arange(sq, device=device)[:, None]
        keep = keep & (row + causal_offset >= col)
    return keep.expand(sq, sk)


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
                    kv_rep=1):
    """The forward kernel's math in one pass: fp32 scores, masked
    probabilities exactly 0, P cast to ``v.dtype`` before P·V (fp32
    sums), and the log-sum-exp. Returns ``(out, lse)``: ``out`` in
    ``q.dtype``, ``lse`` (BH, Sq) fp32. A row with no key to attend gives
    out 0 and lse ``-1e30``, as from the kernels."""
    kr, vr = _rep_kv(k, kv_rep), _rep_kv(v, kv_rep)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_valid,
                      causal_offset, q.device)
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
                    causal_offset=0, kv_rep=1):
    """The backward kernels' math: ``delta = Σ dO·O``, ``p = exp(s −
    lse)`` masked to exactly 0, ``dp = dO·Vᵀ``, ``ds = p·(dp − delta)``;
    dQ = ds·K·scale, dV = pᵀ·dO, dK = dsᵀ·Q·scale, with dK/dV summed over
    each KV head's ``kv_rep`` query heads in fp32. ``ds`` is cast to the
    input dtype before dQ and dK and ``dO`` before dP, while dV takes P in
    fp32, as ``_bwd_dkv_kernel`` does; the bf16 kernel carries that P as
    a hi/lo pair of bf16 tiles (about 16 mantissa bits). Returns ``(dq,
    dk, dv)`` in the dtypes of ``q``, ``k`` and ``v``."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kr, vr = _rep_kv(k, kv_rep), _rep_kv(v, kv_rep)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    keep = _keep_mask(sq, sk, causal, kv_valid, causal_offset, q.device)
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


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_launch_fns = {}

# pointer arguments of each entry point, then the shared scalars
_N_PTRS = {"flash_attention_fwd_launch": 5,
           "flash_attention_bwd_dq_launch": 7,
           "flash_attention_bwd_dkv_launch": 8}


def _kernel_fn(name):
    fn = _launch_fns.get(name)
    if fn is None:
        fn = getattr(load_cuda_library("flash_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * _N_PTRS[name]
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
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


def _launch(name, ptrs, q, k, kv_rep, scale, causal, kv_valid,
            causal_offset):
    bh, sq, d = q.shape
    sk = k.shape[1]
    kv_limit = sk if kv_valid is None else max(0, min(int(kv_valid), sk))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn(name)(
        *ptrs, bh, sq, sk, d, kv_rep, _KERNEL_DTYPES[q.dtype], int(causal),
        int(causal_offset), kv_limit, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def flash_fwd_kernel(q, k, v, scale, causal, kv_valid=None, causal_offset=0,
                     kv_rep=1):
    """Launch the forward kernel (same contract as
    :func:`flash_fwd_plain`). Counts one launch in
    ``flash_fwd_kernel.launches``."""
    _check_qkv(q, k, v, kv_rep)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()), q, k, kv_rep, scale, causal, kv_valid,
            causal_offset)
    flash_fwd_kernel.launches += 1
    return out, lse


def _delta(out, do):
    """``Σ dO·O`` per query row in fp32 — computed outside the kernels,
    as ``_flash_bwd_pallas`` does (l.292)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale, causal,
                        kv_valid=None, causal_offset=0, kv_rep=1):
    """Launch the dQ kernel. Counts one launch in
    ``flash_bwd_dq_kernel.launches``."""
    _check_qkv(q, k, v, kv_rep)
    _check_bwd_extras(q, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, kv_rep, scale, causal, kv_valid, causal_offset)
    flash_bwd_dq_kernel.launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, scale, causal,
                         kv_valid=None, causal_offset=0, kv_rep=1):
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
            q, k, kv_rep, scale, causal, kv_valid, causal_offset)
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


#: kernel launches since the last reset (the plain versions never count)
flash_fwd_kernel.launches = 0
flash_bwd_dq_kernel.launches = 0
flash_bwd_dkv_kernel.launches = 0


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

def flash_attention_fwd(q, k, v, scale, causal, kv_valid=None,
                        causal_offset=0, kv_rep=1):
    """``(out, lse)``. CPU tensors: the plain version. CUDA tensors: the
    forward kernel."""
    if q.is_cuda:
        return flash_fwd_kernel(q, k, v, scale, causal, kv_valid,
                                causal_offset, kv_rep)
    return flash_fwd_plain(q, k, v, scale, causal, kv_valid, causal_offset,
                           kv_rep)


def flash_attention_bwd(q, k, v, out, lse, do, scale, causal, kv_valid=None,
                        causal_offset=0, kv_rep=1):
    """``(dq, dk, dv)``. CPU tensors: the plain version. CUDA tensors:
    ``delta`` in PyTorch, then the dQ and the dK/dV kernels."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, out, lse, do, scale, causal,
                               kv_valid, causal_offset, kv_rep)
    delta = _delta(out, do)
    dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale, causal,
                             kv_valid, causal_offset, kv_rep)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, scale, causal,
                                  kv_valid, causal_offset, kv_rep)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``_flash_bhsd_inner``'s custom_vjp: the forward saves ``(q, k, v,
    out, lse)``; the backward computes ``delta``, then dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_valid, causal_offset,
                kv_rep):
        out, lse = flash_attention_fwd(q, k, v, scale, causal, kv_valid,
                                       causal_offset, kv_rep)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, kv_valid, causal_offset, kv_rep)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bhsd(q, k, v, scale, causal, kv_rep: int = 1):
    """(BH, S, D) flash attention, differentiable. ``sq != sk`` with
    ``causal`` is end-aligned (row i attends cols <= i + sk − sq), as in
    the JAX package. ``kv_rep`` > 1: k/v carry BH / kv_rep rows (GQA)."""
    sq, sk = q.shape[1], k.shape[1]
    offset = (sk - sq) if causal and sq != sk else 0
    return FlashAttentionFunction.apply(q, k, v, scale, causal, None, offset,
                                        kv_rep)


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
