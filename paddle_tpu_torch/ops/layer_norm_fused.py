"""Fused LayerNorm, forward and backward — counterpart of
``paddle_tpu/ops/layer_norm_fused.py``.

    mu = mean(x); var = mean((x − mu)²); inv = rsqrt(var + eps)
    xhat = (x − mu)·inv;  y = xhat·w + b
    dx = inv·(wg − mean(wg) − xhat·mean(wg·xhat)),  wg = w·g
    dw = Σ_rows g·xhat;  db = Σ_rows g

with fp32 math whatever the input dtype, ``y`` and ``dx`` in ``x``'s
dtype and ``dw``/``db`` in the parameters' dtype. ``eps`` is an argument
(ERNIE uses 1e-12, GPT 1e-5).

Kernels (Triton) replace the Pallas kernels ``_fwd_kernel`` (launched by
``_pallas_fwd``) and ``_bwd_kernel`` (launched by ``_pallas_bwd``). What
bounds them on an H100: memory. The forward reads ``x`` and writes ``y``
for about eight operations per element, the backward reads ``x`` and
``g`` and writes ``dx`` for about twenty, far below the card's ~295
operations per byte; the least times are ``(2·rows·h + 2·h)·itemsize /
3.35 TB/s`` and ``(3·rows·h + 3·h)·itemsize / 3.35 TB/s``. So both make
one pass over the rows:

- forward: one program owns one row, holds it in registers (``BLOCK_H``
  = next power of two >= h), takes the mean and the centred variance
  there and writes the row once;
- backward: one program owns a block of rows, recomputes mean and
  ``inv`` from ``x`` (nothing but ``(x, w, b)`` is saved, as in the
  Pallas kernel), writes each row's ``dx`` and keeps the block's
  partial ``Σ g·xhat`` and ``Σ g`` in fp32 registers, stored once into
  an ``(n_blocks, 2, h)`` buffer. A second small pass sums the blocks
  into ``dw`` and ``db``. The Pallas kernel carries ``dw``/``db``
  across its sequential grid; blocks on the card run in no order, and
  the two-pass sum needs no atomics, so ``dw`` and ``db`` are the same
  bits from run to run (``ops/rms_norm.py``'s backward does the same).

A row reduction followed by an elementwise pass is Triton's block model,
which is why these are Triton rather than CUDA C++.

:func:`layer_norm` is differentiable: with autograd recording it runs
through :class:`LayerNormFunction` (``layer_norm_fused``'s custom_vjp);
under ``no_grad`` it is the forward alone. CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

from ._common import check_cuda_tensor, triton_cache_dir
from .rms_norm import _BWD_MAX_BLOCKS, _num_warps

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _stats(xf, eps):
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def ln_plain(x, w, b, eps: float = 1e-5):
    """Plain PyTorch forward (``_ln_ref``): fp32 math, output in
    ``x.dtype``."""
    xf = x.float()
    mu, inv = _stats(xf, eps)
    return ((xf - mu) * inv * w.float() + b.float()).to(x.dtype)


def ln_bwd_plain(x, w, g, eps: float = 1e-5):
    """Plain PyTorch backward (``_ln_bwd``'s XLA branch): mean and
    ``inv`` recomputed from ``x``, fp32 math. Returns ``(dx, dw, db)``:
    ``dx`` in ``x.dtype``, ``dw`` and ``db`` (summed over every leading
    axis) in ``w.dtype``."""
    h = x.shape[-1]
    xf, gf, wf = x.float(), g.float(), w.float()
    mu, inv = _stats(xf, eps)
    xhat = (xf - mu) * inv
    wg = wf * gf
    m1 = wg.mean(dim=-1, keepdim=True)
    m2 = (wg * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (wg - m1 - xhat * m2)).to(x.dtype)
    dw = (gf * xhat).reshape(-1, h).sum(dim=0).to(w.dtype)
    db = gf.reshape(-1, h).sum(dim=0).to(w.dtype)
    return dx, dw, db


_triton_kernels = None


def _get_kernels():
    """The ``@triton.jit`` kernels, defined on first launch so that the
    module imports where Triton is not installed."""
    global _triton_kernels
    if _triton_kernels is None:
        triton_cache_dir()
        import triton
        import triton.language as tl

        @triton.jit
        def _layer_norm_fwd(x_ptr, w_ptr, b_ptr, y_ptr, h, eps,
                            BLOCK_H: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            offs = tl.arange(0, BLOCK_H)
            mask = offs < h
            x = tl.load(x_ptr + row * h + offs, mask=mask,
                        other=0.0).to(tl.float32)
            mu = tl.sum(x, axis=0) / h
            xc = tl.where(mask, x - mu, 0.0)
            inv = tl.rsqrt(tl.sum(xc * xc, axis=0) / h + eps)
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            tl.store(y_ptr + row * h + offs,
                     (xc * inv * w + b).to(y_ptr.dtype.element_ty),
                     mask=mask)

        @triton.jit
        def _layer_norm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, rows, h,
                            rows_per_block, eps, BLOCK_H: tl.constexpr):
            blk = tl.program_id(0)
            offs = tl.arange(0, BLOCK_H)
            mask = offs < h
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc_w = tl.zeros([BLOCK_H], dtype=tl.float32)
            acc_b = tl.zeros([BLOCK_H], dtype=tl.float32)
            row0 = blk.to(tl.int64) * rows_per_block
            for r in range(0, rows_per_block):
                row = row0 + r
                # rows past the end load zeros: their dx is not stored and
                # they add 0 to both partial sums
                m = mask & (row < rows)
                x = tl.load(x_ptr + row * h + offs, mask=m,
                            other=0.0).to(tl.float32)
                g = tl.load(g_ptr + row * h + offs, mask=m,
                            other=0.0).to(tl.float32)
                mu = tl.sum(x, axis=0) / h
                xc = tl.where(mask, x - mu, 0.0)
                inv = tl.rsqrt(tl.sum(xc * xc, axis=0) / h + eps)
                xhat = xc * inv
                wg = w * g
                m1 = tl.sum(wg, axis=0) / h
                m2 = tl.sum(wg * xhat, axis=0) / h
                dx = inv * (wg - m1 - xhat * m2)
                tl.store(dx_ptr + row * h + offs,
                         dx.to(dx_ptr.dtype.element_ty), mask=m)
                acc_w += g * xhat
                acc_b += g
            base = part_ptr + blk.to(tl.int64) * 2 * h
            tl.store(base + offs, acc_w, mask=mask)
            tl.store(base + h + offs, acc_b, mask=mask)

        @triton.jit
        def _layer_norm_dwdb(part_ptr, out_ptr, n_blocks, width,
                             BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
            # column sums of the (n_blocks, width) partials, width = 2·h:
            # dw in columns [0, h), db in [h, 2h)
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < width
            acc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for p0 in range(0, n_blocks, BLOCK_P):
                prow = p0 + tl.arange(0, BLOCK_P)
                m = (prow[:, None] < n_blocks) & cmask[None, :]
                part = tl.load(part_ptr + prow[:, None] * width
                               + cols[None, :], mask=m, other=0.0)
                acc += tl.sum(part, axis=0)
            tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty),
                     mask=cmask)

        _triton_kernels = (triton, _layer_norm_fwd, _layer_norm_bwd,
                           _layer_norm_dwdb)
    return _triton_kernels


def _check_params(x, w, b):
    check_cuda_tensor("x", x, _KERNEL_DTYPES)
    check_cuda_tensor("w", w, _KERNEL_DTYPES, ndim=1)
    check_cuda_tensor("b", b, (w.dtype,), ndim=1)
    if w.shape[0] != x.shape[-1] or b.shape != w.shape:
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match rows of {x.shape[-1]}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on the same device")


def layer_norm_kernel(x, w, b, eps: float = 1e-5):
    """Launch the Triton forward on CUDA tensors: ``x`` (..., h)
    contiguous, ``w`` and ``b`` (h,) of one dtype. Counts one launch in
    ``layer_norm.launches``."""
    _check_params(x, w, b)
    h = x.shape[-1]
    rows = x.numel() // h
    y = torch.empty_like(x)
    if rows == 0:
        return y
    triton, kernel = _get_kernels()[:2]
    block_h = triton.next_power_of_2(h)
    kernel[(rows,)](x, w, b, y, h, float(eps), BLOCK_H=block_h,
                    num_warps=_num_warps(block_h))
    layer_norm.launches += 1
    return y


def layer_norm_bwd_kernel(x, w, g, eps: float = 1e-5):
    """Launch the Triton backward on CUDA tensors: ``x`` and ``g``
    (..., h) of one dtype, contiguous; ``w`` (h,). Returns ``(dx, dw,
    db)``, ``dw``/``db`` in ``w.dtype``. Each call is two Triton launches
    (dx with the partial sums, then the sums) and counts ONE in
    ``layer_norm_bwd.launches``, as the one Pallas kernel it replaces is
    one call."""
    check_cuda_tensor("x", x, _KERNEL_DTYPES)
    check_cuda_tensor("w", w, _KERNEL_DTYPES, ndim=1)
    check_cuda_tensor("g", g, (x.dtype,))
    if g.shape != x.shape or w.shape[0] != x.shape[-1]:
        raise ValueError(f"g {tuple(g.shape)} / w {tuple(w.shape)} do not "
                         f"match x {tuple(x.shape)}")
    h = x.shape[-1]
    rows = x.numel() // h
    dx = torch.empty_like(x)
    dwdb = torch.empty((2, h), dtype=w.dtype, device=x.device)
    if rows == 0:
        dwdb.zero_()
        return dx, dwdb[0], dwdb[1]
    triton, _, bwd, dwdb_sum = _get_kernels()
    block_h = triton.next_power_of_2(h)
    rows_per_block = -(-rows // _BWD_MAX_BLOCKS)
    n_blocks = -(-rows // rows_per_block)
    part = torch.empty((n_blocks, 2, h), dtype=torch.float32,
                       device=x.device)
    bwd[(n_blocks,)](x, w, g, dx, part, rows, h, rows_per_block,
                     float(eps), BLOCK_H=block_h,
                     num_warps=_num_warps(block_h))
    block_c = 128
    dwdb_sum[(triton.cdiv(2 * h, block_c),)](part, dwdb, n_blocks, 2 * h,
                                             BLOCK_P=32, BLOCK_C=block_c,
                                             num_warps=4)
    layer_norm_bwd.launches += 1
    return dx, dwdb[0], dwdb[1]


def layer_norm_bwd(x, w, g, eps: float = 1e-5):
    """LayerNorm backward. CPU tensors take the plain version; CUDA
    tensors launch the Triton kernels."""
    if x.is_cuda:
        return layer_norm_bwd_kernel(x, w, g, eps)
    return ln_bwd_plain(x, w, g, eps)


#: backward kernel calls since the last reset, two Triton launches each
#: (the plain version never counts)
layer_norm_bwd.launches = 0


def _layer_norm_fwd(x, w, b, eps):
    if x.is_cuda:
        return layer_norm_kernel(x, w, b, eps)
    return ln_plain(x, w, b, eps)


class LayerNormFunction(torch.autograd.Function):
    """``layer_norm_fused``'s custom_vjp: the forward saves only
    ``(x, w, b)``; the backward recomputes the statistics from ``x``
    and returns ``dw``/``db`` in the parameters' dtypes (l.148)."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w, b)
        return _layer_norm_fwd(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw, db.to(b.dtype), None


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm over the last axis with scale ``w`` and bias ``b``,
    differentiable in all three. CPU tensors take the plain versions;
    CUDA tensors launch the Triton kernels."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return LayerNormFunction.apply(x, w, b, eps)
    return _layer_norm_fwd(x, w, b, eps)


#: forward kernel launches since the last reset (the plain version never
#: counts)
layer_norm.launches = 0
