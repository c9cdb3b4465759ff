"""Fused RMSNorm forward — counterpart of ``paddle_tpu/ops/rms_norm.py``.

    inv = rsqrt(mean(x^2, -1) + eps);  y = x * inv * w

with fp32 math whatever the input dtype, and ``y`` in ``x``'s dtype.

Kernel (Triton): replaces the Pallas kernel
``paddle_tpu/ops/rms_norm.py::_fwd_kernel`` (launched by ``_pallas_fwd``).
What bounds it on an H100: memory. Per row it reads ``h`` inputs and
writes ``h`` outputs for about four operations per element, far below
the card's ~295 operations per byte, so the least time is
``(2·rows·h·itemsize + h·itemsize_w) / 3.35 TB/s``. The design does
the one thing that matters for that: a single pass. One program owns
one row, holds it in registers (``BLOCK_H`` = next power of two >= h),
reduces the sum of squares there and writes the scaled row, so every
byte crosses device memory exactly once. A row reduction followed by an
elementwise scale is exactly Triton's block model; it needs no tensor
cores, no shared-memory staging and no asynchronous copies, which is
why this kernel is Triton rather than CUDA C++. The TPU kernel's row
blocking (``_pick_block_rows``, a VMEM budget) has no counterpart: the
grid is one program per row and the card schedules them.

Backward (Triton): replaces ``paddle_tpu/ops/rms_norm.py::_bwd_kernel``
(launched by ``_pallas_bwd``), with ``inv`` recomputed from ``x`` as
there:

    dx = inv·(w·g) − x·inv³/h·Σ(w·g·x);   dw = Σ_rows g·x·inv

Memory bounds it too: per row it reads ``x`` and ``g`` and writes
``dx`` for about ten operations per element, so the least time is
``3·rows·h·itemsize / 3.35 TB/s``. One program owns a block of rows; it
writes each row's ``dx`` in one pass and keeps the block's partial
``Σ g·x·inv`` in fp32 registers, stored once into an ``(n_blocks, h)``
buffer. A second small pass sums the blocks into ``dw``. The Pallas
kernel carries ``dw`` across its sequential grid instead; blocks on the
card run in no order, and the two-pass sum needs no atomics, so ``dw``
is the same bits from run to run.

:func:`rms_norm` is differentiable: with autograd recording, it runs
through :class:`RMSNormFunction` (the ``rms_norm_array`` custom_vjp),
which saves only ``(x, w)``; under ``no_grad`` it is the forward alone.
"""

from __future__ import annotations

import torch

from ..core.dispatch import any_tensor, apply
from ._common import (_exporting, check_cuda_tensor, count_launches,
                      triton_cache_dir)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm_plain(x, w, eps: float = 1e-6):
    """Plain PyTorch version (``_rms_norm_ref``): fp32 math, ``w`` cast
    to fp32, output in ``x.dtype``."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)


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
        def _rms_norm_fwd(x_ptr, w_ptr, y_ptr, h, eps,
                          BLOCK_H: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            offs = tl.arange(0, BLOCK_H)
            mask = offs < h
            x = tl.load(x_ptr + row * h + offs, mask=mask,
                        other=0.0).to(tl.float32)
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            inv = tl.rsqrt(tl.sum(x * x, axis=0) / h + eps)
            y = x * inv * w
            tl.store(y_ptr + row * h + offs,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        @triton.jit
        def _rms_norm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, rows, h,
                          rows_per_block, eps, BLOCK_H: tl.constexpr):
            blk = tl.program_id(0)
            offs = tl.arange(0, BLOCK_H)
            mask = offs < h
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc = tl.zeros([BLOCK_H], dtype=tl.float32)
            row0 = blk.to(tl.int64) * rows_per_block
            for r in range(0, rows_per_block):
                row = row0 + r
                # rows past the end load zeros: their dx is not stored and
                # they add 0 to the partial sum
                m = mask & (row < rows)
                x = tl.load(x_ptr + row * h + offs, mask=m,
                            other=0.0).to(tl.float32)
                g = tl.load(g_ptr + row * h + offs, mask=m,
                            other=0.0).to(tl.float32)
                inv = tl.rsqrt(tl.sum(x * x, axis=0) / h + eps)
                wg = w * g
                dot = tl.sum(wg * x, axis=0)
                dx = inv * wg - x * (inv * inv * inv) * (dot / h)
                tl.store(dx_ptr + row * h + offs,
                         dx.to(dx_ptr.dtype.element_ty), mask=m)
                acc += g * x * inv
            tl.store(part_ptr + blk.to(tl.int64) * h + offs, acc, mask=mask)

        @triton.jit
        def _rms_norm_dw(part_ptr, dw_ptr, n_blocks, h,
                         BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < h
            acc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for p0 in range(0, n_blocks, BLOCK_P):
                prow = p0 + tl.arange(0, BLOCK_P)
                m = (prow[:, None] < n_blocks) & cmask[None, :]
                part = tl.load(part_ptr + prow[:, None] * h + cols[None, :],
                               mask=m, other=0.0)
                acc += tl.sum(part, axis=0)
            tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty),
                     mask=cmask)

        _triton_kernels = (triton, _rms_norm_fwd, _rms_norm_bwd,
                           _rms_norm_dw)
    return _triton_kernels


def _num_warps(block_h: int) -> int:
    return max(1, min(16, block_h // 512))


def _check_pair(x, w):
    check_cuda_tensor("x", x, _KERNEL_DTYPES)
    check_cuda_tensor("w", w, _KERNEL_DTYPES, ndim=1)
    if w.shape[0] != x.shape[-1]:
        raise ValueError(f"w has {w.shape[0]} entries for rows of "
                         f"{x.shape[-1]}")
    if w.device != x.device:
        raise ValueError("x and w must be on the same device")


def rms_norm_kernel(x, w, eps: float = 1e-6):
    """Launch the Triton kernel on CUDA tensors. ``x`` is (..., h),
    contiguous; ``w`` is (h,). Counts one launch in ``rms_norm.launches``."""
    _check_pair(x, w)
    h = x.shape[-1]
    rows = x.numel() // h
    y = torch.empty_like(x)
    if rows == 0:
        return y
    triton, kernel = _get_kernels()[:2]
    block_h = triton.next_power_of_2(h)
    # Triton launches on torch's current stream and raises if the
    # driver refuses the launch
    kernel[(rows,)](x, w, y, h, float(eps), BLOCK_H=block_h,
                    num_warps=_num_warps(block_h))
    rms_norm.launches += 1
    return y


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def rms_norm_bwd_plain(x, w, g, eps: float = 1e-6):
    """Plain PyTorch version of the backward (``_rms_bwd``'s XLA path):
    ``inv`` recomputed from ``x``, fp32 math, ``dx`` in ``x.dtype`` and
    ``dw`` (summed over every leading axis) in ``w.dtype``."""
    h = x.shape[-1]
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    wg = wf * gf
    dot = (wg * xf).sum(dim=-1, keepdim=True)
    dx = (inv * wg - xf * (inv ** 3) * (dot / h)).to(x.dtype)
    dw = (gf * xf * inv).reshape(-1, h).sum(dim=0).to(w.dtype)
    return dx, dw


#: a backward program walks this many blocks' worth of rows at most; the
#: row count per block follows from it (one block per SM or a few)
_BWD_MAX_BLOCKS = 512


def rms_norm_bwd_kernel(x, w, g, eps: float = 1e-6):
    """Launch the Triton backward on CUDA tensors: ``x`` and ``g`` are
    (..., h) in one dtype, contiguous; ``w`` is (h,). Returns
    ``(dx, dw)``. Each call launches two Triton programs (dx with the
    partial sums, then the ``dw`` sum) and counts ONE in
    ``rms_norm_bwd.launches``: the counter counts calls of the backward,
    as the one Pallas kernel it replaces is one call."""
    _check_pair(x, w)
    check_cuda_tensor("g", g, (x.dtype,))
    if g.shape != x.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, x "
                         f"{tuple(x.shape)}")
    h = x.shape[-1]
    rows = x.numel() // h
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if rows == 0:
        return dx, dw.zero_()
    triton, _, bwd, dw_sum = _get_kernels()
    block_h = triton.next_power_of_2(h)
    rows_per_block = -(-rows // _BWD_MAX_BLOCKS)
    n_blocks = -(-rows // rows_per_block)
    part = torch.empty((n_blocks, h), dtype=torch.float32, device=x.device)
    bwd[(n_blocks,)](x, w, g, dx, part, rows, h, rows_per_block,
                     float(eps), BLOCK_H=block_h,
                     num_warps=_num_warps(block_h))
    block_c = 128
    dw_sum[(triton.cdiv(h, block_c),)](part, dw, n_blocks, h, BLOCK_P=32,
                                       BLOCK_C=block_c, num_warps=4)
    rms_norm_bwd.launches += 1
    return dx, dw


def rms_norm_bwd(x, w, g, eps: float = 1e-6):
    """RMSNorm backward. CPU tensors take the plain version; CUDA
    tensors launch the Triton kernels."""
    if x.is_cuda:
        return rms_norm_bwd_kernel(x, w, g, eps)
    return rms_norm_bwd_plain(x, w, g, eps)


#: backward kernel calls since the last reset, two Triton launches each
#: (the plain version never counts)
count_launches(rms_norm_bwd)


class RMSNormFunction(torch.autograd.Function):
    """``rms_norm_array``'s custom_vjp: the forward saves only
    ``(x, w)`` and the backward recomputes ``inv`` from ``x``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _rms_norm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw, None


@torch.library.custom_op("paddle_tpu_torch::rms_norm", mutates_args=())
def rms_norm_op(x: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Row 1 as a custom op, the form an exported program (``jit.save``)
    holds: the plain version on the CPU, the kernel on CUDA tensors
    (counted in ``rms_norm.launches``)."""
    return rms_norm_plain(x, w, eps)


@rms_norm_op.register_kernel("cuda")
def _rms_norm_op_cuda(x, w, eps):
    return rms_norm_kernel(x.contiguous(), w, eps)


@rms_norm_op.register_fake
def _rms_norm_op_fake(x, w, eps):
    return torch.empty_like(x)


def _rms_norm_fwd(x, w, eps):
    if _exporting[0]:
        return rms_norm_op(x, w, eps)
    if x.is_cuda:
        return rms_norm_kernel(x, w, eps)
    return rms_norm_plain(x, w, eps)


def rms_norm(x, weight, epsilon: float = 1e-6):
    """RMSNorm over the last axis, differentiable in ``x`` and
    ``weight``. CPU tensors take the plain versions; CUDA tensors launch
    the Triton kernels. Under ``no_grad`` (serving) it is one forward
    launch. ``Tensor``s go through the dispatcher as op ``rms_norm``
    (the reference's Tensor-level entry, l.186-189)."""
    if any_tensor(x, weight):
        return apply(lambda xv, wv: rms_norm(xv, wv, epsilon), x, weight,
                     op_name="rms_norm")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, epsilon)
    return _rms_norm_fwd(x, weight, epsilon)


#: kernel launches since the last reset (the plain version never counts)
count_launches(rms_norm)
