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
- backward: a grid of ``programs`` programs (two per SM), each walking
  tiles of ``rows_per_tile`` rows, every ``programs``-th tile from its
  own, with the next tile's loads issued before the work on this one.
  A tile is laid out ``[K, rows_per_tile, W0]`` (column ``k·W0 + c``,
  ``W0`` = 32 lanes x one 16-byte load), so Triton puts one warp on
  each row (two or more for rows over 1024) and a row's four sums stay
  inside its warp, with no shared memory or barrier. The program
  recomputes mean and ``inv`` from ``x`` (nothing but ``(x, w, b)`` is
  saved, as in the Pallas kernel), writes the tile's ``dx``, keeps
  ``Σ g·xhat`` and ``Σ g`` per row slot in fp32 registers and sums them
  across its warps once, into a ``(programs, 2, h)`` buffer. A second
  small pass sums the programs into ``dw`` and ``db``, column blocks in
  parallel. The Pallas kernel carries ``dw``/``db`` across its
  sequential grid; blocks on the card run in no order, and the two-pass
  sum in a fixed order needs no atomics, so ``dw`` and ``db`` are the
  same bits from run to run. :func:`ln_bwd_config` picks the tile, grid
  and warps from host integers.

A row reduction followed by an elementwise pass is Triton's block model,
which is why these are Triton rather than CUDA C++.

:func:`layer_norm` is differentiable: with autograd recording it runs
through :class:`LayerNormFunction` (``layer_norm_fused``'s custom_vjp);
under ``no_grad`` it is the forward alone. CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ._common import (_exporting, check_cuda_tensor, count_launches, sm_count,
                      triton_cache_dir)
from .rms_norm import _num_warps

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
                            n_tiles, eps, ROWS: tl.constexpr,
                            K: tl.constexpr, W0: tl.constexpr):
            # a tile is [K, ROWS, W0]: column k·W0 + c of row r. With W0 =
            # 32 lanes x one 16-byte load, Triton lays the warps along the
            # rows, so a row's sums (over axes 0 and 2) stay in its warp
            pid = tl.program_id(0)
            col = (tl.arange(0, K)[:, None, None] * W0
                   + tl.arange(0, W0)[None, None, :])
            cmask = col < h
            w = tl.load(w_ptr + col, mask=cmask, other=0.0).to(tl.float32)
            acc_w = tl.zeros([K, ROWS, W0], dtype=tl.float32)
            acc_b = tl.zeros([K, ROWS, W0], dtype=tl.float32)
            rsub = tl.arange(0, ROWS)[None, :, None]
            step = tl.num_programs(0)
            # each tile's loads are issued a tile ahead, before the work on
            # the one before; rows past the end load zeros (no traffic):
            # their dx is not stored and they add 0 to both partial sums
            row_n = pid.to(tl.int64) * ROWS + rsub
            m_n = (row_n < rows) & cmask
            x_n = tl.load(x_ptr + row_n * h + col, mask=m_n, other=0.0)
            g_n = tl.load(g_ptr + row_n * h + col, mask=m_n, other=0.0)
            for tile in range(pid, n_tiles, step):
                m = m_n
                offs = row_n * h + col
                x = x_n.to(tl.float32)
                g = g_n.to(tl.float32)
                row_n = (tile + step).to(tl.int64) * ROWS + rsub
                m_n = (row_n < rows) & cmask
                x_n = tl.load(x_ptr + row_n * h + col, mask=m_n, other=0.0)
                g_n = tl.load(g_ptr + row_n * h + col, mask=m_n, other=0.0)
                mu = tl.sum(tl.sum(x, axis=2), axis=0) / h
                xc = tl.where(cmask, x - mu[None, :, None], 0.0)
                var = tl.sum(tl.sum(xc * xc, axis=2), axis=0) / h
                inv = tl.rsqrt(var + eps)[None, :, None]
                xhat = xc * inv
                wg = w * g
                m1 = tl.sum(tl.sum(wg, axis=2), axis=0) / h
                m2 = tl.sum(tl.sum(wg * xhat, axis=2), axis=0) / h
                dx = inv * (wg - m1[None, :, None] - xhat * m2[None, :, None])
                tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty),
                         mask=m)
                acc_w += g * xhat
                acc_b += g
            # the program's column sums: across its row slots, once
            col2 = (tl.arange(0, K)[:, None] * W0
                    + tl.arange(0, W0)[None, :])
            base = part_ptr + pid.to(tl.int64) * 2 * h
            tl.store(base + col2, tl.sum(acc_w, axis=1), mask=col2 < h)
            tl.store(base + h + col2, tl.sum(acc_b, axis=1), mask=col2 < h)

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


class LnBwdConfig(NamedTuple):
    """The backward's first pass: rows a tile (a power of two), programs
    and their warps."""
    rows_per_tile: int
    programs: int
    num_warps: int


#: a backward tile row's elements a thread holds at most (x and g each):
#: wider rows take several warps
_LN_BWD_PER_THREAD = 32
#: warps (and rows) a backward tile, where a row fits one warp
_LN_BWD_WARPS = 4
#: first-pass programs per SM
_LN_BWD_PROGRAMS_PER_SM = 2
#: the second pass: a program sums 32 columns of dw/db, 128 partial rows
#: a load
_LN_BWD_SUM_ROWS = 128
_LN_BWD_SUM_COLS = 32


def ln_bwd_config(rows: int, h: int, sm_count: int) -> LnBwdConfig:
    """The backward's launch for ``rows`` rows of ``h`` on a card of
    ``sm_count`` SMs, from host integers only. A row takes one warp
    while it fits ``_LN_BWD_PER_THREAD`` elements a lane (h <= 1024),
    more beyond; a tile holds ``_LN_BWD_WARPS`` warps' rows (never more
    rows than there are); ``_LN_BWD_PROGRAMS_PER_SM`` programs per SM,
    never more than there are tiles."""
    block_h = 1 << max(0, h - 1).bit_length()
    row_warps = max(1, block_h // (32 * _LN_BWD_PER_THREAD))
    per_tile = max(1, min(_LN_BWD_WARPS // row_warps,
                          1 << max(0, rows - 1).bit_length()))
    tiles = -(-rows // per_tile)
    programs = max(1, min(tiles, _LN_BWD_PROGRAMS_PER_SM * sm_count))
    return LnBwdConfig(per_tile, programs, per_tile * row_warps)


def layer_norm_bwd_kernel(x, w, g, eps: float = 1e-5,
                          config: Optional[LnBwdConfig] = None):
    """Launch the Triton backward on CUDA tensors: ``x`` and ``g``
    (..., h) of one dtype, contiguous; ``w`` (h,). Returns ``(dx, dw,
    db)``, ``dw``/``db`` in ``w.dtype``. ``config`` forces the launch
    (default :func:`ln_bwd_config`'s). Each call is two Triton launches
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
    cfg = config or ln_bwd_config(rows, h, sm_count(x.device))
    triton, _, bwd, dwdb_sum = _get_kernels()
    part = torch.empty((cfg.programs, 2, h), dtype=torch.float32,
                       device=x.device)
    block_h = triton.next_power_of_2(h)
    w0 = min(block_h, 32 * 16 // x.element_size())
    bwd[(cfg.programs,)](x, w, g, dx, part, rows, h,
                         -(-rows // cfg.rows_per_tile), float(eps),
                         ROWS=cfg.rows_per_tile, K=block_h // w0, W0=w0,
                         num_warps=cfg.num_warps)
    dwdb_sum[(triton.cdiv(2 * h, _LN_BWD_SUM_COLS),)](
        part, dwdb, cfg.programs, 2 * h, BLOCK_P=_LN_BWD_SUM_ROWS,
        BLOCK_C=_LN_BWD_SUM_COLS, num_warps=4)
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
count_launches(layer_norm_bwd)


@torch.library.custom_op("paddle_tpu_torch::layer_norm", mutates_args=())
def layer_norm_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Row 8's forward as a custom op, the form an exported program
    (``jit.save``) holds: the plain version on the CPU, the kernel on
    CUDA tensors (counted in ``layer_norm.launches``)."""
    return ln_plain(x, w, b, eps)


@layer_norm_op.register_kernel("cuda")
def _layer_norm_op_cuda(x, w, b, eps):
    return layer_norm_kernel(x.contiguous(), w, b, eps)


@layer_norm_op.register_fake
def _layer_norm_op_fake(x, w, b, eps):
    return torch.empty_like(x)


def _layer_norm_fwd(x, w, b, eps):
    if _exporting[0]:
        return layer_norm_op(x, w, b, eps)
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
count_launches(layer_norm)

#: the reference's name (``layer_norm_fused(x, w, b, eps)``, l.120); one
#: function, one counter
layer_norm_fused = layer_norm
