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

The backward (``_bwd_kernel``/``_rms_bwd``) and its autograd wiring come
with the training slice.
"""

from __future__ import annotations

import torch

from ._common import check_cuda_tensor, triton_cache_dir

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm_plain(x, w, eps: float = 1e-6):
    """Plain PyTorch version (``_rms_norm_ref``): fp32 math, ``w`` cast
    to fp32, output in ``x.dtype``."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)


_triton_kernel = None


def _get_kernel():
    """The ``@triton.jit`` kernel, defined on first launch so that the
    module imports where Triton is not installed."""
    global _triton_kernel
    if _triton_kernel is None:
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

        _triton_kernel = (triton, _rms_norm_fwd)
    return _triton_kernel


def rms_norm_kernel(x, w, eps: float = 1e-6):
    """Launch the Triton kernel on CUDA tensors. ``x`` is (..., h),
    contiguous; ``w`` is (h,). Counts one launch in ``rms_norm.launches``."""
    check_cuda_tensor("x", x, _KERNEL_DTYPES)
    check_cuda_tensor("w", w, _KERNEL_DTYPES, ndim=1)
    h = x.shape[-1]
    if w.shape[0] != h:
        raise ValueError(f"w has {w.shape[0]} entries for rows of {h}")
    if w.device != x.device:
        raise ValueError("x and w must be on the same device")
    rows = x.numel() // h
    y = torch.empty_like(x)
    if rows == 0:
        return y
    triton, kernel = _get_kernel()
    block_h = triton.next_power_of_2(h)
    num_warps = max(1, min(16, block_h // 512))
    # Triton launches on torch's current stream and raises if the
    # driver refuses the launch
    kernel[(rows,)](x, w, y, h, float(eps), BLOCK_H=block_h,
                    num_warps=num_warps)
    rms_norm.launches += 1
    return y


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm forward over the last axis. CPU tensors take the plain
    version; CUDA tensors launch the Triton kernel."""
    if x.is_cuda:
        return rms_norm_kernel(x, w, eps)
    return rms_norm_plain(x, w, eps)


#: kernel launches since the last reset (the plain version never counts)
rms_norm.launches = 0
