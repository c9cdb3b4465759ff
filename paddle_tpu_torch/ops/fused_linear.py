"""Weight-gradient GEMM with in-place accumulation — counterpart of
``paddle_tpu/ops/fused_linear.py`` (``fused_linear_param_grad_add`` and
``linear_with_main_grad``).

``acc += xᵀ·dout``, summed in fp32 into the accumulator: fp32
``main_grad`` when ``multi_precision``, else one of x's dtype (the
product is then rounded to that dtype before the add, as the JAX
package's XLA path does). CPU tensors take
:func:`fused_linear_param_grad_add_plain`; CUDA tensors launch a
hand-written kernel of ``csrc/fused_linear_grad_add.cu`` for every shape
(the Pallas kernel's ``_pallas_ok`` sends shapes that do not tile to
XLA; the card has no such fallback), or raise: the wgmma kernel fed by
TMA where :func:`grad_add_route` says TMA can map the operands, the WMMA
kernel for other bf16/fp16 shapes, the FMA kernel for fp32.

In place: the reference's op and the Pallas kernel's alias update
``main_grad`` in place, where the JAX function returns new arrays. The
port updates ``dweight`` (and ``dbias``) in place when it already has
the accumulator's dtype, device, shape and layout, and returns it;
otherwise it converts first (``jnp.asarray``, l.97) and the argument is
left as it was. The CPU plain version keeps the same contract, so a
caller sees the same on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._common import (check_cuda_tensor, count_launches,
                      load_cuda_library)

#: x/dout dtypes of the kernels (their dtype code)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 128                     # out rows and columns per block (WMMA, FMA)
_MAX_GRID_Y = 65535
#: the wgmma route's out tile (rows of dW, columns) and its row slice
_WGMMA_TILE = (128, 256)
_WGMMA_SLICE = 64
#: a split of the rows walks at least this many slices (512 rows)
_MIN_SPLIT_SLICES = 8
#: the kernels' routes, each counted in ``route_launches``
GRAD_ADD_ROUTES = ("wgmma", "wmma", "fma")


def grad_add_route(rows: int, din: int, dout: int, dtype,
                   aligned: bool = True) -> str:
    """The route of one call, from shapes and alignment alone (never a
    fallback on a failed launch): ``"fma"`` for fp32 inputs (no TF32);
    ``"wgmma"`` for bf16/fp16 when TMA can map x and dout (``rows > 0``,
    din and dout multiples of 8, so their rows are 16-byte strides, and
    ``aligned``: x, dout and the accumulator start on 16 bytes); else
    ``"wmma"``."""
    if dtype == torch.float32:
        return "fma"
    if rows > 0 and din % 8 == 0 and dout % 8 == 0 and aligned:
        return "wgmma"
    return "wmma"


def grad_add_split(rows: int, din: int, dout: int, sms: int) -> int:
    """How many parts the wgmma route splits the rows into: 1 unless its
    output tiles fill less than one wave of ``sms`` SMs; then as many as
    fill the wave, each walking at least ``_MIN_SPLIT_SLICES`` slices of
    64 rows, and never an empty part."""
    tm, tn = _WGMMA_TILE
    tiles = -(-din // tm) * -(-dout // tn)
    slices = -(-rows // _WGMMA_SLICE)
    split = min(sms // tiles, slices // _MIN_SPLIT_SLICES) if tiles < sms \
        else 1
    if split <= 1:
        return 1
    per = -(-slices // split)
    return -(-slices // per)


def _as_acc(t, dtype, shape, device, name):
    """``t`` as the accumulator: itself when it already has ``dtype``,
    ``device``, ``shape`` and a contiguous layout (updated in place),
    else a converted copy."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.to(device=device, dtype=dtype).contiguous()


def fused_linear_param_grad_add_plain(x2, g2, acc, acc_dtype):
    """The kernel's arithmetic in plain PyTorch: ``x2`` (rows, din),
    ``g2`` (rows, dout), ``acc`` (din, dout) in ``acc_dtype`` or
    ``None``. The product is taken in fp32 from the inputs' exact values,
    rounded to ``acc_dtype`` and added (in place into ``acc``).
    Returns the accumulator."""
    prod = (x2.float().t() @ g2.float()).to(acc_dtype)
    if acc is None:
        return prod
    return acc.add_(prod)


def fused_linear_grad_add_kernel(x2, g2, acc, acc_dtype,
                                 route: Optional[str] = None):
    """Launch a CUDA kernel: the contract of
    :func:`fused_linear_param_grad_add_plain` on CUDA tensors. ``acc``
    (contiguous, ``acc_dtype``) is updated in place and returned; with
    ``acc=None`` the output is a fresh ``torch.empty`` the kernel fills.
    The route is :func:`grad_add_route`'s; ``route="wmma"`` takes the
    WMMA kernel for a call the wgmma route would take (for tests).
    Counts one launch in ``fused_linear_grad_add_kernel.launches`` and in
    its route's ``route_launches``."""
    check_cuda_tensor("x", x2, tuple(_KERNEL_DTYPES), ndim=2)
    check_cuda_tensor("dout", g2, (x2.dtype,), ndim=2)
    rows, din = x2.shape
    dout = g2.shape[1]
    if g2.shape[0] != rows:
        raise ValueError(f"x has {rows} rows, dout {g2.shape[0]}")
    if acc_dtype not in (torch.float32, x2.dtype):
        raise TypeError(f"accumulator dtype {acc_dtype}: the kernel takes "
                        f"float32 or x's {x2.dtype}")
    if not din or not dout:
        raise ValueError(f"empty weight gradient ({din}, {dout})")
    if (din + _TILE - 1) // _TILE > _MAX_GRID_Y:
        raise ValueError(f"din {din} exceeds the kernel's grid")
    if x2.device != g2.device:
        raise ValueError("x and dout must be on one device")
    if acc is None:
        out = torch.empty(din, dout, dtype=acc_dtype, device=x2.device)
    else:
        check_cuda_tensor("dweight", acc, (acc_dtype,), ndim=2)
        if tuple(acc.shape) != (din, dout) or acc.device != x2.device:
            raise ValueError(f"dweight {tuple(acc.shape)} on {acc.device} "
                             f"for ({din}, {dout}) on {x2.device}")
        out = acc
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, g2, out))
    chosen = grad_add_route(rows, din, dout, x2.dtype, aligned)
    if route is not None and route != chosen and not (
            route == "wmma" and chosen == "wgmma"):
        raise ValueError(f"route {route!r} cannot take this call "
                         f"({chosen!r} does)")
    route = route or chosen
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    acc_ptr = None if acc is None else acc.data_ptr()
    acc_fp32 = int(acc_dtype == torch.float32)
    if route == "wgmma":
        sms = torch.cuda.get_device_properties(x2.device) \
            .multi_processor_count
        split = grad_add_split(rows, din, dout, sms)
        ws = (torch.empty(split, din, dout, dtype=torch.float32,
                          device=x2.device) if split > 1 else None)
        err = _launch_fns()[1](
            x2.data_ptr(), g2.data_ptr(), acc_ptr, out.data_ptr(),
            None if ws is None else ws.data_ptr(), rows, din, dout,
            _KERNEL_DTYPES[x2.dtype], acc_fp32, split, stream)
    else:
        vec = 16 // x2.element_size()
        err = _launch_fns()[0](
            x2.data_ptr(), g2.data_ptr(), acc_ptr, out.data_ptr(), rows, din,
            dout, _KERNEL_DTYPES[x2.dtype], acc_fp32,
            int(din % vec == 0 and x2.data_ptr() % 16 == 0),
            int(dout % vec == 0 and g2.data_ptr() % 16 == 0), stream)
    if err != 0:
        raise RuntimeError(f"fused_linear_grad_add ({route}) failed: CUDA "
                           f"error {err}")
    fused_linear_grad_add_kernel.launches += 1
    fused_linear_grad_add_kernel.route_launches[route] += 1
    return out


#: op calls on the card since the last reset (the plain version never
#: counts), and the same by route
count_launches(fused_linear_grad_add_kernel, GRAD_ADD_ROUTES)

def grad_add_smem_bytes() -> int:
    """Dynamic shared memory a block of the wgmma route takes (for the
    smoke run's report)."""
    fn = load_cuda_library("fused_linear_grad_add") \
        .fused_linear_grad_add_wgmma_smem_bytes
    fn.restype = ctypes.c_int
    return fn()


_fns = []


def _launch_fns():
    """(WMMA/FMA entry, wgmma entry) of the library."""
    if not _fns:
        lib = load_cuda_library("fused_linear_grad_add")
        fn = lib.fused_linear_grad_add_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        wg = lib.fused_linear_grad_add_wgmma_launch
        wg.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        wg.restype = ctypes.c_int
        _fns.extend([fn, wg])
    return _fns


def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision: bool = True,
                                has_bias: bool = True):
    """Accumulate ``dweight += xᵀ·dout`` (and ``dbias += Σ dout``).

    ``x``: (..., din) activations, ``dout``: (..., dout) output
    gradient. ``dweight``/``dbias`` are the running accumulators (fp32
    when ``multi_precision``, the reference's main_grad); ``None`` means
    start at zero. Returns ``(dweight, dbias)`` (``dbias`` ``None`` when
    ``has_bias=False``); each is the argument itself, updated in place,
    when that already was the accumulator (see the module docstring).
    The bias sum is a plain reduction in both packages."""
    din, d_out = x.shape[-1], dout.shape[-1]
    # o_proj's input is a reshaped attention output: reshape may give a
    # strided view, and the kernel reads contiguous rows
    x2 = x.reshape(-1, din).contiguous()
    g2 = dout.reshape(-1, d_out).contiguous()
    acc_dtype = torch.float32 if multi_precision else x2.dtype
    if dweight is not None:
        dweight = _as_acc(dweight, acc_dtype, (din, d_out), x2.device,
                          "dweight")
    if x2.is_cuda:
        dw = fused_linear_grad_add_kernel(x2, g2, dweight, acc_dtype)
    else:
        dw = fused_linear_param_grad_add_plain(x2, g2, dweight, acc_dtype)
    db = None
    if has_bias:
        db = g2.to(acc_dtype).sum(0)
        if dbias is not None:
            db = _as_acc(dbias, acc_dtype, (d_out,), x2.device,
                         "dbias").add_(db)
    return dw, db


class LinearWithMainGrad(torch.autograd.Function):
    """``_linear_mg``'s custom_vjp: the forward is ``x @ w (+ b)`` (a
    plain product, as the JAX package leaves it to XLA); the backward is
    ``dx = (g @ wᵀ)`` in x's dtype and ``dw, db`` from
    :func:`fused_linear_param_grad_add` (fp32), ``dw`` cast to w's
    dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        y = x @ w
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = (g @ w.t().to(g.dtype)).to(x.dtype)
        dw, db = fused_linear_param_grad_add(x, g, has_bias=ctx.has_bias)
        return dx, dw.to(w.dtype), db


def linear_with_main_grad(x, w, b=None):
    """Linear whose backward routes dW (and db) through
    :func:`fused_linear_param_grad_add`: one fp32-accumulating product,
    the reference's main_grad discipline."""
    return LinearWithMainGrad.apply(x, w, b)
