"""``paddle.fft`` — counterpart of ``paddle_tpu/fft.py``.

The transforms are ``torch.fft``'s (pocketfft on the host, cuFFT on the
card), as the reference leaves them to XLA's FFT, each through the
dispatcher under ``jnp.fft``'s op name; gradients flow through torch's
autograd. Outputs hold their values (no lazy conjugate view).
"""

from __future__ import annotations

import torch

from .core.dispatch import apply
from .core.tensor import Tensor


def _norm(norm):
    if norm in (None, "backward", "forward", "ortho"):
        return norm or "backward"
    raise ValueError(f"invalid norm {norm!r}")


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _wrap1(tfn, op_name):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return apply(lambda v: tfn(v, n=n, dim=axis,
                                   norm=_norm(norm)).resolve_conj(),
                     _t(x), op_name=op_name)
    op.__name__ = op.__qualname__ = op_name
    return op


def _wrap2(tfn, op_name):
    def op(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return apply(lambda v: tfn(v, s=s, dim=tuple(axes),
                                   norm=_norm(norm)).resolve_conj(),
                     _t(x), op_name=op_name)
    op.__name__ = op.__qualname__ = op_name
    return op


def _wrapn(tfn, op_name):
    def op(x, s=None, axes=None, norm="backward", name=None):
        return apply(lambda v: tfn(v, s=s,
                                   dim=None if axes is None else tuple(axes),
                                   norm=_norm(norm)).resolve_conj(),
                     _t(x), op_name=op_name)
    op.__name__ = op.__qualname__ = op_name
    return op


fft = _wrap1(torch.fft.fft, "fft")
ifft = _wrap1(torch.fft.ifft, "ifft")
rfft = _wrap1(torch.fft.rfft, "rfft")
irfft = _wrap1(torch.fft.irfft, "irfft")
hfft = _wrap1(torch.fft.hfft, "hfft")
ihfft = _wrap1(torch.fft.ihfft, "ihfft")

fft2 = _wrap2(torch.fft.fft2, "fft2")
ifft2 = _wrap2(torch.fft.ifft2, "ifft2")
rfft2 = _wrap2(torch.fft.rfft2, "rfft2")
irfft2 = _wrap2(torch.fft.irfft2, "irfft2")

fftn = _wrapn(torch.fft.fftn, "fftn")
ifftn = _wrapn(torch.fft.ifftn, "ifftn")
rfftn = _wrapn(torch.fft.rfftn, "rfftn")
irfftn = _wrapn(torch.fft.irfftn, "irfftn")


def _place():
    from .core.place import current_place
    return current_place().torch_device()


def fftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor(torch.fft.fftfreq(n, d=d, device=_place()))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor(torch.fft.rfftfreq(n, d=d, device=_place()))


def fftshift(x, axes=None, name=None):
    return apply(lambda v: torch.fft.fftshift(
        v, dim=None if axes is None else tuple(axes)), _t(x),
        op_name="fftshift")


def ifftshift(x, axes=None, name=None):
    return apply(lambda v: torch.fft.ifftshift(
        v, dim=None if axes is None else tuple(axes)), _t(x),
        op_name="ifftshift")
