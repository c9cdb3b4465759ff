"""Weight-only quantization for serving — counterpart of
``paddle_tpu/quantization/__init__.py``.

Symmetric per-output-channel scales: int8 holds values in [-127, 127];
``weight_only_int4`` holds [-7, 7] with two nibbles packed in a byte
along the input dim (row 2i in the low nibble, row 2i+1 in the high
one). The quantized bytes are the reference's bit for bit: the same
fp32 division, round-half-to-even and clip, and the int4 packing written
as the reference's int8 shift and OR (``(q & 0x0F) << 4`` wraps in int8
exactly as it does there). ``weight_dequantize`` returns fp32.

The reference leaves the dequantize multiply and the product to XLA,
outside any Pallas kernel, so they are plain PyTorch here on either
device. A stacked ``{"q", "scale"}`` leaf (:func:`quantize_stacked_params`)
is what the Llama serving paths take (``models/llama.py::_dense`` and
``_mm_prefill``).

A ``device=`` keyword (the port's, keyword-only) places a host array;
a torch tensor or a ``Tensor`` keeps its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import any_tensor, apply
from ..core.tensor import Tensor
from ..nn import initializer as I
from ..nn.layer import Layer, LayerParameter
from ..ops._common import resolve_device, true_div


def _value(w, device=None) -> torch.Tensor:
    """``w`` as a torch tensor: a ``Tensor``'s value, a torch tensor
    itself, a host array on ``device`` (the card unless asked)."""
    if isinstance(w, Tensor):
        return w._value
    if isinstance(w, torch.Tensor):
        return w
    a = np.asarray(w)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=resolve_device(device))


def weight_quantize(w, algo: str = "weight_only_int8", *, device=None):
    """w: (in, out) float -> (quantized weights, per-out-channel scales)
    (l.29-52). int8: values in [-127, 127]; int4: [-7, 7] packed two to
    a byte along the input dim."""
    wf = _value(w, device).detach().float()
    amax = wf.abs().amax(dim=0)                             # (out,)
    one = torch.ones((), dtype=torch.float32, device=wf.device)
    if algo == "weight_only_int8":
        scale = torch.where(amax > 0, true_div(amax, 127.0), one)
        q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127) \
            .to(torch.int8)
        return q, scale
    if algo == "weight_only_int4":
        scale = torch.where(amax > 0, true_div(amax, 7.0), one)
        q = torch.clamp(torch.round(wf / scale[None, :]), -7, 7) \
            .to(torch.int8)
        if q.shape[0] % 2:
            raise ValueError("int4 packing needs an even input dim")
        lo = q[0::2] & 0x0F
        hi = (q[1::2] & 0x0F) << 4
        return (lo | hi).to(torch.int8), scale
    raise ValueError(f"unknown algo {algo!r}")


def weight_dequantize(q, scale, algo: str = "weight_only_int8"):
    """Inverse of :func:`weight_quantize`, in fp32 (l.55-77). Stacked
    layouts too: q (..., in, out) with scale (..., out)."""
    q, scale = _value(q), _value(scale)
    if algo == "weight_only_int8":
        return q.float() * scale[..., None, :]
    if algo == "weight_only_int4":
        u = q.view(torch.uint8)
        lo = (u & 0x0F).to(torch.int8)
        hi = ((u >> 4) & 0x0F).to(torch.int8)
        # sign-extend the 4-bit two's complement
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = torch.where(hi > 7, hi - 16, hi)
        # the packed axis is the input dim (-2): row 2i came from lo[i],
        # row 2i+1 from hi[i]
        full = torch.stack([lo, hi], dim=-2)
        full = full.reshape(q.shape[:-2] + (2 * q.shape[-2], q.shape[-1]))
        return full.float() * scale[..., None, :]
    raise ValueError(f"unknown algo {algo!r}")


_ALGOS = {"int8": "weight_only_int8", "weight_only_int8": "weight_only_int8",
          "int4": "weight_only_int4", "weight_only_int4": "weight_only_int4"}


def weight_only_linear(x, weight, weight_scale, bias=None,
                       weight_dtype: str = "int8"):
    """``x @ dequant(w) + b`` in fp32, the result in x's dtype (l.84-101).
    Tensors go through the dispatcher under the reference's op name;
    torch tensors run directly."""
    if weight_dtype not in _ALGOS:
        raise ValueError(f"unknown weight_dtype {weight_dtype!r}; "
                         f"expected one of {sorted(_ALGOS)}")
    algo = _ALGOS[weight_dtype]

    def fn(xv, qv, sv, *rest):
        w = weight_dequantize(qv, sv, algo)
        y = xv.float() @ w
        if rest:
            y = y + rest[0]
        return y.to(xv.dtype)

    args = [x, weight, weight_scale] + ([bias] if bias is not None else [])
    if any_tensor(*args):
        return apply(fn, *args, op_name="weight_only_linear")
    return fn(*args)


def _frozen(value: torch.Tensor) -> LayerParameter:
    """A parameter that is never trained (the reference's
    ``trainable = False`` and ``stop_gradient = True``)."""
    p = LayerParameter(value, requires_grad=False)
    p.trainable = False
    p.stop_gradient = True
    return p


class WeightOnlyLinear(Layer):
    """A Linear whose weight is stored int8 or int4-packed, with fp32
    per-out-channel scales (l.104-150). Build one from a float layer
    with :meth:`from_linear`."""

    def __init__(self, in_features, out_features, weight_dtype: str = "int8",
                 has_bias: bool = True):
        super().__init__()
        if weight_dtype not in _ALGOS:
            raise ValueError(f"unknown weight_dtype {weight_dtype!r}")
        if _ALGOS[weight_dtype] == "weight_only_int4" and in_features % 2:
            raise ValueError("int4 packing needs an even in_features")
        self.weight_dtype = weight_dtype
        store_rows = (in_features if _ALGOS[weight_dtype] == "weight_only_int8"
                      else in_features // 2)
        scale = self.create_parameter((out_features,),
                                      default_initializer=I.Constant(1.0))
        dev = scale.device
        self.weight = _frozen(torch.zeros((store_rows, out_features),
                                          dtype=torch.int8, device=dev))
        self.weight_scale = _frozen(scale.detach())
        self.bias = (self.create_parameter((out_features,), is_bias=True)
                     if has_bias else None)

    @classmethod
    def from_linear(cls, linear, weight_dtype: str = "int8"):
        w = _value(linear.weight)
        qcls = cls(int(w.shape[0]), int(w.shape[1]),
                   weight_dtype=weight_dtype,
                   has_bias=linear.bias is not None)
        q, s = weight_quantize(w, _ALGOS[weight_dtype])
        with torch.no_grad():
            qcls.weight.copy_(q)
            qcls.weight_scale.copy_(s)
            if linear.bias is not None:
                qcls.bias.copy_(_value(linear.bias))
        return qcls

    def forward(self, x):
        return weight_only_linear(x, self.weight, self.weight_scale,
                                  self.bias, self.weight_dtype)


def quantize_stacked_params(params: dict, keys=None,
                            algo: str = "weight_only_int8") -> dict:
    """Quantize a stacked-param dict (``models/llama`` layout; l.153-178):
    each selected (L, in, out) weight becomes ``{"q": int8 (L, in, out),
    "scale": fp32 (L, out)}``, a 2-D one ``{"q", "scale"}`` of its own
    shape. Other entries are the same objects. On the card ``q`` is
    column-major in its last two dims
    (``ops.fused_transformer_block.col_major``)."""
    if algo != "weight_only_int8":
        raise ValueError(
            "stacked-param quantization supports weight_only_int8 (int4's "
            "nibble packing changes the contraction-dim shape the layer "
            "einsums expect)")
    from ..ops.fused_transformer_block import col_major
    keys = keys or ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "lm_head")
    out = dict(params)
    for k in keys:
        if k not in params:
            continue
        w = params[k]
        if w.ndim == 3:
            qs = [weight_quantize(w[i], algo) for i in range(w.shape[0])]
            q = torch.stack([q for q, _ in qs])
            s = torch.stack([s for _, s in qs])
        else:
            q, s = weight_quantize(w, algo)
        # on the card the int8 weights are laid out column-major, the
        # layout its int8 GEMM takes (the values and shape are the same)
        out[k] = {"q": col_major(q) if q.is_cuda else q, "scale": s}
    return out


from .qat import (  # noqa: E402,F401
    QAT, PTQ, QuantConfig, FakeQuanterWithAbsMax, AbsmaxObserver,
    QuantedLinear, quanted_layers,
)
