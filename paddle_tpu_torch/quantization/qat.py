"""Quantization-aware training and post-training quantization —
counterpart of ``paddle_tpu/quantization/qat.py``.

- Fake quantization is the straight-through estimator written as
  ``x + (q(x) - x).detach()``: the forward sees the int grid, the
  backward is the identity.
- An activation quanter keeps a moving-average abs-max (an observer,
  the running max) in an fp32 buffer, written in place on every forward:
  eagerly, and inside a compiled step (``jit.TrainStep``'s CUDA graph
  replays the write), as BatchNorm's running statistics are.
- ``convert`` swaps each quantized Linear for the int8 serving layer
  (:class:`~paddle_tpu_torch.quantization.WeightOnlyLinear`).

The layers take ``Tensor``s (through the dispatcher, under the
reference's op names) or torch tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import torch

from ..nn import Linear
from ..nn import functional as F
from ..nn.layer import Layer, layer_device
from ..ops._common import true_div
from . import WeightOnlyLinear

__all__ = [
    "QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMax",
    "AbsmaxObserver", "QuantedLinear", "quanted_layers",
]


def _fake_quant(x, scale, bits: int = 8):
    """STE fake quant (l.35-41): the forward rounds onto the int grid,
    the backward is the identity."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(scale, min=1e-9)
    q = torch.clamp(torch.round(x / s), -qmax, qmax) * s
    return x + (q - x).detach()


def _scalar_buffer(layer: Layer, name: str) -> None:
    layer.register_buffer(name, torch.zeros((), dtype=torch.float32,
                                            device=layer_device()))


class FakeQuanterWithAbsMax(Layer):
    """Activation fake-quanter with a moving-average abs-max scale
    (l.44-68): the first forward takes the batch's abs-max, later ones
    ``rate · prev + (1 − rate) · amax``."""

    def __init__(self, moving_rate: float = 0.9, bits: int = 8):
        super().__init__()
        self.moving_rate = moving_rate
        self.bits = bits
        _scalar_buffer(self, "scale")

    def forward(self, x):
        qmax = float(2 ** (self.bits - 1) - 1)

        def fn(v):
            amax = v.detach().float().abs().amax()
            prev = self.scale
            new = torch.where(prev == 0.0, amax,
                              self.moving_rate * prev
                              + (1 - self.moving_rate) * amax)
            with torch.no_grad():
                self.scale.copy_(new)
            return _fake_quant(v, true_div(new, qmax), self.bits)

        return F._run(fn, x, op_name="fake_quant_abs_max")


class AbsmaxObserver(Layer):
    """PTQ calibration observer: the largest abs value seen (l.71-89)."""

    def __init__(self, bits: int = 8):
        super().__init__()
        self.bits = bits
        _scalar_buffer(self, "amax")

    def forward(self, x):
        def fn(v):
            with torch.no_grad():
                torch.maximum(self.amax, v.detach().float().abs().amax(),
                              out=self.amax)
            return v

        return F._run(fn, x, op_name="abs_max_observer")

    @property
    def scale(self) -> float:
        return float(self.amax) / float(2 ** (self.bits - 1) - 1)


class QuantedLinear(Layer):
    """A Linear with fake-quantized weights (per-out-channel abs-max) and
    an activation quanter or observer in front (l.92-119)."""

    def __init__(self, inner: Linear, activation_quanter: Optional[Layer],
                 weight_bits: int = 8):
        super().__init__()
        self.inner = inner
        self.activation_quanter = activation_quanter
        self.weight_bits = weight_bits

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.inner.weight
        qmax = float(2 ** (self.weight_bits - 1) - 1)
        scale = torch.clamp(true_div(w.detach().float().abs().amax(dim=0),
                                     qmax), min=1e-9)
        # one STE sandwich, its gradient reaching the original weight
        wq = w + (_fake_quant(w.detach(), scale[None, :], self.weight_bits)
                  - w.detach())
        return F.linear(x, wq, self.inner.bias)


class QuantConfig:
    """Maps layer types and names to quanters (l.122-167). ``weight`` is
    the weight fake-quant's bit width: an int, or a quanter or factory
    with a ``bits`` attribute; anything else raises."""

    def __init__(self, activation=None, weight=None):
        self._default_act = activation
        self._default_wbits = _weight_bits(weight)
        self._type_cfg: Dict[Type, dict] = {}
        self._name_cfg: Dict[str, dict] = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type_cfg[t] = {"activation": activation,
                                 "weight_bits": _weight_bits(weight)}
        return self

    def add_name_config(self, names, activation=None, weight=None):
        for n in (names if isinstance(names, (list, tuple)) else [names]):
            self._name_cfg[n] = {"activation": activation,
                                 "weight_bits": _weight_bits(weight)}
        return self

    def _lookup(self, name: str, layer) -> Optional[dict]:
        if name in self._name_cfg:
            return self._name_cfg[name]
        for t, cfg in self._type_cfg.items():
            if isinstance(layer, t):
                return cfg
        if self._default_act is not None and isinstance(layer, Linear):
            return {"activation": self._default_act,
                    "weight_bits": self._default_wbits}
        return None


def _weight_bits(weight) -> int:
    """A weight-quanter config as a bit width; None is the default 8."""
    if weight is None:
        return 8
    if isinstance(weight, int):
        return weight
    bits = getattr(weight, "bits", None)
    if bits is None and callable(weight):
        bits = getattr(weight(), "bits", None)
    if isinstance(bits, int):
        return bits
    raise ValueError(
        "unsupported weight quanter config: pass an int bit width or an "
        "object/factory with a `bits` attribute (the weight scheme is "
        "per-out-channel abs-max, the serving layout)")


def quanted_layers(model: Layer):
    """Every ``QuantedLinear`` under ``model``, with its name."""
    return [(n, sub) for n, sub in model.named_sublayers()
            if isinstance(sub, QuantedLinear)]


def _swap_sublayer(model: Layer, dotted: str, new: Layer):
    parts = dotted.split(".")
    parent = model
    for p in parts[:-1]:
        parent = getattr(parent, p)
    parent._modules[parts[-1]] = new


class QAT:
    """Quantization-aware training (l.204-242): ``quantize`` swaps the
    configured Linears for ``QuantedLinear``; ``convert`` lowers them to
    the int8 serving layer."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model: Layer, inplace: bool = True) -> Layer:
        if not inplace:
            raise NotImplementedError(
                "deep-copying Layers is not supported; use inplace=True")
        for name, sub in list(model.named_sublayers()):
            if not isinstance(sub, Linear):
                continue
            cfg = self.config._lookup(name, sub)
            if cfg is None:
                continue
            act_q = None
            maker = cfg.get("activation")
            if maker is not None:
                act_q = maker() if callable(maker) else maker
            _swap_sublayer(model, name, QuantedLinear(
                sub, act_q, weight_bits=cfg.get("weight_bits", 8)))
        return model

    def convert(self, model: Layer, inplace: bool = True) -> Layer:
        """Every ``QuantedLinear`` becomes a ``WeightOnlyLinear`` (its
        weights quantized once)."""
        if not inplace:
            raise NotImplementedError("use inplace=True")
        for name, sub in quanted_layers(model):
            _swap_sublayer(model, name, WeightOnlyLinear.from_linear(sub.inner))
        return model


class PTQ:
    """Post-training quantization (l.245-270): observers in front of the
    Linears, calibration batches, then ``convert``. The calibrated
    activation scales are set on each converted layer as ``act_scale``
    and returned by :meth:`activation_scales`."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig(activation=AbsmaxObserver)

    def quantize(self, model: Layer, inplace: bool = True) -> Layer:
        cfg = QuantConfig(activation=self.config._default_act
                          or AbsmaxObserver)
        cfg._type_cfg = self.config._type_cfg
        cfg._name_cfg = self.config._name_cfg
        return QAT(cfg).quantize(model, inplace=inplace)

    def activation_scales(self, model: Layer) -> Dict[str, float]:
        """name -> calibrated activation scale of every observed
        ``QuantedLinear``."""
        out = {}
        for name, sub in quanted_layers(model):
            obs = sub.activation_quanter
            if isinstance(obs, AbsmaxObserver):
                out[name] = obs.scale
        return out

    def convert(self, model: Layer, inplace: bool = True) -> Layer:
        if not inplace:
            raise NotImplementedError("use inplace=True")
        scales = self.activation_scales(model)
        for name, sub in quanted_layers(model):
            wol = WeightOnlyLinear.from_linear(sub.inner)
            if name in scales:
                wol.act_scale = scales[name]
            _swap_sublayer(model, name, wol)
        return model
