"""``Linear``, ``LayerNorm``, ``RMSNorm`` and ``ReLU`` of
``paddle_tpu/nn/common_layers.py``, on the :class:`~.layer.Layer` base,
with the reference's parameter names, its ``(in, out)`` weight layout
(``y = x @ W + b``) and its initialisers (:mod:`.initializer`).

As in the reference, a layer's weights are initialised when it is built
(from torch's default generator; ``models.ernie.init`` redraws a whole
model from a seeded one), on ``device``: ``None`` means the current
place, the card unless ``set_device`` says otherwise, and raises without
one (:func:`.layer.layer_device`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import Layer, layer_device, param_attr, to_tensor


def _maybe(make: bool, shape, kw):
    return nn.Parameter(torch.empty(shape, **kw)) if make else None


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=layer_device(device))
        self.weight = _maybe(param_attr(weight_attr, "Linear"),
                             (in_features, out_features), kw)
        self.bias = _maybe(param_attr(bias_attr, "Linear"),
                           (out_features,), kw)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.xavier_uniform_(self.weight, gen)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self._shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                       else tuple(normalized_shape))
        self._epsilon = epsilon
        kw = dict(dtype=dtype, device=layer_device(device))
        self.weight = _maybe(param_attr(weight_attr, "LayerNorm"),
                             self._shape, kw)
        self.bias = _maybe(param_attr(bias_attr, "LayerNorm"),
                           self._shape, kw)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.constant_(self.weight, 1.0)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.layer_norm(x, self._shape, self.weight, self.bias,
                            self._epsilon)


class RMSNorm(Layer):
    """Llama's RMSNorm (l.236): a scale initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, dtype=torch.float32, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = _maybe(param_attr(weight_attr, "RMSNorm"),
                             (hidden_size,),
                             dict(dtype=dtype, device=layer_device(device)))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.constant_(self.weight, 1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class ReLU(Layer):
    """``max(x, 0)`` (the reference's ``_act_layer("ReLU", F.relu)``)."""

    def __init__(self, **kwargs):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


def init_layers(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``model`` in place, seeded: each layer's
    ``reset_parameters`` draws from the reference initialisers'
    distributions with one ``torch.Generator`` on the parameters'
    device. Returns ``model``."""
    dev = next(iter(model.parameters())).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def load_layer_state(model: nn.Module, np_state: Dict[str, Any]) -> None:
    """Copy weights into ``model`` by name: ``np_state`` maps the JAX
    model's ``named_parameters()`` names to arrays (e.g. ``np.asarray``
    of each ``p._value``). Every parameter must be given, with its
    shape, and no other name; values are cast to the parameter's
    dtype."""
    own = dict(model.named_parameters())
    if set(own) != set(np_state):
        raise ValueError(
            f"names differ: missing {sorted(set(own) - set(np_state))}, "
            f"unknown {sorted(set(np_state) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            t = to_tensor(np.asarray(np_state[name]))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
