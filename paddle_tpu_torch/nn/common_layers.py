"""``Linear`` and ``LayerNorm`` of ``paddle_tpu/nn/common_layers.py``,
with the reference's parameter names, its ``(in, out)`` weight layout
(``y = x @ W + b``) and its initialisers (:mod:`.initializer`).

As in the reference, a layer's weights are initialised when it is built
(from torch's default generator; ``models.ernie.init`` redraws a whole
model from a seeded one), on ``device``: ``None`` means the card and
raises without one (``ops._common.resolve_device``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops._common import resolve_device
from . import functional as F
from . import initializer as I


class Linear(nn.Module):
    def __init__(self, in_features, out_features, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = nn.Parameter(torch.empty(out_features, **kw))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        I.xavier_uniform_(self.weight, gen)
        I.constant_(self.bias, 0.0)

    def forward(self, x):
        return x @ self.weight + self.bias


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self._shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                       else tuple(normalized_shape))
        self._epsilon = epsilon
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.weight = nn.Parameter(torch.empty(self._shape, **kw))
        self.bias = nn.Parameter(torch.empty(self._shape, **kw))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        I.constant_(self.weight, 1.0)
        I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.layer_norm(x, self._shape, self.weight, self.bias,
                            self._epsilon)
