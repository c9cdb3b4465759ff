"""Tensor-parallel layers of
``paddle_tpu/distributed/meta_parallel/mp_layers.py`` (l.44-150) at mp
degree 1, the one-device case: ``ColumnParallelLinear``,
``RowParallelLinear`` and ``VocabParallelEmbedding`` with the
reference's ``(in, out)`` / ``(vocab, emb)`` weights, parameter names
and initialisers (Xavier-uniform weights, zero biases, normal(0, 0.02)
embeddings). At degree 1 the reference's ``gather_output``,
``input_is_parallel`` and ``fuse_matmul_bias`` change nothing (its GSPMD
mode): the port takes them and does the same. An mp group (degree > 1)
and a ``ParamAttr`` come with later slices of the port and raise.

Weights are drawn when a layer is built (torch's default generator;
``nn.common_layers.init_layers`` redraws a model seeded), on ``device``:
``None`` means the card and raises without one.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.common_layers import param_attr
from ...nn.layer import Layer
from ...ops._common import not_ported, resolve_device


def _one_device(mp_group):
    if mp_group is not None:
        raise not_ported("an mp group (tensor parallelism over devices)",
                         "distributed")


class _ParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr, has_bias,
                 mp_group, dtype, device):
        super().__init__()
        _one_device(mp_group)
        param_attr(weight_attr, type(self).__name__)
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = (nn.Parameter(torch.empty(out_features, **kw))
                     if has_bias else None)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        I.xavier_uniform_(self.weight, gen)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ColumnParallelLinear(_ParallelLinear):
    """Weight (in, out); at mp degree > 1 it would be split on out."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, dtype, device)
        self.gather_output = gather_output


class RowParallelLinear(_ParallelLinear):
    """Weight (in, out); at mp degree > 1 it would be split on in."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, dtype, device)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Layer):
    """Weight (vocab, emb); at mp degree > 1 it would be split on
    vocab."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        _one_device(mp_group)
        param_attr(weight_attr, "VocabParallelEmbedding")
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=dtype,
            device=resolve_device(device)))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        I.normal_(self.weight, gen, 0.0, 0.02)

    def forward(self, x):
        return F.embedding(x, self.weight)
