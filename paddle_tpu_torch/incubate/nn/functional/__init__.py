"""Functional surface of the fused ops (counterpart of
``paddle_tpu/incubate/nn/functional``): the weight-gradient accumulation
op and the fused products, as far as the ported models use them."""

from __future__ import annotations

import torch

from ....ops.fused_linear import fused_linear_param_grad_add  # noqa: F401


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``fused_matmul_bias`` with ``transpose_y=transpose_weight``
    (l.136): one product plus the bias."""
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False):
    """``matmul(x, y) + bias`` (l.143); a transpose swaps the last two
    dims only (Paddle's matmul for batched inputs)."""
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    out = torch.matmul(a, b)
    return out if bias is None else out + bias
