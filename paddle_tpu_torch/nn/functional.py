"""Functions of ``paddle_tpu/nn/functional.py`` that the ported models
use: ``layer_norm``, ``gelu`` and ``cross_entropy``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_transformer_block import layer_norm_array


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes, fp32 math,
    output in ``x.dtype`` (l.495-518). With weight and bias it is the
    fused op (the Triton kernels for CUDA tensors)."""
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    lead = x.shape[:x.dim() - len(shape)]

    def flat(t):
        return None if t is None else t.reshape(-1)

    y = layer_norm_array(x.reshape(*lead, -1), flat(weight), flat(bias),
                         epsilon)
    return y.reshape(x.shape)


def gelu(x, approximate=False):
    """``jax.nn.gelu(x, approximate=approximate)``: the exact erf form
    by default here (l.61-62), unlike ``jax.nn.gelu``'s own default."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def cross_entropy(input, label, ignore_index=-100):
    """Softmax cross-entropy over the last axis in fp32 with integer
    labels, reduced by the mean over the kept positions (l.854-889):
    positions labelled ``ignore_index`` score 0, and the mean is
    ``Σ loss / max(count, 1)``."""
    logp = torch.log_softmax(input.float(), dim=-1)
    keep = label != ignore_index
    safe = torch.where(keep, label, 0).long()
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.where(keep, -picked, 0.0)
    return loss.sum() / keep.sum().clamp(min=1)
