"""Functions of ``paddle_tpu/nn/functional.py`` that the ported models
use: ``linear``, ``embedding``, ``silu``, ``gelu``, ``layer_norm``,
``rms_norm``, ``scaled_dot_product_attention`` and ``cross_entropy``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops import rms_norm as rn
from ..ops._common import not_ported
from ..ops.fused_transformer_block import layer_norm_array


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with the reference's ``(in, out)`` weight
    (l.170)."""
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by id (l.178); rows of id ``padding_idx`` are
    zeros. ``sparse`` changes nothing, as in the reference."""
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def silu(x, name=None):
    return F.silu(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
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


def rms_norm(x, weight, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (l.521): the Triton kernels for CUDA
    tensors, the plain version for CPU ones."""
    return rn.rms_norm(x, weight, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *, scale=None):
    """(B, S, H, D) attention (l.1009, ``ops/flash_attention.py:739``)
    over the flash kernels; fewer KV heads (GQA) are shared by their
    query heads without repeating K/V. A mask or dropout takes the
    reference's XLA path, which is not ported."""
    if attn_mask is not None or (dropout_p > 0.0 and training):
        raise not_ported("scaled_dot_product_attention with attn_mask or "
                         "dropout", "masked-attention")
    return fa.sdpa_array(query, key, value, scale=scale, causal=is_causal)


def gelu(x, approximate=False, name=None):
    """``jax.nn.gelu(x, approximate=approximate)``: the exact erf form
    by default here (l.61-62), unlike ``jax.nn.gelu``'s own default."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over the last axis in fp32 with integer
    labels, reduced by the mean over the kept positions (l.854-889):
    positions labelled ``ignore_index`` score 0, and the mean is
    ``Σ loss / max(count, 1)``. The reference's other options (class
    weights, another reduction, soft labels, another axis, no softmax,
    label smoothing) come with the eager API and raise."""
    if (weight is not None or reduction != "mean" or soft_label
            or axis not in (-1, input.dim() - 1) or not use_softmax
            or label_smoothing != 0.0):
        raise not_ported("cross_entropy with weight, reduction, "
                         "soft_label, axis, use_softmax or "
                         "label_smoothing", "eager API")
    logp = torch.log_softmax(input.float(), dim=-1)
    keep = label != ignore_index
    safe = torch.where(keep, label, 0).long()
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.where(keep, -picked, 0.0)
    return loss.sum() / keep.sum().clamp(min=1)
