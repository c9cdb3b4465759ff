"""Functions of ``paddle_tpu/nn/functional.py`` that the ported models
use: ``linear``, ``embedding``, ``relu``, ``silu``, ``gelu``, ``layer_norm``,
``rms_norm``, ``scaled_dot_product_attention`` and ``cross_entropy``.

Each takes ``core.tensor.Tensor``s, as the reference's do: they go
through ``core.dispatch.apply`` under the reference's op name (which the
AMP lists key on) and a Tensor comes out. Given torch tensors, each runs
directly on them (the ported models call them so)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dispatch import any_tensor, apply
from ..ops import flash_attention as fa
from ..ops import rms_norm as rn
from ..ops._common import not_ported
from ..ops.fused_transformer_block import layer_norm_array


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with the reference's ``(in, out)`` weight
    (l.170)."""
    if any_tensor(x, weight, bias):
        args = (x, weight) if bias is None else (x, weight, bias)
        return apply(linear, *args, op_name="linear")
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by id (l.178); rows of id ``padding_idx`` are
    zeros. ``sparse`` changes nothing, as in the reference."""
    if any_tensor(x, weight):
        return apply(lambda i, w: embedding(i, w, padding_idx), x, weight,
                     op_name="embedding")
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def relu(x, name=None):
    if any_tensor(x):
        return apply(F.relu, x, op_name="relu")
    return F.relu(x)


def silu(x, name=None):
    if any_tensor(x):
        return apply(F.silu, x, op_name="silu")
    return F.silu(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes, fp32 math,
    output in ``x.dtype`` (l.495-518). With weight and bias it is the
    fused op (the Triton kernels for CUDA tensors)."""
    if any_tensor(x, weight, bias):
        args = [x] + [t for t in (weight, bias) if t is not None]
        has = (weight is not None, bias is not None)

        def fn(v, *rest):
            it = iter(rest)
            w = next(it) if has[0] else None
            b = next(it) if has[1] else None
            return layer_norm(v, normalized_shape, w, b, epsilon)
        return apply(fn, *args, op_name="layer_norm")
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
    if any_tensor(query, key, value):
        return apply(lambda q, k, v: scaled_dot_product_attention(
            q, k, v, attn_mask, dropout_p, is_causal, training, scale=scale),
            query, key, value, op_name="flash_attention")
    if attn_mask is not None or (dropout_p > 0.0 and training):
        raise not_ported("scaled_dot_product_attention with attn_mask or "
                         "dropout", "masked-attention")
    return fa.sdpa_array(query, key, value, scale=scale, causal=is_causal)


def gelu(x, approximate=False, name=None):
    """``jax.nn.gelu(x, approximate=approximate)``: the exact erf form
    by default here (l.61-62), unlike ``jax.nn.gelu``'s own default."""
    if any_tensor(x):
        return apply(lambda v: gelu(v, approximate), x, op_name="gelu")
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
            or axis not in (-1, len(input.shape) - 1) or not use_softmax
            or label_smoothing != 0.0):
        raise not_ported("cross_entropy with weight, reduction, "
                         "soft_label, axis, use_softmax or "
                         "label_smoothing", "eager API")
    if any_tensor(input, label):
        return apply(lambda i, lab: cross_entropy(i, lab, ignore_index=ignore_index),
                     input, label, op_name="cross_entropy")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    logp = torch.log_softmax(input.float(), dim=-1)
    keep = label != ignore_index
    safe = torch.where(keep, label, 0).long()
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.where(keep, -picked, 0.0)
    return loss.sum() / keep.sum().clamp(min=1)
