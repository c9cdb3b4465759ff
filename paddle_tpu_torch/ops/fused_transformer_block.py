"""Pieces of the fused transformer block — counterpart of
``paddle_tpu/ops/fused_transformer_block.py``, as far as the encoder
layers (``incubate/nn/layer/fused_transformer.py``) use it: the
activations, the LayerNorm, the head split and the prefill attention.

The stacked decoder (``fused_multi_transformer_array``), its cached
decode attention and its int8 path belong to a later slice of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import flash_attention as fa
from .layer_norm_fused import _stats, layer_norm

#: ``jax.nn.gelu`` defaults to the tanh approximation; the reference's FFN
#: uses that default
_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def layer_norm_array(x, scale=None, bias=None, eps=1e-5):
    """fp32-accumulated LayerNorm over the last axis, output in
    ``x.dtype``. With both ``scale`` and ``bias`` it is the fused op
    (``ops/layer_norm_fused.py``: the Triton kernels for CUDA tensors);
    otherwise the plain form, scale and bias optional."""
    if scale is not None and bias is not None:
        return layer_norm(x, scale, bias, eps)
    xf = x.float()
    mu, inv = _stats(xf, eps)
    y = (xf - mu) * inv
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _split_heads(qkv, num_heads):
    """(B, S, 3H) -> 3 × (B, nh, S, hd) views."""
    b, s, three_h = qkv.shape
    hd = three_h // 3 // num_heads
    qkv = qkv.reshape(b, s, 3, num_heads, hd)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _prefill_attention(q, k, v, attn_mask, causal=True, seg_ids=None):
    """(B, nh, S, hd) attention. Segment ids: the segment-masked flash
    kernels; no mask: the flash kernels; an additive mask: a plain
    einsum and softmax, as the JAX package computes it outside Pallas."""
    b, nh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    if seg_ids is not None:
        if attn_mask is not None:
            raise ValueError("seg_ids and attn_mask are mutually exclusive")
        return fa.flash_attention_segmented(q, k, v, seg_ids, scale=scale,
                                            causal=causal)
    if attn_mask is None:
        flat = (t.contiguous().reshape(b * nh, s, hd) for t in (q, k, v))
        out = fa.flash_attention_bhsd(*flat, scale, causal)
        return out.reshape(b, nh, s, hd)
    logits = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    if causal:
        tril = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tril, -math.inf)
    logits = logits + attn_mask.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bnkd->bnqd", p, v)
