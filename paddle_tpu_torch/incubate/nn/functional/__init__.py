"""Functional surface of the fused ops — counterpart of
``paddle_tpu/incubate/nn/functional``: the decoder stack, the fused
norms, rotary embedding and epilogues, the fused products and the
weight-gradient accumulation op.

Dropout while training needs the eager API's random stream
(``random.py``), which is not ported: a nonzero rate with
``training=True`` raises."""

from __future__ import annotations

import torch

from ....ops import fused_transformer_block as ftb
from ....ops import rms_norm as rn
from ....ops import rope as _rope
from ....ops._common import not_ported
from ....ops.fused_linear import fused_linear_param_grad_add  # noqa: F401


def fused_multi_transformer(x, params, *, num_heads, activation="gelu",
                            epsilon=1e-5, attn_mask=None, cache_kvs=None,
                            time_step=None, max_cache_len=None,
                            seq_lens=None):
    """The decoder stack (l.12) over
    ``ops.fused_transformer_block.fused_multi_transformer_array``:
    ``params`` maps the block's keys to stacked tensors or per-layer
    lists. Returns ``out``, or ``(out, cache)`` when a cache was asked
    for or updated (decode writes ``cache_kvs`` in place)."""
    out, kv = ftb.fused_multi_transformer_array(
        x, params, num_heads=num_heads, act=activation, epsilon=epsilon,
        attn_mask=attn_mask, cache_kv=cache_kvs, time_step=time_step,
        max_cache_len=max_cache_len, seq_lens=seq_lens)
    return out if kv is None else (out, kv)


def fused_rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last axis (l.37): the Triton kernel for CUDA
    tensors (``ops/rms_norm.py``), the plain version for CPU ones."""
    return rn.rms_norm(x, weight, epsilon)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotary embedding (l.44), the reference's argument order (q, k, v,
    sin, cos, position_ids, use_neox_rotary_style), over
    ``ops.rope.apply_rope_array`` on (B, S, H, D) tensors. Returns a
    (q, k, v) tuple with None for absent inputs. Only the neox
    (rotate-half) style exists; the interleaved style raises."""
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "use_neox_rotary_style=False (GPT-J interleaved rotation) is "
            "not implemented; only the rotate-half (neox) style is")
    if sin is None or cos is None:
        raise ValueError("sin and cos caches are required")
    if cos.dim() == 4:                   # paddle caches are (1, S, 1, D)
        cos, sin = cos[0, :, 0, :], sin[0, :, 0, :]
    if position_ids is not None:
        pid = position_ids.long()
        cos, sin = cos[pid], sin[pid]    # (B, S, D)

    def rot_one(t):
        return None if t is None else _rope.apply_rope_array(t, t, cos,
                                                             sin)[0]

    if q is not None and k is not None:
        qo, ko = _rope.apply_rope_array(q, k, cos, sin)
        return qo, ko, rot_one(v)
    return rot_one(q), rot_one(k), rot_one(v)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """``LayerNorm(dropout(x + bias) + residual)`` (l.90), the reference's
    argument names and defaults, the LayerNorm in fp32
    (``ops.fused_transformer_block.layer_norm_array``). Inference
    (``training=False``) or a zero rate is ported: ``downscale_in_infer``
    scales by ``1 - dropout_rate`` at inference."""
    if training and dropout_rate > 0.0:
        raise not_ported("fused_bias_dropout_residual_layer_norm with "
                         "dropout while training", "eager API (random.py)")
    y = x if bias is None else x + bias
    if not training and dropout_rate > 0.0 and mode == "downscale_in_infer":
        y = y * (1.0 - dropout_rate)
    return ftb.layer_norm_array(y + residual, ln_scale, ln_bias, ln_epsilon)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``fused_matmul_bias`` with ``transpose_y=transpose_weight``
    (l.136): one product plus the bias."""
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``matmul(x, y) + bias`` (l.143); a transpose swaps the last two
    dims only (Paddle's matmul for batched inputs)."""
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    out = torch.matmul(a, b)
    return out if bias is None else out + bias


def fused_softmax_mask(x, mask, scale=1.0):
    """``softmax(x·scale + mask)`` over the last axis in fp32, cast back
    to x's dtype (l.159)."""
    s = x.float() * scale + mask.float()
    return torch.softmax(s, dim=-1).to(x.dtype)


def fused_softmax_mask_upper_triangle(x, scale=1.0):
    """Causal-masked softmax (l.172): key j is kept for query i when
    ``j <= i + sk - sq``; masked scores are -1e30."""
    sq, sk = x.shape[-2], x.shape[-1]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=x.device).tril(
        sk - sq)
    s = (x.float() * scale).masked_fill(~keep, -1e30)
    return torch.softmax(s, dim=-1).to(x.dtype)
