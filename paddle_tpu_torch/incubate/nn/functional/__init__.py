"""Functional surface of the fused ops — counterpart of
``paddle_tpu/incubate/nn/functional``: the decoder stack, the fused
norms, rotary embedding and epilogues, the fused products and the
weight-gradient accumulation op.

Each takes ``core.tensor.Tensor``s through ``core.dispatch.apply`` under
the reference's op name, or torch tensors directly. Dropout while
training draws its mask from the framework key stream
(``paddle_tpu_torch.random``): the same seed gives the JAX package's
mask."""

from __future__ import annotations

import torch

from .... import random as _random
from ....core.dispatch import any_tensor, apply, unwrap
from ....ops import fused_transformer_block as ftb
from ....ops import rms_norm as rn
from ....ops import rope as _rope
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
    if any_tensor(x, weight):
        return apply(lambda xv, wv: rn.rms_norm(xv, wv, epsilon), x, weight,
                     op_name="fused_rms_norm")
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
    cos, sin, position_ids = unwrap(cos), unwrap(sin), unwrap(position_ids)
    if any_tensor(q, k, v):
        def rot_pair(a, b):       # one dispatch for the pair
            return apply(lambda av, bv: fused_rotary_position_embedding(
                av, bv, None, sin, cos, position_ids)[:2], a, b,
                op_name="fused_rope")

        def rot_single(t):
            return None if t is None else apply(
                lambda av: fused_rotary_position_embedding(
                    av, None, None, sin, cos, position_ids)[0], t,
                op_name="fused_rope")
        if q is not None and k is not None:
            qo, ko = rot_pair(q, k)
            return qo, ko, rot_single(v)
        return rot_single(q), rot_single(k), rot_single(v)
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
    (``ops.fused_transformer_block.layer_norm_array``). While training,
    an element is kept with probability ``1 - dropout_rate``, the mask
    drawn from the key stream as the reference's ``jax.random.bernoulli``
    draws it; ``upscale_in_train`` divides the kept ones by ``1 -
    dropout_rate``, ``downscale_in_infer`` scales by ``1 - dropout_rate``
    at inference instead."""
    drop = dropout_rate if training else 0.0
    key = _random.next_key() if drop > 0.0 else None
    if any_tensor(x, residual, bias, ln_scale, ln_bias):
        tensors = [t for t in (x, residual, bias, ln_scale, ln_bias)
                   if t is not None]
        has = [t is not None for t in (bias, ln_scale, ln_bias)]

        def fn(xv, rv, *rest):
            it = iter(rest)
            b = next(it) if has[0] else None
            g = next(it) if has[1] else None
            be = next(it) if has[2] else None
            return _bias_dropout_residual_ln(xv, rv, b, g, be, drop, key,
                                             dropout_rate, ln_epsilon,
                                             training, mode)
        return apply(fn, *tensors, op_name="fused_bias_dropout_residual_ln")
    return _bias_dropout_residual_ln(x, residual, bias, ln_scale, ln_bias,
                                     drop, key, dropout_rate, ln_epsilon,
                                     training, mode)


def _bias_dropout_residual_ln(x, residual, bias, ln_scale, ln_bias, drop, key,
                              dropout_rate, ln_epsilon, training, mode):
    y = x if bias is None else x + bias
    if drop > 0.0:
        keep = _random.bernoulli_draw(key, 1.0 - drop, y.shape, y.device)
        if mode == "downscale_in_infer":
            y = torch.where(keep, y, 0.0)      # no rescale in train
        else:                                   # upscale_in_train
            y = torch.where(keep, y / (1.0 - drop), 0.0)
    elif not training and dropout_rate > 0.0 and mode == "downscale_in_infer":
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
    if any_tensor(x, y, bias):
        args = (x, y) if bias is None else (x, y, bias)
        return apply(lambda *vs: fused_matmul_bias(
            *vs, transpose_x=transpose_x, transpose_y=transpose_y),
            *args, op_name="fused_matmul_bias")
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    out = torch.matmul(a, b)
    return out if bias is None else out + bias


def fused_softmax_mask(x, mask, scale=1.0):
    """``softmax(x·scale + mask)`` over the last axis in fp32, cast back
    to x's dtype (l.159)."""
    if any_tensor(x, mask):
        return apply(lambda a, m: fused_softmax_mask(a, m, scale), x, mask,
                     op_name="fused_softmax_mask")
    s = x.float() * scale + mask.float()
    return torch.softmax(s, dim=-1).to(x.dtype)


def fused_softmax_mask_upper_triangle(x, scale=1.0):
    """Causal-masked softmax (l.172): key j is kept for query i when
    ``j <= i + sk - sq``; masked scores are -1e30."""
    if any_tensor(x):
        return apply(lambda a: fused_softmax_mask_upper_triangle(a, scale), x,
                     op_name="fused_softmax_mask_upper_triangle")
    sq, sk = x.shape[-2], x.shape[-1]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=x.device).tril(
        sk - sq)
    s = (x.float() * scale).masked_fill(~keep, -1e30)
    return torch.softmax(s, dim=-1).to(x.dtype)
