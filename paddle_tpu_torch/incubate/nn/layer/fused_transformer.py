"""``FusedMultiHeadAttention`` and ``FusedFeedForward`` — counterparts of
the layers in ``paddle_tpu/incubate/nn/layer/fused_transformer.py``,
pre-LN and post-LN, with the reference's parameter names and its
``(in, out)`` weight layout (``x @ W + b``). The reference's dropout
arguments, which its layers ignore, are left out.

The JAX layers run as one op over all their parameters, so in post-LN
mode the unused ``pre_ln_scale``/``pre_ln_bias`` still get a gradient,
all zeros (and in pre-LN mode the attention block's unused
``ln_scale``/``ln_bias``). The port gives them the same zero gradients
(:class:`_ZeroGradInputs`), so an optimizer treats them alike: AdamW's
decoupled weight decay moves a parameter whose gradient is zero, and
skips one whose gradient is ``None``.

Weights are initialised when a layer is built, on ``device`` (``None``
means the card), as ``nn/common_layers.py`` says.

``FusedMultiTransformer`` and its int8 variant belong to a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ....nn import initializer as I
from ....ops import fused_transformer_block as ftb
from ....ops._common import resolve_device


class _ZeroGradInputs(torch.autograd.Function):
    """Identity in ``y`` whose backward also hands each of ``unused`` a
    zero gradient: they are inputs of the reference's op."""

    @staticmethod
    def forward(ctx, y, *unused):
        ctx.unused = [(p.shape, p.dtype, p.device) for p in unused]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.unused))


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class FusedMultiHeadAttention(nn.Module):
    """Self-attention block with residual; pre-LN by default
    (``normalize_before``), post-LN otherwise."""

    def __init__(self, embed_dim, num_heads, normalize_before=True,
                 epsilon=1e-5, dtype=torch.float32, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        device = resolve_device(device)
        H = embed_dim
        for name, shape in (("pre_ln_scale", (H,)), ("pre_ln_bias", (H,)),
                            ("qkv_weight", (H, 3 * H)),
                            ("qkv_bias", (3 * H,)),
                            ("linear_weight", (H, H)),
                            ("linear_bias", (H,)), ("ln_scale", (H,)),
                            ("ln_bias", (H,))):
            setattr(self, name, _param(shape, dtype, device))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        for name, p in self.named_parameters(recurse=False):
            if name.endswith("scale"):
                I.constant_(p, 1.0)
            elif name.endswith("bias"):
                I.constant_(p, 0.0)
            else:
                I.xavier_uniform_(p, gen)

    def forward(self, x, attn_mask=None, causal=True, seg_ids=None):
        """``seg_ids`` (B, S) int turns on the sequence-packed mode:
        tokens attend only within their own segment (negative ids are
        pads), through the segment-masked flash kernels."""
        b, s, h = x.shape
        eps = self.epsilon
        pre = self.normalize_before
        xn = (ftb.layer_norm_array(x, self.pre_ln_scale, self.pre_ln_bias,
                                   eps) if pre else x)
        qkv = xn @ self.qkv_weight + self.qkv_bias
        q, k, v = ftb._split_heads(qkv, self.num_heads)
        attn = ftb._prefill_attention(q, k, v, attn_mask, causal=causal,
                                      seg_ids=seg_ids)
        attn = attn.transpose(1, 2).reshape(b, s, h)
        y = x + (attn @ self.linear_weight + self.linear_bias).to(x.dtype)
        if pre:
            return _ZeroGradInputs.apply(y, self.ln_scale, self.ln_bias)
        y = ftb.layer_norm_array(y, self.ln_scale, self.ln_bias, eps)
        return _ZeroGradInputs.apply(y, self.pre_ln_scale, self.pre_ln_bias)


class FusedFeedForward(nn.Module):
    """FFN block with residual: ``act(x @ w1 + b1) @ w2 + b2``; pre-LN by
    default, post-LN otherwise. The activations are the reference's
    ``_ACTS`` (``gelu`` is the tanh approximation)."""

    def __init__(self, d_model, dim_feedforward, activation="relu",
                 normalize_before=True, epsilon=1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.activation = activation
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        device = resolve_device(device)
        for name, shape in (("ln_scale", (d_model,)), ("ln_bias", (d_model,)),
                            ("w1", (d_model, dim_feedforward)),
                            ("b1", (dim_feedforward,)),
                            ("w2", (dim_feedforward, d_model)),
                            ("b2", (d_model,))):
            setattr(self, name, _param(shape, dtype, device))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        I.constant_(self.ln_scale, 1.0)
        for p in (self.ln_bias, self.b1, self.b2):
            I.constant_(p, 0.0)
        I.xavier_uniform_(self.w1, gen)
        I.xavier_uniform_(self.w2, gen)

    def forward(self, x):
        eps = self.epsilon
        act = ftb._ACTS[self.activation]
        pre = self.normalize_before
        xn = (ftb.layer_norm_array(x, self.ln_scale, self.ln_bias, eps)
              if pre else x)
        y = x + (act(xn @ self.w1 + self.b1) @ self.w2 + self.b2).to(x.dtype)
        if not pre:
            y = ftb.layer_norm_array(y, self.ln_scale, self.ln_bias, eps)
        return y
