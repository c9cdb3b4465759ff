"""``FusedMultiTransformer``, ``FusedMultiHeadAttention`` and
``FusedFeedForward`` — counterparts of the layers in
``paddle_tpu/incubate/nn/layer/fused_transformer.py``, with the
reference's parameter names and its ``(in, out)`` weight layout
(``x @ W + b``). The reference's dropout arguments, which its layers
ignore, are left out.

The JAX layers run as one op over all their parameters, so in post-LN
mode the unused ``pre_ln_scale``/``pre_ln_bias`` still get a gradient,
all zeros (and in pre-LN mode the attention block's unused
``ln_scale``/``ln_bias``). The port gives them the same zero gradients
(:class:`_ZeroGradInputs`), so an optimizer treats them alike: AdamW's
decoupled weight decay moves a parameter whose gradient is zero, and
skips one whose gradient is ``None``.

Weights are initialised when a layer is built, on ``device`` (``None``
means the card), as ``nn/common_layers.py`` says.

``FusedMultiTransformer`` keeps each of its per-layer weights as a
parameter of its own (``qkv_weights.0``, ...; one ``ParameterList`` a
kind gives the reference's names) and hands the lists to
``ops.fused_transformer_block.fused_multi_transformer_array``, which
loops over them: the reference stacks them on every call
(``_run_stacked_block``), which at GPT-2 XL would copy 3 GB a decode
step. It lists its parameters layer by layer, as the reference
registers them (``ln_scales.0, ln_biases.0, ..., ffn2_biases.0,
ln_scales.1, ...``; l.99-108): that order is what binds a saved
optimizer state whose names are not this process's. Its int8 variant
waits for the quantization slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ....nn import initializer as I
from ....nn.layer import Layer, ParameterList
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


class FusedMultiTransformer(Layer):
    """A stack of ``num_layers`` pre-LN decoder layers (ref l.58-123).

    ``forward(src, attn_mask=None, caches=None, time_step=None,
    gen_cache_len=None, seq_lens=None)``: prefill when ``time_step`` is
    None (returning ``(out, cache)`` when ``caches`` or
    ``gen_cache_len`` asks for a KV cache, else ``out``), decode at
    ``time_step`` against ``caches`` (written in place) otherwise. Post-LN
    raises, as in the reference."""

    _NAMES = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
              "linear_weights", "linear_biases", "ffn_ln_scales",
              "ffn_ln_biases", "ffn1_weights", "ffn1_biases",
              "ffn2_weights", "ffn2_biases")
    #: the block op's keys (ops/fused_transformer_block.py) -> the lists
    _STACK_KEYS = (
        ("ln_scale", "ln_scales"), ("ln_bias", "ln_biases"),
        ("qkv_w", "qkv_weights"), ("qkv_b", "qkv_biases"),
        ("out_w", "linear_weights"), ("out_b", "linear_biases"),
        ("ffn_ln_scale", "ffn_ln_scales"), ("ffn_ln_bias", "ffn_ln_biases"),
        ("ffn1_w", "ffn1_weights"), ("ffn1_b", "ffn1_biases"),
        ("ffn2_w", "ffn2_weights"), ("ffn2_b", "ffn2_biases"),
    )

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 epsilon=1e-5, num_layers=1, name=None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        # stored and not applied, as in the reference (l.82)
        self.dropout_rate = dropout_rate
        if not normalize_before:
            raise NotImplementedError(
                "post-LN fused stack not supported (reference default is "
                "pre-LN)")
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dim_feedforward = dim_feedforward
        self.activation = activation
        self.epsilon = epsilon
        self.num_layers = num_layers
        device = resolve_device(device)
        H, Fh = embed_dim, dim_feedforward
        shapes = {
            "ln_scales": (H,), "ln_biases": (H,),
            "qkv_weights": (H, 3 * H), "qkv_biases": (3 * H,),
            "linear_weights": (H, H), "linear_biases": (H,),
            "ffn_ln_scales": (H,), "ffn_ln_biases": (H,),
            "ffn1_weights": (H, Fh), "ffn1_biases": (Fh,),
            "ffn2_weights": (Fh, H), "ffn2_biases": (H,),
        }
        for n in self._NAMES:
            setattr(self, n, ParameterList(
                [_param(shapes[n], dtype, device)
                 for _ in range(num_layers)]))
        self.reset_parameters()

    def _parameter_items(self, prefix, include_sublayers):
        """Layer-major: every kind of layer 0, then of layer 1, ... (the
        lists are the reference's own parameters, so they are listed
        with or without sublayers)."""
        for i in range(self.num_layers):
            for n in self._NAMES:
                name = f"{n}.{i}"
                yield (f"{prefix}.{name}" if prefix else name,
                       getattr(self, n)[i])

    def reset_parameters(self, gen=None):
        """Scales 1, biases 0, weights Xavier-uniform, drawn layer by
        layer in the reference's order."""
        for i in range(self.num_layers):
            for n in self._NAMES:
                p = getattr(self, n)[i]
                if n.endswith("scales"):
                    I.constant_(p, 1.0)
                elif n.endswith("biases"):
                    I.constant_(p, 0.0)
                else:
                    I.xavier_uniform_(p, gen)

    def forward(self, src, attn_mask=None, caches=None, time_step=None,
                gen_cache_len=None, seq_lens=None):
        params = {key: list(getattr(self, attr))
                  for key, attr in self._STACK_KEYS}
        out, kv = ftb.fused_multi_transformer_array(
            src, params, num_heads=self.num_heads, act=self.activation,
            epsilon=self.epsilon, attn_mask=attn_mask, cache_kv=caches,
            time_step=time_step, max_cache_len=gen_cache_len,
            seq_lens=seq_lens)
        return out if kv is None else (out, kv)


class FusedMultiHeadAttention(Layer):
    """Self-attention block with residual; pre-LN by default
    (``normalize_before``), post-LN otherwise."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.0,
                 attn_dropout_rate=0.0, normalize_before=True, epsilon=1e-5,
                 name=None, *, dtype=torch.float32, device=None):
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


class FusedFeedForward(Layer):
    """FFN block with residual: ``act(x @ w1 + b1) @ w2 + b2``; pre-LN by
    default, post-LN otherwise. The activations are the reference's
    ``_ACTS`` (``gelu`` is the tanh approximation)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.0,
                 activation="relu", normalize_before=True, epsilon=1e-5,
                 name=None, *, dtype=torch.float32, device=None):
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
