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
optimizer state whose names are not this process's.

``FusedMultiTransformerInt8`` is the A8W8 stack: int8 projection
weights with per-output-channel scales, run through the block op's
``int8=True`` path (``ops.fused_transformer_block._int8_mm``).
"""

from __future__ import annotations

import numpy as np
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


class FusedMultiTransformerInt8(Layer):
    """The A8W8 fused decoder stack (ref l.222-353): int8 projection
    weights with fp32 per-output-channel scales; each of the four
    products quantizes its activations (per token, or by the calibrated
    ``*_in_scale`` lists, one range per layer) and runs int8×int8→int32.
    Build it from a float stack with :meth:`from_float`. Post-LN raises,
    as in the reference.

    Its parameters are the reference's, layer by layer: ``ln_scales.i``,
    ``ln_biases.i``, ``ffn_ln_scales.i``, ``ffn_ln_biases.i``, then for
    each of ``qkv``, ``linear``, ``ffn1``, ``ffn2`` the int8 weight
    ``<wk>_w_q.i``, its scale ``<wk>_w_scale.i`` and the bias
    ``<wk>_b.i``; ``qkv_weights``, ``qkv_scales``, ``qkv_biases``, ...
    are the reference's per-kind lists of them. The int8 weights are
    kept column-major (``ops.fused_transformer_block.col_major``), the
    layout the card's int8 GEMM takes."""

    _WKEYS = ("qkv", "linear", "ffn1", "ffn2")
    _LN = ("ln_scales", "ln_biases", "ffn_ln_scales", "ffn_ln_biases")
    #: the block op's weight and bias keys of each projection
    _OPNAME = {"qkv": "qkv_w", "linear": "out_w", "ffn1": "ffn1_w",
               "ffn2": "ffn2_w"}
    _OPBIAS = {"qkv": "qkv_b", "linear": "out_b", "ffn1": "ffn1_b",
               "ffn2": "ffn2_b"}

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 epsilon=1e-5, num_layers=1, qkv_in_scale=None,
                 linear_in_scale=None, ffn1_in_scale=None,
                 ffn2_in_scale=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError("post-LN int8 stack not supported")
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dim_feedforward = dim_feedforward
        self.activation = activation
        self.epsilon = epsilon
        self.num_layers = num_layers
        self.in_scales = {"qkv": qkv_in_scale, "linear": linear_in_scale,
                          "ffn1": ffn1_in_scale, "ffn2": ffn2_in_scale}
        device = resolve_device(device)
        H, Fh = embed_dim, dim_feedforward
        wshapes = {"qkv": (H, 3 * H), "linear": (H, H),
                   "ffn1": (H, Fh), "ffn2": (Fh, H)}

        def const(shape, value, dt=dtype):
            return nn.Parameter(torch.full(shape, value, dtype=dt,
                                           device=device))

        def frozen(value):
            return nn.Parameter(value, requires_grad=False)

        for n in self._LN:
            v = 1.0 if n.endswith("scales") else 0.0
            setattr(self, n, ParameterList(
                [const((H,), v) for _ in range(num_layers)]))
        for wk in self._WKEYS:
            k, n = wshapes[wk]
            setattr(self, f"{wk}_w_q", ParameterList(
                [frozen(ftb.col_major(torch.zeros(
                    (k, n), dtype=torch.int8, device=device)))
                 for _ in range(num_layers)]))
            setattr(self, f"{wk}_w_scale", ParameterList(
                [frozen(torch.ones((n,), dtype=torch.float32,
                                   device=device))
                 for _ in range(num_layers)]))
            setattr(self, f"{wk}_b", ParameterList(
                [const((n,), 0.0) for _ in range(num_layers)]))
        # the calibrated ranges, made on the device once (a captured
        # program reads them there)
        self._in_scale = {
            self._OPNAME[wk] + "_in_scale": torch.as_tensor(
                np.asarray(v, np.float32), device=device)
            for wk, v in self.in_scales.items() if v is not None}

    # the reference's per-kind lists
    qkv_weights = property(lambda self: self.qkv_w_q)
    qkv_scales = property(lambda self: self.qkv_w_scale)
    qkv_biases = property(lambda self: self.qkv_b)
    linear_weights = property(lambda self: self.linear_w_q)
    linear_scales = property(lambda self: self.linear_w_scale)
    linear_biases = property(lambda self: self.linear_b)
    ffn1_weights = property(lambda self: self.ffn1_w_q)
    ffn1_scales = property(lambda self: self.ffn1_w_scale)
    ffn1_biases = property(lambda self: self.ffn1_b)
    ffn2_weights = property(lambda self: self.ffn2_w_q)
    ffn2_scales = property(lambda self: self.ffn2_w_scale)
    ffn2_biases = property(lambda self: self.ffn2_b)

    def _parameter_items(self, prefix, include_sublayers):
        """Layer-major, in the reference's registration order."""
        kinds = list(self._LN) + [f"{wk}_{part}" for wk in self._WKEYS
                                  for part in ("w_q", "w_scale", "b")]
        for i in range(self.num_layers):
            for n in kinds:
                name = f"{n}.{i}"
                yield (f"{prefix}.{name}" if prefix else name,
                       getattr(self, n)[i])

    @classmethod
    def from_float(cls, float_stack: "FusedMultiTransformer",
                   qkv_in_scale=None, linear_in_scale=None,
                   ffn1_in_scale=None, ffn2_in_scale=None):
        """Quantize a float stack's projection weights (ref l.295-331);
        the norms and biases are copied. Built on the float stack's
        device, in its dtype."""
        from ....quantization import weight_quantize

        ref = float_stack.qkv_weights[0]
        m = cls(float_stack.embed_dim, float_stack.num_heads,
                float_stack.dim_feedforward,
                activation=float_stack.activation,
                epsilon=float_stack.epsilon,
                num_layers=float_stack.num_layers,
                qkv_in_scale=qkv_in_scale, linear_in_scale=linear_in_scale,
                ffn1_in_scale=ffn1_in_scale, ffn2_in_scale=ffn2_in_scale,
                dtype=ref.dtype, device=ref.device)
        with torch.no_grad():
            for i in range(m.num_layers):
                for n in cls._LN:
                    getattr(m, n)[i].copy_(getattr(float_stack, n)[i])
                for wk in cls._WKEYS:
                    q, s = weight_quantize(
                        getattr(float_stack, f"{wk}_weights")[i])
                    getattr(m, f"{wk}_w_q")[i].copy_(q)
                    getattr(m, f"{wk}_w_scale")[i].copy_(s)
                    getattr(m, f"{wk}_b")[i].copy_(
                        getattr(float_stack, f"{wk}_biases")[i])
        return m

    def forward(self, src, attn_mask=None, caches=None, time_step=None,
                gen_cache_len=None, seq_lens=None):
        params = {"ln_scale": list(self.ln_scales),
                  "ln_bias": list(self.ln_biases),
                  "ffn_ln_scale": list(self.ffn_ln_scales),
                  "ffn_ln_bias": list(self.ffn_ln_biases)}
        for wk in self._WKEYS:
            op = self._OPNAME[wk]
            params[op + "_q"] = list(getattr(self, f"{wk}_w_q"))
            params[op + "_scale"] = list(getattr(self, f"{wk}_w_scale"))
            params[self._OPBIAS[wk]] = list(getattr(self, f"{wk}_b"))
        params.update(self._in_scale)
        out, kv = ftb.fused_multi_transformer_array(
            src, params, num_heads=self.num_heads, act=self.activation,
            epsilon=self.epsilon, attn_mask=attn_mask, cache_kv=caches,
            time_step=time_step, max_cache_len=gen_cache_len,
            seq_lens=seq_lens, int8=True)
        return out if kv is None else (out, kv)
