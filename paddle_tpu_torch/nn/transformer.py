"""The Transformer family — counterpart of ``paddle_tpu/nn/transformer.py``:
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache``, the encoder
and decoder layers and stacks (pre-LN and post-LN), and the seq2seq
``Transformer``.

Attention is :func:`.functional.scaled_dot_product_attention`: the flash
kernels (row 5, and row 6 for its gradient) without a mask or dropout,
the reference's masked XLA path otherwise. A stack deep-copies its first
layer, as the reference's does, so the copies start from the same
weights and only the first layer's construction takes keys. ``Cache``
grows by concatenation along the sequence axis, as in the reference.
Layers take ``core.tensor.Tensor``s or torch tensors alike.
"""

from __future__ import annotations

import collections
import copy
import math

import numpy as np
import torch

from . import functional as F
from .common_layers import Dropout, LayerNorm, Linear
from .layer import Layer, LayerList
from ..core.dispatch import any_tensor
from ..core.math_ops import concat
from ..core.tensor import Tensor


def _cat(xs, axis):
    return concat(xs, axis=axis) if any_tensor(*xs) else torch.cat(xs, axis)


class MultiHeadAttention(Layer):
    """(B, S, E) in and out, optional cross attention (kdim/vdim), a
    boolean or additive ``attn_mask`` broadcastable to (B, H, Sq, Sk)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, bias_attr=bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, bias_attr=bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr)

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def _heads(self, t):
        return t.reshape([t.shape[0], t.shape[1], self.num_heads,
                          self.head_dim])

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: the cross-attention K/V of ``key``/``value``,
        projected once. ``Cache`` with both given: the tensors as
        already-projected K/V. ``Cache`` otherwise: empty (B, 0, H, D)
        K/V that self-attention grows step by step."""
        if type is MultiHeadAttention.StaticCache:
            value = key if value is None else value
            return MultiHeadAttention.StaticCache(
                self._heads(self.k_proj(key)), self._heads(self.v_proj(value)))
        if value is not None:
            return MultiHeadAttention.Cache(key, value)
        v = key._value if isinstance(key, Tensor) else key
        z = torch.zeros((v.shape[0], 0, self.num_heads, self.head_dim),
                        dtype=v.dtype, device=v.device)
        if isinstance(key, Tensor):
            z = Tensor(z)
        return MultiHeadAttention.Cache(z, z)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        b, sq = query.shape[0], query.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self._heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = _cat([cache.k, k], 1)
                v = _cat([cache.v, v], 1)
                cache = MultiHeadAttention.Cache(k, v)
        if self.need_weights:
            # the probabilities are materialised; no dropout on them, as
            # in the reference
            def fn(qv, kv, vv, m):
                s = torch.einsum("bqhd,bkhd->bhqk", qv.float(),
                                 kv.float()) * (1.0 / math.sqrt(d))
                if m is not None:
                    s = s + m.float()
                p = torch.softmax(s, dim=-1)
                o = torch.einsum("bhqk,bkhd->bqhd", p,
                                 vv.float()).to(qv.dtype)
                return o, p
            o, weights = F._run(fn, q, k, v, attn_mask, op_name="mha_weights",
                                n_outputs=2)
            outs = (self.out_proj(o.reshape([b, sq, h * d])), weights)
        else:
            o = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training, is_causal=False)
            outs = self.out_proj(o.reshape([b, sq, h * d]))
        if isinstance(cache, (MultiHeadAttention.Cache,
                              MultiHeadAttention.StaticCache)):
            if not isinstance(outs, tuple):
                outs = (outs,)
            return outs + (cache,)
        return outs


def _act(name):
    return {"relu": F.relu, "gelu": F.gelu}[name]


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout
            if attn_dropout is not None else dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(act_dropout
                                if act_dropout is not None else dropout)
        self.activation = activation
        self.normalize_before = normalize_before

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        x = residual + self.dropout1(self.self_attn(x, attn_mask=src_mask))
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.linear2(self.dropout2(_act(self.activation)(
            self.linear1(y))))
        x = residual + self.dropout(y)
        if not self.normalize_before:
            x = self.norm2(x)
        return x


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(act_dropout
                                if act_dropout is not None else dropout)
        self.dropout_out = Dropout(dropout)
        self.activation = activation
        self.normalize_before = normalize_before

    def gen_cache(self, memory):
        """(incremental self-attention ``Cache``, cross-attention
        ``StaticCache``): the tuple forward's ``cache`` threads."""
        incremental = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        new_cache = None
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        if cache is None:
            y = self.self_attn(x, attn_mask=tgt_mask)
        else:
            y, incremental = self.self_attn(x, x, x, attn_mask=tgt_mask,
                                            cache=cache[0])
        x = residual + self.dropout1(y)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        if cache is None:
            y = self.cross_attn(y, memory, memory, attn_mask=memory_mask)
        else:
            y, static = self.cross_attn(y, memory, memory,
                                        attn_mask=memory_mask, cache=cache[1])
            new_cache = (incremental, static)
        x = residual + self.dropout2(y)
        if not self.normalize_before:
            x = self.norm2(x)
        residual = x
        y = self.norm3(x) if self.normalize_before else x
        y = self.linear2(self.dropout3(_act(self.activation)(
            self.linear1(y))))
        x = residual + self.dropout_out(y)
        if not self.normalize_before:
            x = self.norm3(x)
        return x if cache is None else (x, new_cache)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def gen_cache(self, memory, do_zip=False):
        """Per-layer (incremental, static) cache tuples; ``do_zip``
        transposes to ([incrementals...], [statics...])."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            return list(map(list, zip(*caches)))
        return caches

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
            else:
                out, nc = layer(out, memory, tgt_mask=tgt_mask,
                                memory_mask=memory_mask, cache=cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)


class Transformer(Layer):
    """The encoder-decoder seq2seq container. Its defaults are
    Transformer-base (Vaswani et al. 2017): d_model 512, 8 heads, 6 + 6
    layers, d_ff 2048, dropout 0.1."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    @staticmethod
    def generate_square_subsequent_mask(length) -> Tensor:
        """The additive causal mask: −inf above the diagonal, on the
        current place."""
        m = np.triu(np.full((length, length), -np.inf, np.float32), k=1)
        return Tensor(m)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
