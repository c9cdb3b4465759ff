"""ERNIE/BERT-style bidirectional encoder family — counterpart of
``paddle_tpu/models/ernie.py``: post-LN encoder layers built from
``FusedMultiHeadAttention`` (``causal=False``) and ``FusedFeedForward``,
word + position + token-type embeddings, a pooler, and masked-LM and
sequence-classification heads.

Parameter names are the JAX model's ``named_parameters()`` names, and
weights keep its ``(in, out)`` layout, so weights made by the JAX package
carry across as a copy by name (:func:`params_from_numpy`). :func:`init`
redraws seeded weights with the reference initialisers' distributions.
As in the reference, every layer also initialises its weights when it
is built (from torch's default generator), and the models are built on
``device``: ``None`` means the card and raises without one; pass
``device="cpu"`` for the plain versions.

Two modes, as in the reference: padded batches with an additive mask
built from the pad token (a plain einsum + softmax attention), and
sequence-packed batches with ``segment_ids`` (several sequences per row,
negative ids for pads; the segment-masked flash kernels, positions
restarting per segment). Two GELUs: the FFN's is the tanh approximation
(``jax.nn.gelu``'s default), the MLM head's the exact erf form.

:func:`build_mlm_train_step` is the counterpart of
``paddle.jit.TrainStep(net, loss_fn, AdamW)`` over
``compute_loss(ids, labels, segment_ids=seg)``: forward, backward and
AdamW with fp32 master weights, no remat. The kernels on that path:
LayerNorm forward and backward (``ops/layer_norm_fused.py``: the 2L post-LNs,
the embeddings' LN and the MLM transform's LN) and the segment-masked
flash forward, dQ and dK/dV (``ops/flash_attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..incubate.nn.layer.fused_transformer import (FusedFeedForward,
                                                   FusedMultiHeadAttention)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.common_layers import LayerNorm, Linear
from ..nn.common_layers import init_layers as init
from ..nn.common_layers import load_layer_state as params_from_numpy
from ..nn.layer import Layer, LayerList
from ..ops._common import resolve_device
from ..optimizer.adamw import AdamW


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_epsilon: float = 1e-12
    activation: str = "gelu"
    pad_token_id: int = 0


def ernie_tiny(**over) -> ErnieConfig:
    base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, type_vocab_size=2)
    base.update(over)
    return ErnieConfig(**base)


class ErnieEmbeddings(Layer):
    def __init__(self, config: ErnieConfig, *, dtype, device):
        super().__init__()
        h = config.hidden_size

        def table(n):
            return nn.Parameter(torch.empty(n, h, dtype=dtype, device=device))

        self.word_embeddings = table(config.vocab_size)
        self.position_embeddings = table(config.max_position_embeddings)
        self.token_type_embeddings = table(config.type_vocab_size)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_epsilon,
                                    dtype=dtype, device=device)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        for p in (self.word_embeddings, self.position_embeddings,
                  self.token_type_embeddings):
            I.normal_(p, gen, 0.0, 0.02)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            p = self.position_embeddings[None, :input_ids.shape[-1]]
        else:
            p = TF.embedding(position_ids.long(), self.position_embeddings)
        x = (TF.embedding(input_ids.long(), self.word_embeddings) + p
             + TF.embedding(token_type_ids.long(),
                            self.token_type_embeddings))
        return self.layer_norm(x)


class ErnieEncoderLayer(Layer):
    """Post-LN encoder block over the fused attention and FFN layers."""

    def __init__(self, config: ErnieConfig, *, dtype, device):
        super().__init__()
        self.self_attn = FusedMultiHeadAttention(
            config.hidden_size, config.num_attention_heads,
            normalize_before=False, epsilon=config.layer_norm_epsilon,
            dtype=dtype, device=device)
        self.ffn = FusedFeedForward(
            config.hidden_size, config.intermediate_size,
            activation=config.activation, normalize_before=False,
            epsilon=config.layer_norm_epsilon, dtype=dtype, device=device)

    def forward(self, x, attn_mask=None, seg_ids=None):
        x = self.self_attn(x, attn_mask=attn_mask, causal=False,
                           seg_ids=seg_ids)
        return self.ffn(x)


class ErniePooler(Layer):
    def __init__(self, config: ErnieConfig, *, dtype, device):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            dtype=dtype, device=device)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def _attention_mask_from_ids(input_ids, pad_token_id: int):
    """(B, S) token ids -> additive (B, 1, 1, S) fp32 mask, −1e4 at
    pads."""
    pad = input_ids == pad_token_id
    return torch.where(pad, -1e4, 0.0)[:, None, None, :]


def packed_position_ids(segment_ids):
    """(B, S) segment ids -> (B, S) int32 positions restarting at 0 per
    segment (pads get 0)."""
    seg = segment_ids
    idx = torch.arange(seg.shape[-1], device=seg.device)[None, :]
    is_start = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                          seg[:, 1:] != seg[:, :-1]], dim=-1)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    return torch.where(seg < 0, 0, idx - start).to(torch.int32)


class ErnieModel(Layer):
    def __init__(self, config: ErnieConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.embeddings = ErnieEmbeddings(config, dtype=dtype, device=device)
        self.encoder = LayerList(
            [ErnieEncoderLayer(config, dtype=dtype, device=device)
             for _ in range(config.num_hidden_layers)])
        self.pooler = ErniePooler(config, dtype=dtype, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                segment_ids=None):
        """Returns ``(sequence output, pooled)``. ``segment_ids`` (B, S)
        turns on the sequence-packed mode (negative ids are pads); it
        excludes ``attention_mask``."""
        if segment_ids is not None:
            if attention_mask is not None:
                raise ValueError(
                    "segment_ids and attention_mask are mutually exclusive")
            pos = packed_position_ids(segment_ids)
            x = self.embeddings(input_ids, token_type_ids, position_ids=pos)
            for layer in self.encoder:
                x = layer(x, seg_ids=segment_ids)
            return x, self.pooler(x)
        if attention_mask is None:
            attention_mask = _attention_mask_from_ids(
                input_ids, self.config.pad_token_id)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask=attention_mask)
        return x, self.pooler(x)


class ErnieForSequenceClassification(Layer):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.ernie = ErnieModel(config, dtype=dtype, device=device)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 dtype=dtype, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(pooled)


class ErnieForMaskedLM(Layer):
    """MLM head tied to the word embedding: ``LN(gelu(h @ W + b)) @
    word_embeddingsᵀ + bias``, with the exact (erf) GELU."""

    def __init__(self, config: ErnieConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.ernie = ErnieModel(config, dtype=dtype, device=device)
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                dtype=dtype, device=device)
        self.transform_ln = LayerNorm(config.hidden_size,
                                      epsilon=config.layer_norm_epsilon,
                                      dtype=dtype, device=device)
        self.bias = nn.Parameter(torch.empty(config.vocab_size, dtype=dtype,
                                             device=device))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        I.constant_(self.bias, 0.0)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                segment_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids, attention_mask,
                            segment_ids=segment_ids)
        h = self.transform_ln(F.gelu(self.transform(seq)))
        return h @ self.ernie.embeddings.word_embeddings.t() + self.bias

    def compute_loss(self, input_ids, labels, token_type_ids=None,
                     segment_ids=None):
        """Mean cross-entropy over the scored positions: labels are −100
        where unscored (and at pads in packed mode)."""
        logits = self(input_ids, token_type_ids, segment_ids=segment_ids)
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def build_mlm_train_step(config: ErnieConfig, learning_rate: float = 1e-4,
                         weight_decay: float = 0.01,
                         dtype=torch.float32, device=None):
    """Packed (or padded) MLM pretraining on one device. Returns
    ``(step_fn, init_fn)``.

    ``init_fn(seed=0) -> (model, opt)``: an :class:`ErnieForMaskedLM` in
    ``dtype`` on ``device`` (``None`` means the card) with seeded weights
    (:func:`init`), and its :class:`AdamW` (b1 0.9, b2 0.999, eps 1e-8,
    decoupled ``weight_decay``, fp32 moments, and fp32 master weights
    when ``dtype`` is bf16 or fp16: ``amp.decorate(level="O2")``).

    ``step_fn(model, opt, ids, labels, segment_ids=None) -> loss``: the
    mean MLM loss of one batch (a 0-d fp32 tensor), its backward, and one
    AdamW step over the parameters that got a gradient; the weights and
    the optimizer state are updated in place. Gradients are dropped
    (``None``) before the forward, so a parameter off the loss path (the
    pooler) is skipped, as in the reference's eager step.
    """
    lr = float(learning_rate)

    def init_fn(seed: int = 0):
        model = init(ErnieForMaskedLM(config, dtype=dtype, device=device),
                     seed)
        opt = AdamW(learning_rate=lr, parameters=model.named_parameters(),
                    weight_decay=weight_decay,
                    multi_precision=dtype in (torch.bfloat16, torch.float16))
        return model, opt

    def step_fn(model, opt, ids, labels, segment_ids=None):
        opt.clear_grad()
        loss = model.compute_loss(ids, labels, segment_ids=segment_ids)
        loss.backward()
        opt.step()
        return loss.detach()

    return step_fn, init_fn
