"""GPT family on the fused decoder stack — counterpart of
``paddle_tpu/models/gpt.py``: word + position embeddings, the
``FusedMultiTransformer`` stack (pre-LN, tanh GELU), a final LayerNorm
and an LM head tied to the word embedding.

The kernels on its path: the causal flash forward (prefill, training),
dQ and dK/dV (training) of ``ops/flash_attention.py``, and the
LayerNorm forward and backward of ``ops/layer_norm_fused.py`` (2L + 1 a
forward). The cached decode (``time_step``) is the reference's plain
slab attention. As in the reference, the model runs eagerly (no
compiled program, so no CUDA graph).

Parameter names are the JAX model's ``named_parameters()`` names and
weights keep its ``(in, out)`` layout, so the JAX package's weights
carry across by name (:func:`params_from_numpy`); :func:`init` redraws
seeded weights with the reference initialisers' distributions. Models
are built on ``device``: ``None`` means the card and raises without one;
pass ``device="cpu"`` for the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..incubate.nn.layer.fused_transformer import FusedMultiTransformer
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.common_layers import LayerNorm
from ..nn.common_layers import init_layers as init
from ..nn.common_layers import load_layer_state as params_from_numpy
from ..nn.layer import Layer
from ..ops._common import resolve_device


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu"


def gpt_tiny(**over) -> GPTConfig:
    base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64)
    base.update(over)
    return GPTConfig(**base)


class GPTEmbeddings(Layer):
    def __init__(self, config: GPTConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        h = config.hidden_size
        self.word_embeddings = nn.Parameter(
            torch.empty(config.vocab_size, h, **kw))
        self.position_embeddings = nn.Parameter(
            torch.empty(config.max_position_embeddings, h, **kw))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        """N(0, 0.02) draws: from ``gen`` (a ``torch.Generator``,
        ``init``'s), else from the framework key stream, as the
        reference's ``create_parameter`` draws them, so that every rank
        of a job builds the same tables."""
        for t in (self.word_embeddings, self.position_embeddings):
            if gen is not None:
                I.normal_(t, gen, 0.0, 0.02)
            else:
                with torch.no_grad():
                    t.copy_(I.Normal(0.0, 0.02)(tuple(t.shape), t.dtype,
                                                 device=t.device))

    def forward(self, input_ids, position_offset: int = 0):
        """Token rows plus the positions ``[offset, offset + s)``; the
        offset is clamped into the table as ``dynamic_slice_in_dim``
        clamps it."""
        s = input_ids.shape[-1]
        n = self.position_embeddings.shape[0]
        start = min(max(int(position_offset), 0), n - s)
        tok = self.word_embeddings[input_ids.long()]
        return tok + self.position_embeddings[start:start + s][None]


class GPTModel(Layer):
    """Embeddings → fused decoder stack → final LN."""

    def __init__(self, config: GPTConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.embeddings = GPTEmbeddings(config, dtype=dtype, device=device)
        self.decoder = FusedMultiTransformer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, activation=config.activation,
            normalize_before=True, epsilon=config.layer_norm_epsilon,
            num_layers=config.num_hidden_layers, dtype=dtype, device=device)
        self.final_layernorm = LayerNorm(config.hidden_size,
                                         epsilon=config.layer_norm_epsilon,
                                         dtype=dtype, device=device)

    def forward(self, input_ids, caches=None, time_step: Optional[int] = None,
                gen_cache_len: Optional[int] = None):
        x = self.embeddings(input_ids,
                            position_offset=time_step if time_step else 0)
        out = self.decoder(x, caches=caches, time_step=time_step,
                           gen_cache_len=gen_cache_len)
        if isinstance(out, tuple):
            h, kv = out
            return self.final_layernorm(h), kv
        return self.final_layernorm(out)


class GPTForCausalLM(Layer):
    """LM head tied to the word embedding (the reference's pretraining
    head)."""

    def __init__(self, config: GPTConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, dtype=dtype, device=device)

    def forward(self, input_ids, caches=None, time_step=None,
                gen_cache_len=None):
        out = self.gpt(input_ids, caches=caches, time_step=time_step,
                       gen_cache_len=gen_cache_len)
        kv = None
        if isinstance(out, tuple):
            out, kv = out
        logits = out @ self.gpt.embeddings.word_embeddings.t()
        return (logits, kv) if kv is not None else logits

    def compute_loss(self, input_ids, labels):
        """Mean fp32 cross-entropy over the positions not labelled
        -100."""
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 16,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy KV-cache generation: a host loop over the fused decode
        path (one prefill that builds a cache of ``t + max_new_tokens``
        slots, then one decode call a token), argmax of the fp32 logits.
        Returns (B, max_new_tokens) int32; with ``eos_token_id`` every
        token after a row's first EOS is set to EOS."""
        dev = self.gpt.embeddings.word_embeddings.device
        ids = torch.as_tensor(input_ids).to(dev)
        b, t = ids.shape
        cache_len = t + max_new_tokens
        if cache_len > self.config.max_position_embeddings:
            raise ValueError("generation exceeds max_position_embeddings")
        logits, kv = self(ids, gen_cache_len=cache_len)
        toks = [logits[:, -1].float().argmax(-1)]
        for i in range(max_new_tokens - 1):
            logits, kv = self(toks[-1][:, None], caches=kv, time_step=t + i)
            toks.append(logits[:, 0].float().argmax(-1))
        out = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
        if eos_token_id is not None:
            for r in range(out.shape[0]):
                hit = np.where(out[r] == eos_token_id)[0]
                if hit.size:
                    out[r, hit[0] + 1:] = eos_token_id
        return out
