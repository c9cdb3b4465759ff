"""GPT-MoE — counterpart of ``paddle_tpu/models/gpt_moe.py``: decoder
blocks whose FFN is a ``MoELayer`` (the workload of ``BASELINE.md``'s
"GPT-MoE with Fleet expert parallel").

Pre-LN blocks: LayerNorm (row 8's kernels for CUDA tensors), causal
self-attention through ``nn.functional.scaled_dot_product_attention``
(rows 5 and 6 at head dims 64 and 128), LayerNorm, then the MoE FFN
(``incubate.distributed.models.moe.MoELayer``: the gather dispatch, or
the expert-parallel path over a multi-rank ``moe_group``), with a final
LayerNorm and an LM head tied to the word embedding. Parameter names and
``(in, out)`` layouts are the reference's, so its weights carry across
by name (``load_layer_state``). The model is built on ``device``:
``None`` is the place ``set_device`` set, else the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.dispatch import any_tensor, apply
from ..core.tensor import Tensor
from ..incubate.distributed.models.moe import MoELayer
from ..nn import functional as F
from ..nn.common_layers import GELU, LayerNorm, Linear, ReLU
from ..nn.initializer import init_device
from ..nn.layer import Layer, LayerList, Sequential
from .gpt import GPTConfig, GPTEmbeddings


@dataclass
class GPTMoEConfig(GPTConfig):
    num_experts: int = 8
    moe_topk: int = 2
    moe_gate: str = "gshard"
    capacity_factor: tuple = (1.2, 2.4)
    aux_loss_coef: float = 0.01
    # decoder layers using MoE FFN (every layer by default)
    moe_layer_interval: int = 1


def gpt_moe_tiny(**over) -> GPTMoEConfig:
    base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, num_experts=8, moe_topk=2)
    base.update(over)
    return GPTMoEConfig(**base)


class GPTSelfAttention(Layer):
    def __init__(self, config: GPTMoEConfig, *, dtype=None, device=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        kw = dict(dtype=dtype, device=device)
        self.qkv = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape([b, s, 3, self.num_heads,
                                   h // self.num_heads])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(out.reshape([b, s, h]))


def _expert_ffn(config: GPTMoEConfig, **kw) -> Layer:
    act = {"gelu": GELU, "relu": ReLU}[config.activation]
    return Sequential(Linear(config.hidden_size, config.intermediate_size,
                             **kw),
                      act(),
                      Linear(config.intermediate_size, config.hidden_size,
                             **kw))


class GPTMoEBlock(Layer):
    def __init__(self, config: GPTMoEConfig, use_moe: bool, moe_group=None,
                 *, dtype=None, device=None):
        super().__init__()
        eps = config.layer_norm_epsilon
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTSelfAttention(config, **kw)
        self.ln2 = LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.use_moe = use_moe
        if use_moe:
            self.mlp = MoELayer(
                config.hidden_size,
                experts=[_expert_ffn(config, **kw)
                         for _ in range(config.num_experts)],
                gate=config.moe_gate, topk=config.moe_topk,
                capacity_factor=config.capacity_factor,
                moe_group=moe_group, **kw)
        else:
            self.mlp = _expert_ffn(config, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class GPTMoEForCausalLM(Layer):
    """GPT with MoE FFN layers; the LM head tied to the word embedding.

    ``moe_group``: the group the experts split over (the Fleet
    expert-parallel group); None = the gather path on one rank."""

    def __init__(self, config: GPTMoEConfig, moe_group=None, *, dtype=None,
                 device=None):
        super().__init__()
        device = init_device(device)
        kw = dict(dtype=dtype, device=device)
        self.config = config
        self.embeddings = GPTEmbeddings(
            config, dtype=dtype or torch.float32, device=device)
        self.blocks = LayerList([
            GPTMoEBlock(config, use_moe=(i % config.moe_layer_interval == 0),
                        moe_group=moe_group, **kw)
            for i in range(config.num_hidden_layers)])
        self.final_layernorm = LayerNorm(
            config.hidden_size, epsilon=config.layer_norm_epsilon, **kw)

    def _run(self, fn, *args):
        """``fn`` over torch tensors; Tensors in, a Tensor out (through
        the dispatcher, with the parameters as inputs so that the result
        carries their gradients)."""
        self._tensor_io = any_tensor(*args)
        if self._tensor_io:
            return apply(lambda *v: fn(*v[:len(args)]), *args,
                         *self.parameters(), op_name="gpt_moe")
        return fn(*args)

    def _hidden(self, input_ids):
        x = self.embeddings(input_ids)
        for blk in self.blocks:
            x = blk(x)
        return self.final_layernorm(x)

    def _logits(self, input_ids):
        return self._hidden(input_ids) @ self.embeddings.word_embeddings.t()

    def _aux(self):
        total = None
        for blk in self.blocks:
            la = getattr(blk.mlp, "l_aux", None)
            if la is not None:
                total = la if total is None else total + la
        return total

    def _loss(self, input_ids, labels):
        logits = self._logits(input_ids)
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)
        aux = self._aux()
        if aux is not None and self.config.aux_loss_coef:
            loss = loss + self.config.aux_loss_coef * aux
        return loss

    def forward(self, input_ids):
        return self._run(self._hidden, input_ids)

    def logits(self, input_ids):
        return self._run(self._logits, input_ids)

    def aux_loss(self):
        """The blocks' ``l_aux`` summed, of the last forward (a Tensor
        after a Tensor forward)."""
        aux = self._aux()
        if aux is not None and getattr(self, "_tensor_io", False):
            return Tensor._wrap(aux, not aux.requires_grad)
        return aux

    def compute_loss(self, input_ids, labels):
        return self._run(self._loss, input_ids, labels)
