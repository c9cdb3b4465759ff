"""An eager Llama training step written once against the Paddle surface.

The same code runs with either package; only the import differs:

    S = surface("paddle_tpu")          # the JAX package
    S = surface("paddle_tpu_torch")    # the PyTorch/CUDA port

``paddle.to_tensor``, ``Parameter``s, ``paddle.matmul``,
``F.embedding``, ``F.rms_norm``, the incubate
``fused_rotary_position_embedding``,
``F.scaled_dot_product_attention(is_causal=True)``, ``F.silu``,
``paddle.multiply``, ``F.cross_entropy``, ``loss.backward()``,
``ClipGradByGlobalNorm(1.0)``, ``AdamW.step()`` and ``clear_grad()``,
optionally under ``amp.auto_cast(level="O1", dtype="bfloat16")``.

Weights are the stacked Llama layout (``embed``, ``wq``..``w_down``,
``ln1``/``ln2`` with a leading layer axis, ``ln_f``, ``lm_head``), as
numpy arrays or the package's own tensors. The port's ``chip_smoke.py``
(phase 31) and ``tests/test_torch_eager_train.py`` drive it.
"""

from __future__ import annotations

import contextlib
import importlib
import types

import numpy as np

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1", "ln2")


def surface(package: str) -> types.SimpleNamespace:
    """The Paddle surface of ``package``: ``paddle`` and its ``F``
    (``nn.functional``), ``IF`` (``incubate.nn.functional``),
    ``optimizer`` and ``amp``."""
    def sub(name):
        return importlib.import_module(f"{package}.{name}")
    return types.SimpleNamespace(
        paddle=importlib.import_module(package), F=sub("nn.functional"),
        IF=sub("incubate.nn.functional"), optimizer=sub("optimizer"),
        amp=sub("amp"))


def make_parameters(S, stacked, n_layers: int) -> dict:
    """One ``Parameter`` per weight, named ``layers.<l>.<key>`` (the layer
    axis split off), ``embed``, ``ln_f`` and ``lm_head``."""
    P = S.paddle.Parameter
    params = {"embed": P(stacked["embed"], name="embed")}
    for l in range(n_layers):
        for k in LAYER_KEYS:
            name = f"layers.{l}.{k}"
            params[name] = P(stacked[k][l], name=name)
    params["ln_f"] = P(stacked["ln_f"], name="ln_f")
    params["lm_head"] = P(stacked["lm_head"], name="lm_head")
    return params


def rope_tables(S, seq: int, head_dim: int, theta: float = 10000.0):
    """(cos, sin), each (seq, head_dim), as the package's tensors."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    emb = np.outer(np.arange(seq, dtype=np.float32), inv).astype(np.float32)
    emb = np.concatenate([emb, emb], axis=-1)
    return S.paddle.to_tensor(np.cos(emb)), S.paddle.to_tensor(np.sin(emb))


def loss_fn(S, params, ids, labels, cfg, cos, sin):
    """Mean token cross-entropy of the decoder stack. ``cfg`` needs
    ``num_hidden_layers``, ``num_attention_heads``,
    ``num_key_value_heads``, ``hidden_size``, ``vocab_size`` and
    ``rms_norm_eps``."""
    paddle, F, IF = S.paddle, S.F, S.IF
    b, s = ids.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    eps = cfg.rms_norm_eps
    x = F.embedding(ids, params["embed"])
    for l in range(cfg.num_hidden_layers):
        def p(k):
            return params[f"layers.{l}.{k}"]
        xn = F.rms_norm(x, p("ln1"), eps)
        q = paddle.matmul(xn, p("wq")).reshape([b, s, nh, d])
        k = paddle.matmul(xn, p("wk")).reshape([b, s, nkv, d])
        v = paddle.matmul(xn, p("wv")).reshape([b, s, nkv, d])
        q, k, _ = IF.fused_rotary_position_embedding(q, k, None, sin=sin,
                                                     cos=cos)
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + paddle.matmul(a.reshape([b, s, nh * d]), p("wo"))
        xn = F.rms_norm(x, p("ln2"), eps)
        gate = F.silu(paddle.matmul(xn, p("w_gate")))
        up = paddle.matmul(xn, p("w_up"))
        x = x + paddle.matmul(paddle.multiply(gate, up), p("w_down"))
    xn = F.rms_norm(x, params["ln_f"], eps)
    logits = paddle.matmul(xn, params["lm_head"])
    return F.cross_entropy(logits.reshape([b * s, cfg.vocab_size]),
                           labels.reshape([b * s]))


def make_optimizer(S, params: dict, lr: float = 1e-3):
    return S.optimizer.AdamW(
        learning_rate=lr, parameters=list(params.values()),
        grad_clip=S.optimizer.ClipGradByGlobalNorm(1.0))


def forward_backward(S, params, ids, labels, cfg, cos, sin,
                     amp_level=None):
    """The loss (a 0-d Tensor) after ``loss.backward()``: every
    parameter holds its gradient."""
    ctx = (S.amp.auto_cast(level=amp_level, dtype="bfloat16")
           if amp_level else contextlib.nullcontext())
    with ctx:
        loss = loss_fn(S, params, ids, labels, cfg, cos, sin)
    loss.backward()
    return loss


def train_step(S, params, opt, ids, labels, cfg, cos, sin, amp_level=None):
    """One step: forward, backward, clipped AdamW update, gradients
    cleared. Returns the loss Tensor."""
    loss = forward_backward(S, params, ids, labels, cfg, cos, sin, amp_level)
    opt.step()
    opt.clear_grad()
    return loss
