"""Llama family, serving side — counterpart of ``paddle_tpu/models/llama.py``.

Weights use the JAX package's stacked layout (per-layer tensors stacked
on a leading L axis) and its ``x @ W`` orientation (``wq`` is
``(L, h, h)``, ``lm_head`` is ``(h, V)``), so weights made by the JAX
package carry across as a plain copy (:func:`params_from_numpy`).

Decoder math follows Llama-2: RMSNorm → QKV (GQA) → RoPE → attention →
out-proj → residual; RMSNorm → SwiGLU MLP → residual. The projections
and ``lm_head`` are plain large products (``torch.matmul``), as the JAX
package leaves them to XLA; RMSNorm and the ragged paged attention are
the kernels (``ops/rms_norm.py``, ``ops/paged_attention.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import paged_attention as pa
from ..ops import rope as rope_ops
from ..ops._common import resolve_device
from ..ops.rms_norm import rms_norm

#: per-layer tensors in the stacked layout (leading L axis)
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1", "ln2")


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama2_7b(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32), **over})


def llama_tiny(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=4), **over})


def param_count(config: LlamaConfig) -> int:
    """Parameter count of the stacked layout (embed + L decoder layers +
    final norm + lm_head)."""
    L, h, m = (config.num_hidden_layers, config.hidden_size,
               config.intermediate_size)
    kvh = config.num_key_value_heads * config.head_dim
    per_layer = 2 * h * h + 2 * h * kvh + 3 * h * m + 2 * h
    return (config.vocab_size * h + L * per_layer + h
            + h * config.vocab_size)


def _param_shapes(config: LlamaConfig) -> Dict[str, tuple]:
    L, h, m = (config.num_hidden_layers, config.hidden_size,
               config.intermediate_size)
    kvh = config.num_key_value_heads * config.head_dim
    V = config.vocab_size
    return {
        "embed": (V, h), "wq": (L, h, h), "wk": (L, h, kvh),
        "wv": (L, h, kvh), "wo": (L, h, h), "w_gate": (L, h, m),
        "w_up": (L, h, m), "w_down": (L, m, h), "ln1": (L, h),
        "ln2": (L, h), "ln_f": (h,), "lm_head": (h, V),
    }


def init_params(config: LlamaConfig, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Seeded random weights in the stacked layout (normal, std 0.02;
    norms at one), made on ``device`` by a ``torch.Generator``. Bits
    differ from the JAX package's ``init_stacked_params``: the tests
    carry JAX-made weights across with :func:`params_from_numpy`.
    Stacked tensors are filled one layer at a time, so the fp32 scratch
    is one layer's slice, not a whole 7B-sized stack."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {}
    for name, shape in _param_shapes(config).items():
        if name in ("ln1", "ln2", "ln_f"):
            params[name] = torch.ones(shape, dtype=config.dtype, device=dev)
            continue
        out = torch.empty(shape, dtype=config.dtype, device=dev)
        for part in (out if name in LAYER_KEYS else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * 0.02)
        params[name] = out
    return params


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(np_params: Dict[str, Any], config: LlamaConfig,
                      device=None) -> Dict[str, torch.Tensor]:
    """Carry stacked weights across from numpy (e.g. ``np.asarray`` of
    each leaf of the JAX package's ``init_stacked_params``): same keys,
    same layout, a plain copy onto ``device`` in ``config.dtype``."""
    dev = resolve_device(device)
    shapes = _param_shapes(config)
    out = {}
    for k, v in np_params.items():
        _check_dense({k: v})
        t = _to_tensor(np.asarray(v))
        if k in shapes and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, expected "
                             f"{shapes[k]}")
        out[k] = t.to(device=dev, dtype=config.dtype)
    return out


@functools.lru_cache(maxsize=8)
def _rope_cache(s_max: int, head_dim: int, theta: float, device: str):
    return rope_ops.build_rope_cache(s_max, head_dim, theta, device=device)


def _check_dense(params) -> None:
    for k, v in params.items():
        if isinstance(v, dict):
            raise NotImplementedError(
                f"{k}: weight-only int8 leaves ({{'q', 'scale'}}) come "
                "with the quantization slice")


@torch.no_grad()
def ragged_step(params, ids, token_row, positions, kv_lens, last_idx,
                k_pages, v_pages, block_tables, config: LlamaConfig):
    """One forward over a RAGGED packed token batch — the unified model
    step behind the engine's serving loop (``llama.ragged_step``).

    Every live row contributes a span of the flat token axis (a decode
    row its one new token, a prefill row the next chunk of its prompt).
    Rope is taken at each token's absolute position, K/V are scattered
    into the row's pages, and attention is the ragged paged kernel's
    one mask rule ``key_pos <= position``.

    ids:       (T,) int packed tokens (pad slots: any valid id)
    token_row: (T,) int32 owning row per token; -1 = pad slot
    positions: (T,) int32 absolute KV position per token
    kv_lens:   (R,) int32 per-row attendable span this call (0 = idle)
    last_idx:  (C,) int flat token indices to take logits at
    k_pages/v_pages: (L, P, page, nkv, d); block_tables: (R, max_pages)
    Returns (logits (C, V), k_pages, v_pages).

    The port updates the pools IN PLACE (the returned pools are the
    arguments) where the JAX function returns new arrays.
    """
    _check_dense(params)
    t = ids.shape[0]
    d = config.head_dim
    eps = config.rms_norm_eps
    page = k_pages.shape[2]
    n_rows, width = block_tables.shape
    s_max = width * page
    cos_full, sin_full = _rope_cache(s_max, d, float(config.rope_theta),
                                     str(ids.device))
    # clamp: over-decoded tokens past the table span land in the last
    # slot (their outputs are trimmed by the host); rope, the scatter and
    # the attention mask all use the clamped position
    pos_c = positions.clamp(max=s_max - 1)
    pos_l = pos_c.long()
    cos = cos_full[pos_l][None]                            # (1, T, d)
    sin = sin_full[pos_l][None]
    x = params["embed"][ids.long()][None]                  # (1, T, h)

    valid = token_row >= 0
    row_c = token_row.long().clamp(0, n_rows - 1)
    phys = block_tables.reshape(-1).long()[row_c * width + pos_l // page]
    phys = torch.where(valid, phys, torch.zeros_like(phys))  # pads -> page 0
    page_off = pos_l % page
    scale = 1.0 / math.sqrt(d)

    for l in range(config.num_hidden_layers):
        kp, vp = k_pages[l], v_pages[l]                    # views, in place
        xn = rms_norm(x, params["ln1"][l], eps)
        q = (xn @ params["wq"][l]).reshape(1, t, -1, d)
        k = (xn @ params["wk"][l]).reshape(1, t, -1, d)
        v = (xn @ params["wv"][l]).reshape(1, t, -1, d)
        q, k = rope_ops.apply_rope_array(q, k, cos, sin)
        # scatter FIRST: every token attends through the page gather,
        # its own fresh K/V included
        kp[phys, page_off] = k[0].to(kp.dtype)
        vp[phys, page_off] = v[0].to(vp.dtype)
        attn = pa.ragged_paged_attention(
            q[0].contiguous(), kp, vp, block_tables, token_row, pos_c,
            kv_lens, scale=scale)                          # (T, nh, d)
        xo = x + (attn.reshape(1, t, -1) @ params["wo"][l]
                  ).to(x.dtype)
        xn2 = rms_norm(xo, params["ln2"][l], eps)
        g = xn2 @ params["w_gate"][l]
        u = xn2 @ params["w_up"][l]
        xo = xo + (F.silu(g) * u) @ params["w_down"][l]
        x = xo.to(x.dtype)

    x = rms_norm(x, params["ln_f"], eps)
    # lm_head over ONLY the requested rows: (C, h) @ (h, V)
    h_last = x[0][last_idx.long()]
    logits = h_last @ params["lm_head"]
    return logits, k_pages, v_pages
