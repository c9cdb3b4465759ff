"""Rotary position embedding — counterpart of ``paddle_tpu/ops/rope.py``.

NeoX/Llama half rotation, layout (B, S, H, D). Rope is plain elementwise
tensor code in both packages (no Pallas kernel replaces it): the math is
fp32 and the result is cast back to q/k's dtype.
"""

from __future__ import annotations

import torch

from ..core.dispatch import any_tensor, apply, unwrap
from ._common import resolve_device


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     dtype=torch.float32, position_offset: int = 0,
                     *, device=None):
    """(cos, sin), each (seq_len, head_dim), computed in fp32."""
    dev = resolve_device(device)
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=dev) / head_dim))
    t = torch.arange(position_offset, position_offset + seq_len,
                     dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope_array(q, k, cos, sin):
    """q, k: (B, S, H, D); cos/sin: (S, D) or (B, S, D)."""
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    qf = q.float()
    kf = k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def fused_rotary_position_embedding(q, k, cos, sin):
    """``fused_rotary_position_embedding`` (l.48): :func:`apply_rope_array`
    on (B, S, H, D) q and k; ``Tensor``s go through the dispatcher as op
    ``fused_rope``."""
    if any_tensor(q, k):
        cos_v, sin_v = unwrap(cos), unwrap(sin)
        return apply(lambda a, b: apply_rope_array(a, b, cos_v, sin_v), q, k,
                     op_name="fused_rope")
    return apply_rope_array(q, k, cos, sin)
