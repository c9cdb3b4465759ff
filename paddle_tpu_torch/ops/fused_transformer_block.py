"""The fused transformer block — counterpart of
``paddle_tpu/ops/fused_transformer_block.py``: the activations, the
LayerNorm, the head split and the prefill attention that the encoder
layers use, and the decoder stack ``fused_multi_transformer_array`` with
its cached decode attention (``time_step``).

The reference scans the stacked per-layer weights (``lax.scan``); here
the stack is a Python loop over the layers, and ``params`` maps each key
to a stacked ``[L, ...]`` tensor or to a list of the L per-layer tensors
(the ``FusedMultiTransformer`` layer passes its own lists, so nothing is
stacked on a call). Prefill attention is the causal flash kernels
(``ops/flash_attention.py``), every LayerNorm the fused op
(``ops/layer_norm_fused.py``); the decode attention is the reference's
plain einsums over the whole cache slab. The KV cache is one tensor
``[L, 2, B, nh, S, hd]`` (k = 0, v = 1); a decode step writes its new
K/V into it in place at ``time_step`` (the reference returns an updated
copy), so a step never copies the cache.

The int8 stack (``int8=True``) runs its four projections through
:func:`_int8_mm`: activations quantized per token (or by a calibrated
``in_scale``), an int8×int8→int32 product, one fp32 dequantize
multiply. The reference leaves that product to XLA outside any Pallas
kernel, so it is a library call here: ``torch._int_mm`` (cuBLASLt's
int8 GEMM) on the card, an exact int32 product on the CPU. Both are
exact, so the card's int32 result is the CPU's bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import flash_attention as fa
from ._common import next_multiple, resolve_device, true_div
from .layer_norm_fused import _stats, layer_norm

#: ``jax.nn.gelu`` defaults to the tanh approximation; the reference's FFN
#: uses that default
_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def layer_norm_array(x, scale=None, bias=None, eps=1e-5):
    """fp32-accumulated LayerNorm over the last axis, output in
    ``x.dtype``. With both ``scale`` and ``bias`` it is the fused op
    (``ops/layer_norm_fused.py``: the Triton kernels for CUDA tensors);
    otherwise the plain form, scale and bias optional."""
    if scale is not None and bias is not None:
        # the kernel takes contiguous rows (a sliced input is copied)
        return layer_norm(x.contiguous(), scale, bias, eps)
    xf = x.float()
    mu, inv = _stats(xf, eps)
    y = (xf - mu) * inv
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _split_heads(qkv, num_heads):
    """(B, S, 3H) -> 3 × (B, nh, S, hd) views."""
    b, s, three_h = qkv.shape
    hd = three_h // 3 // num_heads
    qkv = qkv.reshape(b, s, 3, num_heads, hd)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _prefill_attention(q, k, v, attn_mask, causal=True, seg_ids=None):
    """(B, nh, S, hd) attention. Segment ids: the segment-masked flash
    kernels; no mask: the flash kernels; an additive mask: a plain
    einsum and softmax, as the JAX package computes it outside Pallas."""
    b, nh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    if seg_ids is not None:
        if attn_mask is not None:
            raise ValueError("seg_ids and attn_mask are mutually exclusive")
        return fa.flash_attention_segmented(q, k, v, seg_ids, scale=scale,
                                            causal=causal)
    if attn_mask is None:
        flat = (t.contiguous().reshape(b * nh, s, hd) for t in (q, k, v))
        out = fa.flash_attention_bhsd(*flat, scale, causal)
        return out.reshape(b, nh, s, hd)
    logits = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    if causal:
        tril = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tril, -math.inf)
    logits = logits + attn_mask.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bnkd->bnqd", p, v)


def _decode_attention(q, k_cache, v_cache, cur_len, seq_lens=None,
                      new_span=None):
    """Attention of the new tokens' queries q (B, nh, s, hd) over the
    whole cache slab (B, nh, Smax, hd) (l.103-128): scores in fp32,
    positions at or past ``cur_len`` masked with -inf, the softmax's
    probabilities cast to q's dtype for the product with the cache.

    ``seq_lens`` (B,) makes a ragged batch: a prefix position is valid
    below its row's own length, and the slots this step wrote
    (``new_span = (start, s)``) are valid for every row."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k_cache.float().transpose(-1, -2))
    logits = logits * scale
    pos = torch.arange(k_cache.shape[2], device=q.device)
    if seq_lens is None:
        valid = (pos < cur_len)[None, None, None, :]
    else:
        start, s = new_span
        prefix = pos[None, :] < seq_lens.to(q.device)[:, None]
        new = (pos >= start) & (pos < start + s)
        valid = (prefix | new[None, :])[:, None, None, :]
    logits = logits.masked_fill(~valid, -math.inf)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(p, v_cache)


def _update_slab(cache, new, start: int):
    """``lax.dynamic_update_slice_in_dim(cache, new, start, axis=2)`` in
    place: the start is clamped into ``[0, S - s]`` as XLA clamps it."""
    start = min(max(int(start), 0), cache.shape[2] - new.shape[2])
    cache[:, :, start:start + new.shape[2]] = new


def col_major(w):
    """``w`` (..., K, N) with the same values, laid out column-major in
    its last two dims: the layout the card's int8 GEMM takes at every
    row count (a row-major ``(K, N)`` operand is refused by cuBLASLt at
    some small shapes and runs ~5× slower at others). The buffer is
    zero-padded to K and N multiples of 8, which that GEMM needs, and
    the result is its ``[..., :K, :N]`` view: the shape and values are
    ``w``'s, and :func:`int32_product` takes the padded buffer whole."""
    k, n = w.shape[-2:]
    buf = w.new_zeros(w.shape[:-2] + (next_multiple(n, 8),
                                      next_multiple(k, 8)))
    buf[..., :n, :k] = w.transpose(-1, -2)
    return buf.transpose(-1, -2)[..., :k, :n]


def _padded_operand(wq, kp: int, np_: int):
    """The ``(kp, np_)`` column-major operand whose ``[:K, :N]`` is
    ``wq``: the buffer :func:`col_major` laid out (no copy), else a
    fresh one. What the operand holds past K and N does not matter: the
    activations' padded columns are zeros and the padded output columns
    are cut off."""
    fits = (wq.stride(0) == 1 and wq.stride(1) == kp
            and (wq.storage_offset() + kp * np_) * wq.element_size()
            <= wq.untyped_storage().nbytes())
    if not fits:
        wq = col_major(wq)
    return wq.as_strided((kp, np_), (1, kp))


def int32_product(xq, wq):
    """``xq (M, K) int8 @ wq (K, N) int8`` accumulated in int32, exact.
    On the card ``torch._int_mm``, which takes rows over 16 and K and N
    multiples of 8: the rows are zero-padded to a multiple of 8 of at
    least 24, K is zero-padded on both operands and N on the weight's
    columns (cut off after), so any shape runs and no padding changes a
    result. ``wq`` is taken column-major and padded as :func:`col_major`
    lays it out once (a weight laid out otherwise is copied so on each
    call). On the CPU an int32 matmul."""
    m, k = xq.shape
    n = wq.shape[1]
    if not xq.is_cuda:
        return xq.to(torch.int32) @ wq.to(torch.int32)
    kp, np_ = next_multiple(k, 8), next_multiple(n, 8)
    w = _padded_operand(wq, kp, np_)
    rows = next_multiple(max(m, 17), 8)
    if rows != m or kp != k:
        xq = F.pad(xq, (0, kp - k, 0, rows - m))
    y = torch._int_mm(xq.contiguous(), w)[:m]
    return y if np_ == n else y[:, :n].contiguous()


def _int8_mm(x, wq, w_scale, in_scale=None):
    """A8W8 product (l.131-151): x (..., K) float, wq (K, N) int8,
    w_scale (N,) per output channel. Activations are quantized per
    token (step ``max(amax, 1e-6) / 127``) unless a calibrated
    ``in_scale`` is given, the max-abs RANGE (step ``in_scale / 127``).
    int8×int8→int32 (:func:`int32_product`), then ``y · xs · w_scale``
    in fp32, in the reference's order."""
    xf = x.float()
    if in_scale is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        xs = torch.clamp(amax, min=1e-6)                    # (..., 1)
    else:
        xs = torch.as_tensor(in_scale, dtype=torch.float32, device=x.device)
    xs = true_div(xs, 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    y = int32_product(xq.reshape(-1, xq.shape[-1]), wq)
    y = y.reshape(xq.shape[:-1] + (wq.shape[1],))
    return y.float() * xs * w_scale


def _one_layer(x, p, *, num_heads, act, eps, attn_mask, kv_cache, time_step,
               seq_lens=None, mm=None):
    """One pre-LN decoder layer (l.154-185): LN, QKV, attention (causal
    flash prefill, or the cached decode over ``kv_cache = (k, v)``
    slabs, written in place at ``time_step``), out projection and
    residual, LN, FFN and residual. ``p`` maps the stacked keys
    (``ln_scale``, ``qkv_w``, ...) to this layer's tensors. Returns
    ``(y, (k, v))``: the updated slabs in decode, this layer's new K/V
    in prefill. ``mm(t, w_key, b_key)`` replaces the four projections
    (the int8 stack's :func:`_int8_mm`)."""
    if mm is None:
        def mm(t, wk, bk):
            return t @ p[wk] + p[bk]
    b, s, h = x.shape
    xn = layer_norm_array(x, p["ln_scale"], p["ln_bias"], eps)
    qkv = mm(xn, "qkv_w", "qkv_b")
    q, k, v = _split_heads(qkv, num_heads)
    if kv_cache is not None and time_step is not None:
        k_cache, v_cache = kv_cache
        _update_slab(k_cache, k, time_step)
        _update_slab(v_cache, v, time_step)
        attn = _decode_attention(q, k_cache, v_cache, time_step + s,
                                 seq_lens=seq_lens, new_span=(time_step, s))
        new_kv = (k_cache, v_cache)
    else:
        attn = _prefill_attention(q, k, v, attn_mask)
        new_kv = (k, v)
    attn = attn.transpose(1, 2).reshape(b, s, h)
    x = x + mm(attn, "out_w", "out_b").to(x.dtype)
    xn = layer_norm_array(x, p["ffn_ln_scale"], p["ffn_ln_bias"], eps)
    f = _ACTS[act](mm(xn, "ffn1_w", "ffn1_b"))
    x = x + mm(f, "ffn2_w", "ffn2_b").to(x.dtype)
    return x, new_kv


_KEYS = ("ln_scale", "ln_bias", "qkv_w", "qkv_b", "out_w", "out_b",
         "ffn_ln_scale", "ffn_ln_bias", "ffn1_w", "ffn1_b", "ffn2_w",
         "ffn2_b")
#: the int8 stack's projections: ``<w>_q``, ``<w>_scale`` and an optional
#: calibrated ``<w>_in_scale`` in place of each ``<w>``
_INT8_W = ("qkv_w", "out_w", "ffn1_w", "ffn2_w")


def _int8_keys(params) -> tuple:
    keys = [k for k in _KEYS if k not in _INT8_W]
    for w in _INT8_W:
        keys += [w + "_q", w + "_scale"]
        if w + "_in_scale" in params:
            keys.append(w + "_in_scale")
    return tuple(keys)


def fused_multi_transformer_array(
        x, params, *, num_heads: int, act: str = "gelu",
        epsilon: float = 1e-5, attn_mask=None, cache_kv=None,
        time_step: Optional[int] = None, max_cache_len: Optional[int] = None,
        seq_lens=None, int8: bool = False):
    """The whole decoder stack (l.188-251), one layer after the other.

    Prefill (``time_step`` None): causal flash attention (or the plain
    path under an additive ``attn_mask``); with ``max_cache_len`` (or a
    ``cache_kv``, whose length it takes) it returns a new KV cache, each
    layer's K/V in its leading slots and zeros after them. Decode
    (``time_step`` set): ``cache_kv`` is required and is updated IN
    PLACE, the new tokens' K/V written at ``time_step``; it is returned.

    ``int8=True`` (l.205-213): the projection weights arrive quantized,
    ``<w>_q`` int8 and ``<w>_scale`` per output channel, with optional
    calibrated ``<w>_in_scale`` (one per layer), and the four products
    run through :func:`_int8_mm`. Their fp32 outputs make q, k and v
    fp32 (the reference's promotion); a prefill's new cache then takes
    their dtype, as the reference's stacked K/V do.

    Returns ``(out, cache_kv)``, the cache ``[L, 2, B, nh, Sc, hd]`` or
    None when none was asked for."""
    keys = _int8_keys(params) if int8 else _KEYS
    n_layers = len(params["qkv_w_q" if int8 else "qkv_w"])

    def layer(i):
        return {key: params[key][i] for key in keys}

    def make_mm(p):
        if not int8:
            return None

        def mm(t, wk, bk):
            return _int8_mm(t, p[wk + "_q"], p[wk + "_scale"],
                            p.get(wk + "_in_scale")) + p[bk]

        return mm

    if time_step is not None:
        if cache_kv is None:
            raise ValueError("decode mode (time_step set) requires cache_kv")
        for i in range(n_layers):
            p = layer(i)
            x, _ = _one_layer(
                x, p, num_heads=num_heads, act=act, eps=epsilon,
                attn_mask=None, kv_cache=(cache_kv[i, 0], cache_kv[i, 1]),
                time_step=time_step, seq_lens=seq_lens, mm=make_mm(p))
        return x, cache_kv
    b, s, h = x.shape
    target = None
    if max_cache_len is not None or cache_kv is not None:
        target = max_cache_len or cache_kv.shape[4]
        if target < s:
            raise ValueError(f"sequence {s} exceeds cache length {target}")
    out_cache = None
    for i in range(n_layers):
        p = layer(i)
        x, (k, v) = _one_layer(
            x, p, num_heads=num_heads, act=act, eps=epsilon,
            attn_mask=attn_mask, kv_cache=None, time_step=None,
            mm=make_mm(p))
        if target is not None and out_cache is None:
            out_cache = k.new_zeros((n_layers, 2, b, num_heads, target,
                                     h // num_heads))
        if out_cache is not None:
            out_cache[i, 0, :, :, :s] = k
            out_cache[i, 1, :, :, :s] = v
    return x, out_cache


def init_stacked_block_params(num_layers, hidden, ffn_hidden, seed=0,
                              dtype=torch.float32, *, device=None):
    """The stacked parameter dict of the reference's convenience init
    (l.254): the same numpy draws (``RandomState(seed)``, normal 0.02),
    so fp32 weights are the reference's bits."""
    rng = np.random.RandomState(seed)
    dev = resolve_device(device)

    def w(*shape, scale=0.02):
        return torch.from_numpy(rng.normal(0, scale, shape)).to(
            device=dev, dtype=dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    L, H, Fh = num_layers, hidden, ffn_hidden
    return {
        "ln_scale": full((L, H), 1.0), "ln_bias": full((L, H), 0.0),
        "qkv_w": w(L, H, 3 * H), "qkv_b": full((L, 3 * H), 0.0),
        "out_w": w(L, H, H), "out_b": full((L, H), 0.0),
        "ffn_ln_scale": full((L, H), 1.0), "ffn_ln_bias": full((L, H), 0.0),
        "ffn1_w": w(L, H, Fh), "ffn1_b": full((L, Fh), 0.0),
        "ffn2_w": w(L, Fh, H), "ffn2_b": full((L, H), 0.0),
    }
