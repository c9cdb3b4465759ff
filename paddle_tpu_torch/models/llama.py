"""Llama family — counterpart of ``paddle_tpu/models/llama.py``: the
unified serving step, the legacy paged pipeline (bucketed prefill,
prefix-cache suffix prefill, ragged decode step), the contiguous-cache
prefill and decode step of ``GenerationEngine``, the one-device
training step, the hybrid step over a process mesh
(``build_hybrid_train_step``, one rank a process, l.285-921), and the
imperative ``LlamaForCausalLM`` (l.93-191) that main-grad training and
the Fleet path drive.

Weights use the JAX package's stacked layout (per-layer tensors stacked
on a leading L axis) and its ``x @ W`` orientation (``wq`` is
``(L, h, h)``, ``lm_head`` is ``(h, V)``), so weights made by the JAX
package carry across as a plain copy (:func:`params_from_numpy`).

The imperative model is a ``Layer`` over the ``meta_parallel`` layers
(split over the mp group as the reference's, l.93-141) whose parameter
names are the JAX model's
``named_parameters()`` names (``llama.layers.0.self_attn.q_proj.weight``,
…), with the same ``(in, out)`` weights, so the JAX model's weights carry
across by name (:func:`load_layer_state`).

Decoder math follows Llama-2: RMSNorm → QKV (GQA) → RoPE → attention →
out-proj → residual; RMSNorm → SwiGLU MLP → residual. The projections
and ``lm_head`` are plain large products (``torch.matmul``), as the JAX
package leaves them to XLA. The kernels: RMSNorm forward and backward
(``ops/rms_norm.py``), the ragged paged attention of the unified step
and the paged decode attention of the legacy decode step
(``ops/paged_attention.py``), and the causal flash attention forward
(training and the legacy full prefill) and backward
(``ops/flash_attention.py``).

A projection weight may be a weight-only int8 leaf ``{"q", "scale"}``
(``quantization.quantize_stacked_params``): :func:`_dense` dequantizes
it to fp32 where the reference does, and :func:`_mm_prefill` runs the
A8W8 product (``ops.fused_transformer_block._int8_mm``) where the
reference does, under ``FLAGS_serving_a8w8_prefill``. A dequantized
weight is fp32, so such a projection computes in fp32 (the reference's
promotion) and the residual carry keeps its dtype where the reference
casts it back.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..distributed.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from ..nn import functional as NF
from ..nn.common_layers import (  # noqa: F401
    RMSNorm, init_layers, load_layer_state, to_tensor)
from ..nn.layer import Layer, LayerList
from ..flags import flag_value
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa
from ..ops import rope as rope_ops
from ..ops._common import resolve_device, true_div
from ..ops.fused_transformer_block import _int8_mm, col_major, int32_product
from ..ops.rms_norm import rms_norm
from ..optimizer.adamw import adamw_update_

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
    # the JAX package's config fields, kept so a journal head frame (and
    # its replay) carries the same config: no port path reads them yet
    # (rope tables are sized by their callers; no sequence parallelism)
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.float32
    sep_mode: str = "ulysses"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama2_7b(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32), **over})


def llama2_13b(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
        num_attention_heads=40, num_key_value_heads=40), **over})


def llama_tiny(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=4, max_position_embeddings=128), **over})


def param_count(config: LlamaConfig) -> int:
    """Parameter count of the stacked layout (embed + L decoder layers +
    final norm + lm_head)."""
    L, h, m = (config.num_hidden_layers, config.hidden_size,
               config.intermediate_size)
    kvh = config.num_key_value_heads * config.head_dim
    per_layer = 2 * h * h + 2 * h * kvh + 3 * h * m + 2 * h
    return (config.vocab_size * h + L * per_layer + h
            + h * config.vocab_size)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def param_nbytes(config: LlamaConfig) -> int:
    """Device bytes the stacked weights occupy at ``config.dtype``: the
    ``weight_bytes`` input of the capacity planner
    (``observability.memory.plan_capacity``)."""
    return param_count(config) * _itemsize(config.dtype)


def kv_geometry(config: LlamaConfig, page_size: int) -> Dict[str, int]:
    """The paged-KV geometry keywords of the capacity planner: what a
    page of this model costs."""
    return {
        "num_layers": config.num_hidden_layers,
        "num_kv_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
        "page_size": page_size,
        "dtype_bytes": _itemsize(config.dtype),
    }


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


def init_stacked_params(config: LlamaConfig, seed: int = 0, *,
                        device=None) -> Dict[str, torch.Tensor]:
    """The reference's seeded weights (l.222): ``jax.random.key(seed)``
    split twelve ways, normal(0, 0.02) draws in fp32 cast to
    ``config.dtype``, norms at one. The draws run on the port's Threefry
    stream (``random.normal_draw``), equal to the reference's to an ulp
    of XLA's ``erfinv``. (:func:`init_params` draws from a
    ``torch.Generator``.)"""
    from .. import random as R
    from ..inference import prng
    dev = resolve_device(device)
    dt = config.dtype
    ks = prng.split(prng.prng_key(seed), 12)
    shapes = _param_shapes(config)
    drawn = ("embed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
             "lm_head")                           # keys ks[0] .. ks[8]
    out = {k: (R.normal_draw(ks[i], shapes[k], device=dev) * 0.02).to(dt)
           for i, k in enumerate(drawn)}
    return {k: out[k] if k in out
            else torch.ones(shapes[k], dtype=dt, device=dev)
            for k in shapes}


def params_from_numpy(np_params: Dict[str, Any], config: LlamaConfig,
                      device=None) -> Dict[str, torch.Tensor]:
    """Carry stacked weights across from numpy (e.g. ``np.asarray`` of
    each leaf of the JAX package's ``init_stacked_params``): same keys,
    same layout, a plain copy onto ``device`` in ``config.dtype``. A
    weight-only int8 leaf ``{"q", "scale"}`` carries across as int8 and
    fp32 (:func:`place_int8`)."""
    dev = resolve_device(device)
    shapes = _param_shapes(config)
    out = {}
    for k, v in np_params.items():
        if isinstance(v, dict):
            q = to_tensor(np.asarray(v["q"]))
            if k in shapes and tuple(q.shape) != shapes[k]:
                raise ValueError(f"{k}: shape {tuple(q.shape)}, expected "
                                 f"{shapes[k]}")
            out[k] = place_int8({"q": q,
                                 "scale": to_tensor(np.asarray(v["scale"]))},
                                dev)
            continue
        t = to_tensor(np.asarray(v))
        if k in shapes and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, expected "
                             f"{shapes[k]}")
        out[k] = t.to(device=dev, dtype=config.dtype)
    return out


# unbounded: a serving engine's CUDA graphs read these tables at the
# addresses they captured, so no entry may be evicted and freed under a
# live graph (the keys are few: table spans and power-of-two buckets)
@functools.lru_cache(maxsize=None)
def _rope_cache(s_max: int, head_dim: int, theta: float, device: str):
    return rope_ops.build_rope_cache(s_max, head_dim, theta, device=device)


def place_int8(w, device) -> Dict[str, torch.Tensor]:
    """An int8 leaf on ``device``: ``q`` int8 (column-major on the card,
    the layout its int8 GEMM takes: ``ops.fused_transformer_block.
    col_major``) and ``scale`` fp32, never cast to the model's dtype."""
    q = w["q"].to(device=device, dtype=torch.int8)
    return {"q": col_major(q) if q.is_cuda else q,
            "scale": w["scale"].to(device=device, dtype=torch.float32)}


def _check_real(params) -> None:
    """A train step differentiates every leaf: an int8 leaf has no
    gradient, and the reference's ``jax.value_and_grad`` refuses it
    (a ``TypeError`` too)."""
    for k, v in params.items():
        if isinstance(v, dict):
            raise TypeError(
                f"{k}: a train step takes real-valued leaves; the weight-"
                f"only int8 leaf {{'q', 'scale'}} has no gradient")


def _layer_w(params, key: str, l: int):
    """Layer ``l``'s weight ``key``: a tensor, or an int8 leaf's layer
    ``{"q": (in, out), "scale": (out,)}``."""
    w = params[key]
    if isinstance(w, dict):
        return {"q": w["q"][l], "scale": w["scale"][l]}
    return w[l]


def _dense(w):
    """A possibly weight-only-quantized weight in its dense form (l.356):
    an int8 leaf dequantizes to fp32
    (``quantization.weight_dequantize``); a tensor passes through."""
    if isinstance(w, dict):
        from ..quantization import weight_dequantize
        return weight_dequantize(w["q"], w["scale"])
    return w


def _mm(x, w):
    """``x @ _dense(w)``, in the promoted dtype when they differ (an fp32
    dequantized weight makes a bf16 product fp32, as ``jnp.einsum``
    promotes)."""
    w = _dense(w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def _a8w8(x, w) -> bool:
    """Whether ``_mm_prefill(x, w)`` takes the A8W8 product: an int8
    leaf of one layer, ``FLAGS_serving_a8w8_prefill`` on, and more than
    one row in dim -2 (the flat token count of a ragged step; t == 1 is
    the decode shape, which stays weight-only)."""
    return (isinstance(w, dict) and bool(flag_value("serving_a8w8_prefill"))
            and w["q"].dim() == 2 and x.dim() >= 2 and x.shape[-2] > 1)


def _mm_prefill(x, w):
    """The prefill-side product ``x @ w`` (l.369): the A8W8
    int8×int8→int32 product with per-token activation scales where
    :func:`_a8w8` says so, else :func:`_mm`."""
    if _a8w8(x, w):
        return _int8_mm(x, w["q"], w["scale"])
    return _mm(x, w)


@torch.no_grad()
def ragged_step(params, ids, token_row, positions, kv_lens, last_idx,
                k_pages, v_pages, block_tables, config: LlamaConfig,
                mesh=None, mp_axis: str = "mp", logits_epilogue=None, *,
                decoding=None):
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
    last_idx:  (C,) int flat token indices to take logits at: one per
               row (each row's last token) for the unified engine, one
               per candidate (C == R * (k+1)) for the speculative one
    k_pages/v_pages: (L, P, page, nkv, d); block_tables: (R, max_pages)
    logits_epilogue: optional hook over the (C, V) logits, applied last
               (the engine's grammar mask, before any sampling)
    decoding:  optional (T,) bool, True at the tokens that decode (a
               carry, a drafted token): the attention kernels' route
               follows the token (``ops.paged_attention.
               ragged_paged_attention_kernel``), so each token's bits do
               not depend on the packing and a speculative span's tokens
               equal the same tokens decoded one a round
    Returns (logits (C, V), k_pages, v_pages).

    The port updates the pools IN PLACE (the returned pools are the
    arguments) where the JAX function returns new arrays.

    Tensor-parallel serving (``mesh``, a ``parallel.mesh.ServingMesh``
    whose ``mp_axis`` degree is above 1; l.1205-1291): ``params`` is
    :func:`shard_params_tp`'s list of per-chip dicts and the pools are
    the manager's ``ops.paged_attention.HeadShards``
    (``PagedKVCacheManager.shard_heads``). Each chip projects its own
    heads, scatters its K/V into its own pool slab and runs attention on
    its heads (:func:`_ragged_step_tp`); ``wo`` and ``w_down`` give fp32
    partials that ``parallel.mesh.serving_all_reduce`` sums. A degree-1
    mesh runs the one-chip step.
    """
    if mesh is not None and mesh.shape.get(mp_axis, 1) > 1:
        return _ragged_step_tp(params, ids, token_row, positions, kv_lens,
                               last_idx, k_pages, v_pages, block_tables,
                               config, mesh, mp_axis, logits_epilogue,
                               decoding)
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
        q = _mm_prefill(xn, _layer_w(params, "wq", l)).reshape(1, t, -1, d)
        k = _mm_prefill(xn, _layer_w(params, "wk", l)).reshape(1, t, -1, d)
        v = _mm_prefill(xn, _layer_w(params, "wv", l)).reshape(1, t, -1, d)
        q, k = rope_ops.apply_rope_array(q, k, cos, sin)
        # scatter FIRST: every token attends through the page gather,
        # its own fresh K/V included
        kp[phys, page_off] = k[0].to(kp.dtype)
        vp[phys, page_off] = v[0].to(vp.dtype)
        # the kernel takes q in the pool's dtype (an int8 model's fp32 q
        # is rounded to a bf16 pool's here)
        attn = pa.ragged_paged_attention(
            q[0].to(kp.dtype).contiguous(), kp, vp, block_tables,
            token_row, pos_c, kv_lens, scale=scale,
            decoding=decoding)                             # (T, nh, d)
        xo = x + _mm_prefill(attn.reshape(1, t, -1),
                             _layer_w(params, "wo", l)).to(x.dtype)
        xn2 = rms_norm(xo, params["ln2"][l], eps)
        g = _mm_prefill(xn2, _layer_w(params, "w_gate", l))
        u = _mm_prefill(xn2, _layer_w(params, "w_up", l))
        xo = xo + _mm(F.silu(g) * u, _layer_w(params, "w_down", l))
        x = xo.to(x.dtype)

    x = rms_norm(x, params["ln_f"], eps)
    # lm_head over ONLY the requested rows: (C, h) @ (h, V)
    h_last = x[0][last_idx.long()]
    logits = _mm(h_last, params["lm_head"])
    if logits_epilogue is not None:
        logits = logits_epilogue(logits)
    return logits, k_pages, v_pages


def _partial_mm(a, w):
    """``a @ w`` as an fp32 partial (a row-parallel product, summed over
    the chips before its one rounding): ``torch.mm(..., out_dtype=fp32)``
    for 16-bit operands on the card, the fp32 product of their values on
    the CPU. An int8 leaf is dequantized (:func:`_mm`)."""
    if isinstance(w, dict) or a.dtype == torch.float32:
        return _mm(a, w).float()
    if a.is_cuda:
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


def _ragged_step_tp(chip_params, ids, token_row, positions, kv_lens,
                    last_idx, k_pages, v_pages, block_tables,
                    config: LlamaConfig, mesh, mp_axis: str,
                    logits_epilogue, decoding):
    """:func:`ragged_step` over a serving mesh (its docstring). The work
    that the reference replicates (the embedding, the norms, the logits)
    runs once on each device that holds chips (on logical chips that
    share a card, once); the logits are the first chip's.

    Where the bits can differ from the one-chip step: ``wo`` and
    ``w_down`` sum the chips' fp32 partials in chip order before their
    one rounding, where one GEMM rounds its own fp32 accumulation once;
    the column-parallel products are narrower GEMMs, which cuBLAS may
    run with another kernel or split; and row 3 picks its key split
    from the chip's head counts (``ops.paged_attention.ragged_split``).
    In fp32 each is a sum in another order; in bf16 such a sum may round
    the other way by a step (``testing.TP_SERVE_TOL`` has the sizes
    measured at Llama-2-7B widths)."""
    from ..parallel.mesh import serving_all_reduce
    n = mesh.shape[mp_axis]
    devs = mesh.devices.reshape(-1).tolist()
    if not isinstance(chip_params, (list, tuple)) or len(chip_params) != n:
        raise ValueError(f"a step over {n} chips takes shard_params_tp's "
                         f"{n} per-chip param dicts")
    ks, vs = k_pages.slabs, v_pages.slabs
    t = ids.shape[0]
    d = config.head_dim
    eps = config.rms_norm_eps
    page = ks[0].shape[2]
    n_rows, width = block_tables.shape
    s_max = width * page
    scale = 1.0 / math.sqrt(d)
    pos_c = positions.clamp(max=s_max - 1)
    pos_l = pos_c.long()
    valid = token_row >= 0
    row_c = token_row.long().clamp(0, n_rows - 1)
    phys = block_tables.reshape(-1).long()[row_c * width + pos_l // page]
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    page_off = pos_l % page
    # the first chip on each device: it holds the device's replica
    first: Dict[Any, int] = {}
    for c, dev in enumerate(devs):
        first.setdefault(dev, c)
    geo = {}
    for dev in first:
        cos_full, sin_full = _rope_cache(s_max, d, float(config.rope_theta),
                                         str(dev))
        pl = pos_l.to(dev)
        geo[dev] = (cos_full[pl][None], sin_full[pl][None], phys.to(dev),
                    page_off.to(dev))
    x = chip_params[0]["embed"][ids.long().to(devs[0])][None]   # (1, T, h)
    dtype = x.dtype
    xs = {dev: x.to(dev) for dev in first}

    def all_reduce_add(parts, base):
        sums = serving_all_reduce(parts)
        return {dev: base[dev] + sums[c].to(dtype)[None]
                for dev, c in first.items()}

    for l in range(config.num_hidden_layers):
        xn = {dev: rms_norm(xs[dev], chip_params[c]["ln1"][l], eps)
              for dev, c in first.items()}
        qs = []
        for c, (p, dev) in enumerate(zip(chip_params, devs)):
            cos, sin, ph, off = geo[dev]
            q = _mm_prefill(xn[dev], _layer_w(p, "wq", l)).reshape(1, t, -1, d)
            k = _mm_prefill(xn[dev], _layer_w(p, "wk", l)).reshape(1, t, -1, d)
            v = _mm_prefill(xn[dev], _layer_w(p, "wv", l)).reshape(1, t, -1, d)
            q, k = rope_ops.apply_rope_array(q, k, cos, sin)
            kp, vp = ks[c][l], vs[c][l]                    # views, in place
            kp[ph, off] = k[0].to(kp.dtype)
            vp[ph, off] = v[0].to(vp.dtype)
            qs.append(q[0].to(kp.dtype).contiguous())
        attn = pa.ragged_paged_attention_chips(
            qs, [kp[l] for kp in ks], [vp[l] for vp in vs], block_tables,
            token_row, pos_c, kv_lens, scale, decoding=decoding)
        wo = [_layer_w(p, "wo", l) for p in chip_params]
        a2 = [a.reshape(t, -1) for a in attn]
        if _a8w8(a2[0], wo[0]):
            xo = _all_reduce_a8w8(a2, wo, xs, first, dtype)
        else:
            xo = all_reduce_add([_partial_mm(a, w) for a, w in zip(a2, wo)],
                                xs)
        xn2 = {dev: rms_norm(xo[dev], chip_params[c]["ln2"][l], eps)
               for dev, c in first.items()}
        parts = []
        for p, dev in zip(chip_params, devs):
            g = _mm_prefill(xn2[dev][0], _layer_w(p, "w_gate", l))
            u = _mm_prefill(xn2[dev][0], _layer_w(p, "w_up", l))
            parts.append(_partial_mm(F.silu(g) * u,
                                     _layer_w(p, "w_down", l)))
        xs = all_reduce_add(parts, xo)

    x = rms_norm(xs[devs[0]], chip_params[0]["ln_f"], eps)
    h_last = x[0][last_idx.long().to(devs[0])]
    logits = _mm(h_last, chip_params[0]["lm_head"])
    if logits_epilogue is not None:
        logits = logits_epilogue(logits)
    return logits, k_pages, v_pages


def _all_reduce_a8w8(parts, ws, base, first, dtype):
    """The row-parallel A8W8 product ``wo`` over a serving mesh, as the
    reference's sharded ``_int8_mm`` computes it: each token's
    activation scale from the abs-max over ALL the chips' columns, each
    chip's int8×int8→int32 partial, the int32 sum (exact, so the result
    is the one-chip product's bits), then the dequantize multiply with
    the replicated ``scale``. Returns ``{device: base + result}``."""
    from ..parallel.mesh import serving_all_reduce
    dev0 = parts[0].device
    amax = torch.stack([a.float().abs().amax(dim=-1, keepdim=True).to(dev0)
                        for a in parts]).amax(dim=0)
    xs0 = true_div(torch.clamp(amax, min=1e-6), 127.0)   # (T, 1)
    y = []
    for a, w in zip(parts, ws):
        xs = xs0.to(a.device)
        xq = torch.clamp(torch.round(a.float() / xs), -127, 127).to(
            torch.int8)
        y.append(int32_product(xq, w["q"]))
    sums = serving_all_reduce(y)
    return {dev: base[dev] + (sums[c].float() * xs0.to(dev)
                              * ws[c]["scale"]).to(dtype)[None]
            for dev, c in first.items()}


# ---------------------------------------------------------------------------
# The legacy paged pipeline: bucketed prefill waves and the decode step
# ---------------------------------------------------------------------------

def _paged_prefill_layer(params, l, x, cos, sin, phys, page_off, k_pages,
                         v_pages, attn_fn, scatter_first: bool,
                         config: LlamaConfig):
    """One decoder layer of a paged prefill — the body shared by the full
    path (:func:`prefill_paged`) and the prefix-cache suffix path
    (:func:`prefill_paged_suffix`). They differ only in attention
    (``attn_fn(q, k, v, kp, vp)``: in-prompt causal vs a page gather at
    offset positions) and in whether the K/V scatter into layer ``l``'s
    pool (in place) must precede it: the suffix attends THROUGH the
    pool, so its keys must land there first."""
    b, t, _ = x.shape
    d = config.head_dim
    eps = config.rms_norm_eps
    kp, vp = k_pages[l], v_pages[l]                        # views, in place
    xn = rms_norm(x, params["ln1"][l], eps)
    q = _mm_prefill(xn, _layer_w(params, "wq", l)).reshape(b, t, -1, d)
    k = _mm_prefill(xn, _layer_w(params, "wk", l)).reshape(b, t, -1, d)
    v = _mm_prefill(xn, _layer_w(params, "wv", l)).reshape(b, t, -1, d)
    q, k = rope_ops.apply_rope_array(q, k, cos, sin)
    if scatter_first:
        kp[phys, page_off] = k.to(kp.dtype)
        vp[phys, page_off] = v.to(vp.dtype)
    attn = attn_fn(q, k, v, kp, vp)
    xo = x + _mm_prefill(attn.reshape(b, t, -1),
                         _layer_w(params, "wo", l)).to(x.dtype)
    xn2 = rms_norm(xo, params["ln2"][l], eps)
    g = _mm_prefill(xn2, _layer_w(params, "w_gate", l))
    u = _mm_prefill(xn2, _layer_w(params, "w_up", l))
    # w_down stays weight-only here, as in the reference (l.1083)
    xo = xo + _mm(F.silu(g) * u, _layer_w(params, "w_down", l))
    if not scatter_first:
        kp[phys, page_off] = k.to(kp.dtype)
        vp[phys, page_off] = v.to(vp.dtype)
    return xo.to(x.dtype)


def _prefill_scatter_index(block_tables, abs_pos, seq_lens, page):
    """Physical page and in-page offset of every (row, token) slot of a
    right-padded prefill: pad tokens (``t >= seq_lens[b]``) land in the
    reserved page 0. ``abs_pos`` (B, T) may run past the table for pad
    tokens (a bucket wider than the table); their lookup is clamped, as
    they are sent to page 0 anyway (the JAX lookup gives INT_MIN there,
    replaced by 0 the same way)."""
    width = block_tables.shape[1]
    t = abs_pos.shape[1]
    page_idx = (abs_pos // page).clamp(max=width - 1)
    phys = block_tables.long().gather(1, page_idx)
    valid = torch.arange(t, device=abs_pos.device)[None, :] \
        < seq_lens.long()[:, None]
    return torch.where(valid, phys, torch.zeros_like(phys)), abs_pos % page


@torch.no_grad()
def prefill_paged(params, ids, seq_lens, k_pages, v_pages, block_tables,
                  config: LlamaConfig):
    """Prefill a ragged batch into paged KV (``llama.prefill_paged``).

    ids: (B, T) right-padded prompts; seq_lens: (B,) true lengths;
    k_pages/v_pages: (L, P, page, nkv, d); block_tables: (B, W), padded
    slots pointing at reserved page 0.
    Returns (logits (B, T, V), k_pages, v_pages); the pools are updated
    IN PLACE (the returned pools are the arguments). Causal attention
    within the padded prompt goes through the flash kernels
    (``ops.flash_attention.sdpa_array``)."""
    b, t = ids.shape
    d = config.head_dim
    page = k_pages.shape[2]
    cos, sin = _rope_cache(t, d, float(config.rope_theta), str(ids.device))
    x = params["embed"][ids.long()]
    abs_pos = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    phys, page_off = _prefill_scatter_index(block_tables, abs_pos, seq_lens,
                                            page)
    scale = 1.0 / math.sqrt(d)

    def attn(q, k, v, kp, vp):
        return fa.sdpa_array(q, k, v, scale=scale, causal=True)

    for l in range(config.num_hidden_layers):
        x = _paged_prefill_layer(params, l, x, cos, sin, phys, page_off,
                                 k_pages, v_pages, attn, False, config)
    x = rms_norm(x, params["ln_f"], config.rms_norm_eps)
    return _mm(x, params["lm_head"]), k_pages, v_pages


@torch.no_grad()
def prefill_paged_suffix(params, ids, seq_lens, start_pos, k_pages, v_pages,
                         block_tables, config: LlamaConfig):
    """Prefill only the UNCACHED SUFFIX of a ragged batch into paged KV
    (``llama.prefill_paged_suffix``): each row's leading ``start_pos[b]``
    tokens are already resident in pages reachable through
    ``block_tables``. Suffix queries sit at absolute positions
    ``start_pos + t``: rope is taken there, the suffix K/V are scattered
    first, and attention runs over the gathered page span under
    ``key_pos <= query_pos`` (:func:`ops.paged_attention.
    paged_prefill_attention_plain`).

    ids: (B, T) right-padded suffix tokens; seq_lens: (B,) true suffix
    lengths; start_pos: (B,) cached-prefix lengths (0 = cold row).
    Returns (logits (B, T, V), k_pages, v_pages), pools updated in
    place."""
    b, t = ids.shape
    d = config.head_dim
    page = k_pages.shape[2]
    s_max = block_tables.shape[1] * page
    cos_full, sin_full = _rope_cache(s_max, d, float(config.rope_theta),
                                     str(ids.device))
    x = params["embed"][ids.long()]
    # clamp: a padded suffix bucket may poke past the table span; those
    # slots are pads (sent to page 0), but the lookups must stay in range
    abs_pos = (start_pos.long()[:, None]
               + torch.arange(t, device=ids.device)[None, :]
               ).clamp(max=s_max - 1)
    cos, sin = cos_full[abs_pos], sin_full[abs_pos]        # (B, T, d)
    phys, page_off = _prefill_scatter_index(block_tables, abs_pos, seq_lens,
                                            page)
    scale = 1.0 / math.sqrt(d)

    def attn(q, k, v, kp, vp):
        return pa.paged_prefill_attention_plain(q, kp, vp, block_tables,
                                                start_pos, scale=scale)

    for l in range(config.num_hidden_layers):
        x = _paged_prefill_layer(params, l, x, cos, sin, phys, page_off,
                                 k_pages, v_pages, attn, True, config)
    x = rms_norm(x, params["ln_f"], config.rms_norm_eps)
    return _mm(x, params["lm_head"]), k_pages, v_pages


@torch.no_grad()
def decode_step_paged(params, tok, positions, k_pages, v_pages, block_tables,
                      config: LlamaConfig):
    """One ragged decode step (``llama.decode_step_paged``). tok: (B,);
    positions: (B,) int32 absolute position of each row's new token (may
    differ per row). Each layer writes the token's K/V into its page slot
    (:func:`ops.paged_attention.paged_write`, in place), then attends
    over ``pos < position + 1`` through the paged decode kernel.
    Returns (logits (B, V), k_pages, v_pages).

    A position at or past the table span (a finished row over-decoding
    to the end of a legacy decode chunk): its write goes to page 0, its
    rope is taken at the last position, and attention reads the whole
    table. Its logits are garbage the engine drops. The JAX function
    drops that write and gives the row NaN logits.

    Weight-only int8 leaves dequantize here (a decode token takes no
    A8W8 product); as in the reference, the attention output's
    projection is not cast back, so an int8 model's layer carries fp32
    from there to its end (l.1356-1362)."""
    b = tok.shape[0]
    d = config.head_dim
    eps = config.rms_norm_eps
    s_max = block_tables.shape[1] * k_pages.shape[2]
    cos_full, sin_full = _rope_cache(s_max, d, float(config.rope_theta),
                                     str(tok.device))
    pos_c = positions.long().clamp(0, s_max - 1)
    cos, sin = cos_full[pos_c][:, None], sin_full[pos_c][:, None]  # (B,1,d)
    x = params["embed"][tok.long()][:, None, :]            # (B, 1, h)
    kv_lens = (positions + 1).to(torch.int32)
    scale = 1.0 / math.sqrt(d)
    for l in range(config.num_hidden_layers):
        kp, vp = k_pages[l], v_pages[l]                    # views, in place
        xn = rms_norm(x, params["ln1"][l], eps)
        q = _mm(xn, _layer_w(params, "wq", l)).reshape(b, 1, -1, d)
        k = _mm(xn, _layer_w(params, "wk", l)).reshape(b, 1, -1, d)
        v = _mm(xn, _layer_w(params, "wv", l)).reshape(b, 1, -1, d)
        q, k = rope_ops.apply_rope_array(q, k, cos, sin)
        pa.paged_write(kp, vp, k[:, 0].to(kp.dtype), v[:, 0].to(vp.dtype),
                       block_tables, positions)
        attn = pa.paged_attention(q[:, 0].to(kp.dtype).contiguous(), kp, vp,
                                  block_tables, kv_lens,
                                  scale=scale)             # (B, nh, d)
        xo = x + _mm(attn.reshape(b, 1, -1), _layer_w(params, "wo", l))
        xn2 = rms_norm(xo, params["ln2"][l], eps)
        g = _mm_prefill(xn2, _layer_w(params, "w_gate", l))
        u = _mm_prefill(xn2, _layer_w(params, "w_up", l))
        xo = xo + _mm(F.silu(g) * u, _layer_w(params, "w_down", l))
        x = xo.to(x.dtype)
    x = rms_norm(x, params["ln_f"], eps)
    return _mm(x[:, 0], params["lm_head"]), k_pages, v_pages


# ---------------------------------------------------------------------------
# The contiguous-cache path: a uniform-length batch's prefill and decode
# step over a (L, B, S_max, nkv, d) cache (``GenerationEngine``)
# ---------------------------------------------------------------------------

def init_kv_cache(config: LlamaConfig, batch: int, max_len: int, dtype=None,
                  *, device=None) -> Dict[str, torch.Tensor]:
    """Contiguous per-layer KV cache ``{"k", "v"}``, each zeros of shape
    (L, B, S_max, nkv, d) in ``dtype`` (default the config's) on
    ``device``. The paged cache of the serving engines is
    ``ops.paged_attention.PagedKVCacheManager``."""
    shape = (config.num_hidden_layers, batch, max_len,
             config.num_key_value_heads, config.head_dim)
    dev = resolve_device(device)
    dt = dtype or config.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _cached_attention(q, k_cache, v_cache, kv_len, config: LlamaConfig):
    """q (B, T, nh, d); caches (B, S_max, nkv, d); attend over
    ``[0, kv_len)`` with causality inside the current T block (query i
    sits at absolute position ``kv_len - T + i``). ``kv_len`` is an int
    or a 0-d device tensor (read on the device, never on the host).

    The reference's XLA einsums, in plain PyTorch on every device (no
    Pallas kernel replaces them): fp32 scores over the whole slab, the
    mask ``key <= kv_len - T + i``, an fp32 softmax, the probabilities
    rounded to V's dtype before P·V. GQA groups the query heads,
    (B, T, nkv, rep, d) against (B, S, nkv, d); K/V are never
    repeated."""
    b, t, nh, d = q.shape
    s_max, nkv = k_cache.shape[1], k_cache.shape[2]
    q_pos = kv_len - t + torch.arange(t, device=q.device)     # (T,)
    mask = torch.arange(s_max, device=q.device)[None, :] <= q_pos[:, None]
    qg = q.reshape(b, t, nkv, nh // nkv, d)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg.float(),
                          k_cache.float()) / math.sqrt(d)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, t, nh, d)


def _decoder_layer_cached_full(params, l, x, cos, sin, kf, vf, kv_len,
                               config: LlamaConfig):
    """One cached decoder layer on the FULL stacked cache (L, B, S_max,
    nkv, d): the T new tokens' K/V go into layer ``l``'s slab at
    positions ``kv_len - T ..`` (``index_copy_`` at a device index, in
    place), then attention reads the layer's whole slab. RMSNorm through
    ``ops.rms_norm`` (the Triton kernel on the card)."""
    b, t, _ = x.shape
    d = config.head_dim
    eps = config.rms_norm_eps
    xn = rms_norm(x, params["ln1"][l], eps)
    q = _mm_prefill(xn, _layer_w(params, "wq", l)).reshape(b, t, -1, d)
    k = _mm_prefill(xn, _layer_w(params, "wk", l)).reshape(b, t, -1, d)
    v = _mm_prefill(xn, _layer_w(params, "wv", l)).reshape(b, t, -1, d)
    q, k = rope_ops.apply_rope_array(q, k, cos, sin)
    slots = kv_len - t + torch.arange(t, device=x.device)
    kf[l].index_copy_(1, slots, k.to(kf.dtype))
    vf[l].index_copy_(1, slots, v.to(vf.dtype))
    attn = _cached_attention(q, kf[l], vf[l], kv_len, config)
    x = x + _mm_prefill(attn.reshape(b, t, -1),
                        _layer_w(params, "wo", l)).to(x.dtype)
    xn = rms_norm(x, params["ln2"][l], eps)
    g = _mm_prefill(xn, _layer_w(params, "w_gate", l))
    u = _mm_prefill(xn, _layer_w(params, "w_up", l))
    return x + _mm_prefill(F.silu(g) * u,
                           _layer_w(params, "w_down", l)).to(x.dtype)


@torch.no_grad()
def prefill_stacked(params, ids, cache, config: LlamaConfig):
    """Process the whole (right-padded) prompt bucket, filling the cache
    (``llama.prefill_stacked``). ids: (B, T) int; cache: ``{"k", "v"}``
    of (L, B, S_max, nkv, d), updated IN PLACE and returned. Returns
    (per-position logits (B, T, V), cache); the caller picks each row's
    last real position."""
    b, t = ids.shape
    s_max = cache["k"].shape[2]
    cos_full, sin_full = _rope_cache(s_max, config.head_dim,
                                     float(config.rope_theta),
                                     str(ids.device))
    # the bucket is the attendable span: a device scalar, as decode's
    kv_len = torch.full((), t, dtype=torch.long, device=ids.device)
    x = params["embed"][ids.long()]
    for l in range(config.num_hidden_layers):
        x = _decoder_layer_cached_full(params, l, x, cos_full[:t],
                                       sin_full[:t], cache["k"], cache["v"],
                                       kv_len, config)
    x = rms_norm(x, params["ln_f"], config.rms_norm_eps)
    return _mm(x, params["lm_head"]), cache


@torch.no_grad()
def decode_step_stacked(params, tok, pos, cache, config: LlamaConfig):
    """One generated token (``llama.decode_step_stacked``). tok: (B,)
    int; pos: 0-d int device tensor, the absolute position of ``tok``
    (kv_len becomes pos + 1). The rope rows are gathered and the slab
    written at ``pos`` on the device, so a CUDA graph replays the step
    at any position. Returns (logits (B, V), cache), the cache updated
    IN PLACE."""
    s_max = cache["k"].shape[2]
    cos_full, sin_full = _rope_cache(s_max, config.head_dim,
                                     float(config.rope_theta),
                                     str(tok.device))
    p = pos.reshape(1).long()
    cos, sin = cos_full.index_select(0, p), sin_full.index_select(0, p)
    x = params["embed"][tok.long()][:, None, :]
    kv_len = pos.long() + 1
    for l in range(config.num_hidden_layers):
        x = _decoder_layer_cached_full(params, l, x, cos, sin, cache["k"],
                                       cache["v"], kv_len, config)
    x = rms_norm(x, params["ln_f"], config.rms_norm_eps)
    return _mm(x[:, 0], params["lm_head"]), cache


# ---------------------------------------------------------------------------
# Training: the differentiable forward, the loss and the one-device step
# ---------------------------------------------------------------------------

def decoder_layer(p, x, cos, sin, config: LlamaConfig):
    """One decoder layer — ``_decoder_layer_manual`` with ``mp_axis =
    fsdp_axis = sep_axis = None``. ``p`` holds one layer's weights
    (``wq`` (h, h), …, ``ln1`` (h,)); ``x`` is (B, S, h); ``cos``/``sin``
    are (S, d). Causal attention goes through the flash kernels."""
    b, s, _ = x.shape
    d = config.head_dim
    eps = config.rms_norm_eps
    xn = rms_norm(x, p["ln1"], eps)
    q = _mm(xn, p["wq"]).reshape(b, s, -1, d)
    k = _mm(xn, p["wk"]).reshape(b, s, -1, d)
    v = _mm(xn, p["wv"]).reshape(b, s, -1, d)
    q, k = rope_ops.apply_rope_array(q, k, cos, sin)
    attn = fa.sdpa_array(q, k, v, scale=1.0 / math.sqrt(d), causal=True)
    out = _mm(attn.reshape(b, s, -1), p["wo"])
    # the reference pins the residual carry to x's dtype (l.457/465)
    x = x + out.to(x.dtype)
    xn = rms_norm(x, p["ln2"], eps)
    dn = _mm(F.silu(_mm(xn, p["w_gate"])) * _mm(xn, p["w_up"]), p["w_down"])
    return x + dn.to(x.dtype)


def _layer(params, l):
    return {k: _layer_w(params, k, l) for k in LAYER_KEYS}


#: the matmuls the ``dots`` policy keeps (``jax.checkpoint_policies.
#: dots_saveable``: every dot's output)
_MATMULS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default))
#: bytes the ``offload`` policy has copied to the host (its attention
#: outputs and their LSEs), for the smoke's report
offload_bytes = [0]


class _KeepOutputs(TorchDispatchMode):
    """The forward of a selectively recomputed layer: every op in
    ``ops`` runs and its outputs go into ``store`` (pinned host copies
    when ``host``)."""

    def __init__(self, ops, store, host: bool, as_op: bool):
        super().__init__()
        self.ops, self.store, self.host, self.as_op = ops, store, host, as_op

    def __enter__(self):
        self._route = fa.forward_as_op() if self.as_op else None
        if self._route is not None:
            self._route.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self._route is not None:
            self._route.__exit__(*exc)
        return out

    def _keep(self, t):
        if not isinstance(t, torch.Tensor):
            return t
        if self.host:
            offload_bytes[0] += t.numel() * t.element_size()
            return _OnHost(t)
        return t.detach()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.store.append(tree_map(self._keep, out))
        return out


class _ReuseOutputs(_KeepOutputs):
    """The recomputation: every op in ``ops`` returns what the forward
    kept (moved back to its device) instead of running again."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops:
            return tree_map(lambda k: k.back() if isinstance(k, _OnHost)
                            else k, self.store.popleft())
        return func(*args, **(kwargs or {}))


class _OnHost:
    """A tensor the ``offload`` policy moved to pinned host memory (on
    the card's stream, so the copy back is ordered after it)."""

    def __init__(self, t: torch.Tensor):
        self.device = t.device
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
        else:
            self.host = t.detach().clone()

    def back(self) -> torch.Tensor:
        return self.host.to(self.device, non_blocking=self.host.is_pinned())


def _policy_contexts(policy: str):
    """``checkpoint``'s ``context_fn`` for a selective policy: the
    forward keeps the outputs the policy saves, the recomputation
    reuses them. ``dots`` keeps the matmuls' outputs; ``attn`` the
    flash forward's output and LSE (row 5's custom op); ``offload`` the
    same in pinned host memory."""
    ops = _MATMULS if policy == "dots" else frozenset(
        (torch.ops.paddle_tpu_torch.flash_attention_fwd.default,))
    host = policy == "offload"
    as_op = policy != "dots"

    def context_fn():
        store = collections.deque()
        return (_KeepOutputs(ops, store, host, as_op),
                _ReuseOutputs(ops, store, host, as_op))
    return context_fn


def _hidden(params, ids, config: LlamaConfig, remat: bool = False,
            remat_policy: str = "full"):
    """Embedding and the decoder stack: (B, S) ids -> (B, S, h). With
    ``remat`` each layer is a checkpoint (the reference's
    ``jax.checkpoint`` per layer) under ``remat_policy``: ``full``
    keeps nothing inside the layer; ``dots``, ``attn`` and ``offload``
    keep what the reference's policies of those names save (see
    :func:`_policy_contexts`)."""
    cos, sin = rope_ops.build_rope_cache(ids.shape[-1], config.head_dim,
                                         config.rope_theta,
                                         device=ids.device)
    x = params["embed"][ids.long()]
    kw = {}
    if remat and remat_policy in ("dots", "attn", "offload"):
        kw["context_fn"] = _policy_contexts(remat_policy)
    for l in range(config.num_hidden_layers):
        if remat:
            out = checkpoint(decoder_layer, _layer(params, l), x, cos, sin,
                             config, use_reentrant=False, **kw)
        else:
            out = decoder_layer(_layer(params, l), x, cos, sin, config)
        x = out.to(x.dtype)
    return rms_norm(x, params["ln_f"], config.rms_norm_eps)


def _token_ce(logits, labels):
    """Mean token cross-entropy over fp32 logits (``loss_stacked``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def forward_stacked(params, ids, config: LlamaConfig, *,
                    remat: bool = False, remat_policy: str = "full"):
    """Single-device forward over the stacked layout → logits (B, S, V).
    ``remat``: each layer is a checkpoint (see :func:`_hidden`). Int8
    leaves dequantize in each product (:func:`_dense`)."""
    return _mm(_hidden(params, ids, config, remat=remat,
                       remat_policy=remat_policy), params["lm_head"])


def loss_stacked(params, ids, labels, config: LlamaConfig, *,
                 remat: bool = False, remat_policy: str = "full"):
    """Mean token cross-entropy of :func:`forward_stacked`'s logits,
    taken in fp32."""
    return _token_ce(forward_stacked(params, ids, config, remat=remat,
                                     remat_policy=remat_policy), labels)


def init_opt_state(params) -> Dict[str, Any]:
    """AdamW state for ``params``: step 0 (int32) and fp32 zero moments
    shaped like each leaf (l.845-849)."""
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()},
            "v": {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()}}


#: AdamW constants of the reference's fused optimizer (l.836)
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


def build_train_step(config: LlamaConfig, learning_rate: float = 1e-3,
                     remat: bool = True, remat_policy: str = "full",
                     k_steps: int = 1, device=None, *, mesh=None,
                     seq_shard: bool = False, virtual_pp: int = 1,
                     pipeline_schedule: str = "fill_drain",
                     zero_gather: str = "per_layer"):
    """One-device counterpart of ``build_hybrid_train_step`` (l.473).
    Returns ``(step_fn, init_fn)``.

    ``step_fn(params, opt_state, ids, labels) -> (loss, params,
    opt_state)``: ``ids``/``labels`` are (M, B, S) microbatches (with a
    leading k axis when ``k_steps > 1``); each microbatch's loss is
    backpropagated scaled by 1/M, so the gradients are those of the mean
    loss over all microbatches, which is the loss returned (a 0-d fp32
    tensor on the params' device). Then one AdamW step (b1 0.9, b2 0.95,
    eps 1e-8, wd 0.1, fp32 moments). Where the reference returns new
    arrays, the port updates ``params`` and ``opt_state`` IN PLACE (no
    second copy of the weights and moments) and returns them.
    ``k_steps > 1`` runs k such steps and returns the last loss.

    ``remat=True`` recomputes each layer in the backward through
    ``torch.utils.checkpoint`` under ``remat_policy`` (the reference's
    l.614-640): ``"full"`` keeps nothing inside a layer; ``"dots"``
    keeps the matmuls' outputs and recomputes norms and elementwise
    work; ``"attn"`` keeps only the flash forward's output and LSE, so
    the backward does not replay the attention (the reference's flash
    VJP replays it for the LSE); ``"offload"`` keeps them in pinned host
    memory (:data:`offload_bytes` counts the bytes). Any other name is
    ``"full"``, as in the reference. ``init_fn(seed)`` gives seeded
    params on ``device`` (``None`` means the card) and a fresh AdamW
    state. A ``mesh`` of more than one rank, or any of the hybrid
    options (``seq_shard``, ``virtual_pp``, ``pipeline_schedule``,
    ``zero_gather``), builds :func:`build_hybrid_train_step` instead.
    """
    axes = getattr(mesh, "shape", mesh) or {}
    hybrid = (seq_shard or virtual_pp != 1 or pipeline_schedule !=
              "fill_drain" or zero_gather != "per_layer")
    if any(int(n) > 1 for n in dict(axes).values()) or hybrid:
        from ..parallel import mesh as pmesh
        if not isinstance(mesh, pmesh.Mesh):
            mesh = pmesh.build_mesh(dict(axes))
        return build_hybrid_train_step(
            config, mesh,
            learning_rate, remat, seq_shard, virtual_pp, remat_policy,
            pipeline_schedule, zero_gather, k_steps, device=device)
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    lr = float(learning_rate)

    def one_step(params, opt_state, ids, labels):
        _check_real(params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        n_micro = ids.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=ids.device)
        for i in range(n_micro):
            loss = loss_stacked(leaves, ids[i], labels[i], config,
                                remat=remat, remat_policy=remat_policy)
            (loss / n_micro).backward()
            total = total + loss.detach()
        with torch.no_grad():
            t = opt_state["step"] + 1
            tf = t.float()
            bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32,
                                             device=tf.device), tf)
            bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32,
                                             device=tf.device), tf)
            # the reference's ``upd`` (l.862-870); stacked leaves one layer
            # at a time, so that no pass's fp32 temporaries hold a whole
            # stack
            lists = ([], [], [], [])
            for k, p in params.items():
                ts = (p, leaves[k].grad, opt_state["m"][k], opt_state["v"][k])
                parts = range(p.shape[0]) if k in LAYER_KEYS else (None,)
                for l in parts:
                    sl = slice(None) if l is None else l
                    for dst, x in zip(lists, ts):
                        dst.append(x[sl])
            adamw_update_(*lists, lr=lr, beta1=ADAM_B1, beta2=ADAM_B2,
                          eps=ADAM_EPS, weight_decay=WEIGHT_DECAY, bc1=bc1,
                          bc2=bc2)
            opt_state["step"] = t
        return total / n_micro, params, opt_state

    def step_fn(params, opt_state, ids, labels):
        if k_steps == 1:
            return one_step(params, opt_state, ids, labels)
        if ids.shape[0] != k_steps or labels.shape[0] != k_steps:
            raise ValueError(f"k_steps={k_steps} needs ids/labels with a "
                             f"leading axis of {k_steps}")
        loss = None
        for i in range(k_steps):
            loss, params, opt_state = one_step(params, opt_state, ids[i],
                                               labels[i])
        return loss, params, opt_state

    def init_fn(seed: int = 0):
        params = init_params(config, seed, device=device)
        return params, init_opt_state(params)

    return step_fn, init_fn


# ---------------------------------------------------------------------------
# The hybrid step (l.285-921): dp x pp x sharding x sep x mp, a rank per
# process
# ---------------------------------------------------------------------------

def stacked_param_specs(config: LlamaConfig) -> Dict[str, Any]:
    """PartitionSpecs of the stacked layout (l.285): the L axis over pp,
    Megatron dims over mp, the big matrices' contraction rows also over
    ``("dp", "sharding")`` (ZeRO-3 weight sharding)."""
    from ..parallel.mesh import PartitionSpec as P
    return {
        "embed": P("mp", None),
        "wq": P("pp", ("dp", "sharding"), "mp"),
        "wk": P("pp", ("dp", "sharding"), "mp"),
        "wv": P("pp", ("dp", "sharding"), "mp"),
        "wo": P("pp", "mp", ("dp", "sharding")),
        "w_gate": P("pp", ("dp", "sharding"), "mp"),
        "w_up": P("pp", ("dp", "sharding"), "mp"),
        "w_down": P("pp", "mp", ("dp", "sharding")),
        "ln1": P("pp", None),
        "ln2": P("pp", None),
        "ln_f": P(),
        "lm_head": P(None, "mp"),
    }


def serving_param_specs(config: LlamaConfig) -> Dict[str, Any]:
    """Megatron tensor-parallel specs of the serving path (l.304): ``mp``
    only; the attention and gate/up projections column-parallel, ``wo``
    and ``w_down`` row-parallel, the embedding, head and norms whole."""
    from ..parallel.mesh import PartitionSpec as P
    col, row = P(None, None, "mp"), P(None, "mp", None)
    return {
        "embed": P(), "lm_head": P(), "ln_f": P(),
        "ln1": P(None, None), "ln2": P(None, None),
        "wq": col, "wk": col, "wv": col,
        "w_gate": col, "w_up": col,
        "wo": row, "w_down": row,
    }


def shard_params_tp(params: Dict[str, Any], mesh, config: LlamaConfig):
    """Place a stacked-param dict on a serving TP mesh under
    :func:`serving_param_specs` (l.323). Over a ``ServingMesh`` of more
    than one chip: a list of one dict a chip, in chip order, each on its
    chip's device: a split weight is the chip's contiguous slab (the
    reference's device shard), a whole one the tensor itself where it
    already lies on that device. A degree-1 serving mesh gives the dict
    on its device. Over a process ``Mesh`` (``parallel.mesh.Mesh``):
    this rank's slabs.

    A weight-only int8 leaf ``{"q", "scale"}`` (l.335-345): ``q`` splits
    like the dense weight; ``scale`` (L, out) splits along ``out`` for a
    column-parallel weight and is whole for a row-parallel one (its out
    dim is not split). On the card each ``q`` slab is column-major
    (:func:`place_int8`)."""
    from ..parallel.mesh import ServingMesh, SlabSharding
    specs = serving_param_specs(config)
    int8 = {k for k, v in params.items() if isinstance(v, dict)}
    if not isinstance(mesh, ServingMesh):
        from ..parallel.mesh import PartitionSpec as P

        def rank_slab(v, spec):
            sh = SlabSharding(mesh, spec)
            return v if sh.num_parts(0) == 1 else sh.shard(v)

        out = {}
        for k, v in params.items():
            spec = specs.get(k, ())
            if k in int8:
                out_axis = spec[-1] if len(spec) == 3 else None
                out[k] = {"q": rank_slab(v["q"], spec),
                          "scale": rank_slab(v["scale"], P(
                              *([None] * (v["scale"].dim() - 1)
                                + [out_axis])))}
            else:
                out[k] = rank_slab(v, spec)
        return out
    devs = mesh.devices.reshape(-1).tolist()
    if len(devs) == 1:
        return {k: (place_int8(v, devs[0]) if k in int8 else v.to(devs[0]))
                for k, v in params.items()}
    n = len(devs)

    def slab(k, v, dim, c, dev):
        if v.shape[dim] % n:
            raise ValueError(f"{k}: dim {dim} ({v.shape[dim]}) does not "
                             f"split over {n} chips")
        w = v.shape[dim] // n
        return v.narrow(dim, c * w, w).to(dev).contiguous()

    out = []
    for c, dev in enumerate(devs):
        chip = {}
        for k, v in params.items():
            spec = specs.get(k, ())
            dims = [i for i, e in enumerate(spec) if e is not None]
            if k in int8:
                q = slab(k, v["q"], dims[0], c, dev) if dims else v["q"]
                col = dims and dims[0] == len(spec) - 1
                scale = (slab(k, v["scale"], v["scale"].dim() - 1, c, dev)
                         if col else v["scale"])
                chip[k] = place_int8({"q": q, "scale": scale}, dev)
            elif not dims:
                chip[k] = v.to(dev)
            else:
                chip[k] = slab(k, v, dims[0], c, dev)
        out.append(chip)
    return out


def _decoder_layer_manual(p, x, cos, sin, config: LlamaConfig, mp_axis,
                          fsdp_axis, sep_axis=None):
    """One decoder layer of a rank (l.392): ``p`` holds this rank's
    slabs of one layer (``wq`` (h/fsdp, h/mp), ``wo`` (h/mp, h/fsdp),
    ...), all-gathered over the ``fsdp_axis`` groups where given (the
    ZeRO-3 gather: ``gather_in`` on the contraction rows, ``gather_out``
    on ``wo``/``w_down``'s columns; backward: reduce-scatter). Over an
    ``mp_axis`` group the normed input enters the split projections by
    ``copy_to_group`` and the row products leave by ``psum`` (l.452,
    464). With a ``sep_axis`` group the activations are sequence slices
    and attention runs Ulysses-style: an all-to-all gives each rank the
    whole sequence for its heads and another one takes it back. The
    attention output is row 5's custom op under the ``attn`` and
    ``offload`` remat policies (the reference names it ``"attn_out"``).
    With ``config.sep_mode == "ring"`` the sep group runs ring attention
    on the rank's chunk instead (l.426-432).
    """
    from ..distributed import collective as C
    b, s, _ = x.shape
    d = config.head_dim
    eps = config.rms_norm_eps

    def gather_in(w):
        return C.all_gather_grad(w, fsdp_axis, 0) if fsdp_axis else w

    def gather_out(w):
        return C.all_gather_grad(w, fsdp_axis, 1) if fsdp_axis else w

    xn = C.copy_to_group(rms_norm(x, p["ln1"], eps), mp_axis)
    q = (xn @ gather_in(p["wq"])).reshape(b, s, -1, d)
    k = (xn @ gather_in(p["wk"])).reshape(b, s, -1, d)
    v = (xn @ gather_in(p["wv"])).reshape(b, s, -1, d)
    q, k = rope_ops.apply_rope_array(q, k, cos, sin)
    if sep_axis is not None and getattr(config, "sep_mode",
                                        "ulysses") == "ring":
        # blockwise ring attention: the KV chunks travel around the sep
        # group, merged by their log-sum-exp (ops/ring_attention.py)
        from ..ops import ring_attention as ra
        attn = ra.ring_attention_array(q, k, v, sep_axis, causal=True,
                                       scale=1.0 / math.sqrt(d))
    else:
        if sep_axis is not None:
            # (b, s_local, nh, d) -> (b, s_full, nh/sep, d)
            q, k, v = (C.all_to_all_grad(t, sep_axis, 2, 1)
                       for t in (q, k, v))
        attn = fa.sdpa_array(q, k, v, scale=1.0 / math.sqrt(d), causal=True)
        if sep_axis is not None:
            attn = C.all_to_all_grad(attn, sep_axis, 1, 2)
    out = C.psum(attn.reshape(b, s, -1) @ gather_out(p["wo"]), mp_axis)
    x = x + out.to(x.dtype)
    xn = C.copy_to_group(rms_norm(x, p["ln2"], eps), mp_axis)
    g = xn @ gather_in(p["w_gate"])
    u = xn @ gather_in(p["w_up"])
    dn = C.psum((F.silu(g) * u) @ gather_out(p["w_down"]), mp_axis)
    return x + dn.to(x.dtype)


#: fsdp-sharded dim of each stacked layer weight (leading dim is L)
_ZG_DIM = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1,
           "wo": 2, "w_down": 2}



def _layer_order(pp: int, vpp: int, layers_per_chunk: int):
    """Storage order of the stacked layers under the virtual pipeline
    (l.575-583): ``storage[s] = model[order[s]]``."""
    from ..parallel.pipeline import interleave_chunk_order
    return np.asarray([c * layers_per_chunk + r
                       for c in interleave_chunk_order(pp, vpp)
                       for r in range(layers_per_chunk)])


def microbatch(ids: np.ndarray, labels: np.ndarray, num_micro: int):
    """(B, S) -> (M, B/M, S) (l.916)."""
    B = ids.shape[0]
    assert B % num_micro == 0
    return (ids.reshape(num_micro, B // num_micro, -1),
            labels.reshape(num_micro, B // num_micro, -1))


def build_hybrid_train_step(config: LlamaConfig, mesh,
                            learning_rate: float = 1e-3,
                            remat: bool = True,
                            seq_shard: bool = False,
                            virtual_pp: int = 1,
                            remat_policy: str = "full",
                            pipeline_schedule: str = "fill_drain",
                            zero_gather: str = "per_layer",
                            k_steps: int = 1, *, device=None):
    """The reference's hybrid train step (l.473), one rank per process.
    Returns ``(step_fn, init_fn)``.

    ``mesh`` is a ``parallel.mesh.Mesh`` over the world's ranks (axes
    dp, pp, sharding, sep, mp). Each rank holds its slab of every
    tensor as :func:`stacked_param_specs` lays it over the mesh (rank
    ``r``'s slab is the reference's device ``r`` shard), and runs the
    reference's ``shard_map`` body with the collectives explicit
    (``distributed/collective.py``): mp Megatron pairs, ZeRO-3
    all-gathers over ``("dp", "sharding")`` per layer (``zero_gather=
    "per_layer"``) or once per step (``"per_step"``), Ulysses
    all-to-alls over sep (``seq_shard=True``), or with ``config.sep_mode``
    = ``"ring"`` ring attention over the sep group (each rank keeps its
    heads and its sequence chunk, ``ops/ring_attention.py``), and the pp
    schedules of ``parallel/pipeline.py``: fill-drain, the virtual
    pipeline (``virtual_pp > 1``; the stacked layers are stored in the
    interleaved order, l.575-583) or ``pipeline_schedule="1f1b"``.

    ``step_fn(params, opt_state, ids, labels) -> (loss, params,
    opt_state)``: every rank passes the global (M, B, S) batch (a
    leading k axis with ``k_steps > 1``) and takes its slab (batch over
    ``("dp", "sharding")``, sequence over sep). The loss is the global
    mean (the same on every rank); the gradients are the global mean
    loss's, each parameter's summed over the data axes its spec does
    not split it over. AdamW (b1 0.9, b2 0.95, eps 1e-8, wd 0.1, fp32
    moments) updates the slabs in place, elementwise (l.854-877).

    ``init_fn(seed)`` draws the reference's weights on the Threefry
    stream (:func:`init_stacked_params`), applies the interleaved layer
    order and keeps this rank's slabs, tagged for sharded checkpoints
    (``parallel.mesh.SlabInfo``, in model layer order). Every rank
    draws the whole model: fine at test widths and at one rank.
    ``step_fn.gather(tree)`` gives the global tensors of a params-shaped
    tree of slabs in model layer order (collective) and
    ``step_fn.shard(global_params)`` this rank's slabs of global
    model-order params. Over a one-rank mesh every collective is its
    input itself and the step is the one-device step's arithmetic.
    """
    from ..distributed import collective as C
    from ..parallel import pipeline as ppipe
    from ..parallel.mesh import SlabSharding, SlabInfo, mark_slab

    if pipeline_schedule not in ("fill_drain", "1f1b"):
        raise ValueError(f"unknown pipeline_schedule {pipeline_schedule!r}")
    if zero_gather not in ("per_layer", "per_step"):
        raise ValueError(f"unknown zero_gather {zero_gather!r} "
                         "(expected 'per_layer' or 'per_step')")
    if zero_gather == "per_step" and pipeline_schedule == "1f1b":
        raise ValueError("zero_gather='per_step' is a fill-drain-family "
                         "option (1f1b gathers per layer)")
    if remat_policy not in ("full", "dots", "attn", "offload"):
        raise ValueError(f"unknown remat_policy {remat_policy!r} "
                         "(expected 'full', 'dots', 'attn' or 'offload')")
    deg = {ax: int(mesh.shape.get(ax, 1)) for ax in
           ("dp", "pp", "sharding", "sep", "mp")}
    pp, mp, sep = deg["pp"], deg["mp"], deg["sep"]
    if pipeline_schedule == "1f1b":
        if pp <= 1:
            raise ValueError("pipeline_schedule='1f1b' needs a pp axis > 1")
        if virtual_pp > 1:
            raise ValueError("1f1b and virtual_pp are mutually exclusive "
                             "(interleave is a fill-drain-family schedule)")
        if seq_shard:
            raise ValueError("1f1b with sequence parallelism is not "
                             "supported; use the fill-drain schedule")
    if seq_shard and sep <= 1:
        raise ValueError("seq_shard=True requires a 'sep' mesh axis of size>1")
    sep_mode = getattr(config, "sep_mode", "ulysses")
    if sep_mode not in ("ulysses", "ring"):
        raise ValueError(f"unknown sep_mode {sep_mode!r} "
                         f"(expected 'ulysses' or 'ring')")
    use_sep = seq_shard and sep > 1
    if use_sep:
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        if sep_mode == "ulysses":
            # Ulysses repartitions heads over sep; ring never splits heads
            if nh % (mp * sep) or nkv % (mp * sep):
                raise ValueError(
                    f"Ulysses sep={sep} with mp={mp} needs heads divisible "
                    f"by mp*sep (got q={nh}, kv={nkv})")
        elif nh % mp or nkv % mp:
            raise ValueError(
                f"ring sep with mp={mp} needs heads divisible by mp "
                f"(got q={nh}, kv={nkv})")
    vpp = max(int(virtual_pp), 1)
    if vpp > 1 and pp <= 1:
        raise ValueError("virtual_pp > 1 requires a pp mesh axis of size > 1")
    n_layers = config.num_hidden_layers
    if n_layers % (pp * vpp):
        raise ValueError(
            f"num_hidden_layers {n_layers} must divide by "
            f"pp*virtual_pp = {pp * vpp}")
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    lpc = n_layers // (pp * vpp)
    order = _layer_order(pp, vpp, lpc) if vpp > 1 else None
    specs = stacked_param_specs(config)
    shardings = {k: SlabSharding(mesh, s) for k, s in specs.items()}
    group = {ax: mesh.group(ax) for ax in mesh.axis_names}
    mp_axis = group["mp"] if mp > 1 else None
    fsdp_axis = ([group["dp"], group["sharding"]]
                 if deg["dp"] * deg["sharding"] > 1 else None)
    sep_axis = group["sep"] if use_sep else None
    pp_axis = group["pp"]
    stage = pp_axis.rank
    last_stage = stage == pp - 1
    R = deg["dp"] * deg["sharding"]
    lr = float(learning_rate)
    eps = config.rms_norm_eps
    shapes = _param_shapes(config)
    kw = {}
    if remat and remat_policy in ("dots", "attn", "offload"):
        kw["context_fn"] = _policy_contexts(remat_policy)

    def slab_info(k):
        """Where this rank's slab of ``k`` sits in the model-order global
        tensor (one piece a storage block under the virtual pipeline)."""
        info = SlabInfo.of(shardings[k], shapes[k])
        if order is None or k not in LAYER_KEYS:
            return info
        (_, off, shape), = info.pieces
        pieces = []
        for i in range(0, shape[0], lpc):
            local = (slice(i, i + lpc),) + tuple(slice(0, n)
                                                for n in shape[1:])
            goff = (int(order[off[0] + i]),) + off[1:]
            pieces.append((local, goff, (lpc,) + shape[1:]))
        return SlabInfo(info.global_shape, pieces, info.writes)

    infos = {k: slab_info(k) for k in shapes}

    def shard(global_params):
        """This rank's slabs of model-order global params."""
        out = {}
        for k, v in global_params.items():
            if order is not None and k in LAYER_KEYS:
                v = v[torch.as_tensor(order, device=v.device)]
            out[k] = mark_slab(shardings[k].shard(v), infos[k])
        return out

    def gather(tree):
        """The model-order global tensors of a params-shaped tree of
        slabs (collective)."""
        out = {}
        for k, v in tree.items():
            full = shardings[k].gather(v)
            if order is not None and k in LAYER_KEYS:
                full = full[torch.as_tensor(np.argsort(order),
                                            device=full.device)]
            out[k] = full
        return out

    def embed(leaves, ids):
        """Token embeddings; vocab-parallel over mp (l.585-603)."""
        from ..distributed.meta_parallel.mp_layers import \
            vocab_parallel_embedding_array
        w = leaves["embed"]
        if mp_axis is None:
            return w[ids.long()]
        return vocab_parallel_embedding_array(w, ids, mp_axis)

    def head_ce(hp, y, lab):
        """ln_f + lm_head + token CE over any leading dims (mean)."""
        out = C.copy_to_group(rms_norm(y, hp["ln_f"], eps), mp_axis)
        logits = (out @ hp["lm_head"]).float()
        if mp_axis is not None:
            from ..distributed.meta_parallel.mp_layers import \
                vocab_parallel_ce_array
            return vocab_parallel_ce_array(logits, lab, mp_axis).mean()
        return _token_ce(logits, lab)

    def make_stage_fn(cos, sin, fsdp):
        def stage_fn(sp, x):
            for l in range(sp["wq"].shape[0]):
                lp = {k: sp[k][l] for k in LAYER_KEYS}
                if remat:
                    out = checkpoint(_decoder_layer_manual, lp, x, cos, sin,
                                     config, mp_axis, fsdp, sep_axis,
                                     use_reentrant=False, **kw)
                else:
                    out = _decoder_layer_manual(lp, x, cos, sin, config,
                                                mp_axis, fsdp, sep_axis)
                x = out.to(x.dtype)
            return x
        return stage_fn

    def rope(S, dev):
        s_glob = S * sep if use_sep else S
        cos, sin = rope_ops.build_rope_cache(s_glob, config.head_dim,
                                             config.rope_theta, device=dev)
        if use_sep:
            # RoPE runs before the all-to-all, on this rank's positions
            off = group["sep"].rank * S
            cos, sin = cos[off:off + S], sin[off:off + S]
        return cos, sin

    def fill_drain_loss(leaves, ids, labels):
        """The reference's ``spmd_loss`` (l.664) on this rank."""
        M, mb, S = ids.shape
        cos, sin = rope(S, ids.device)
        local = {k: leaves[k] for k in LAYER_KEYS}
        fsdp = fsdp_axis
        if zero_gather == "per_step" and fsdp_axis is not None:
            # the ZeRO gather once a step, above the microbatch loop and
            # the remat scope (its reduce-scatter runs once too)
            local = {k: (C.all_gather_grad(v, fsdp_axis, _ZG_DIM[k])
                         if k in _ZG_DIM else v) for k, v in local.items()}
            fsdp = None
        stage_fn = make_stage_fn(cos, sin, fsdp)
        x = embed(leaves, ids)                          # (M, mb, S, h)
        if pp > 1:
            if vpp > 1:
                chunks = {k: v.reshape((vpp, lpc) + tuple(v.shape[1:]))
                          for k, v in local.items()}
                out = ppipe.pipeline_spmd_interleaved(stage_fn, chunks, x,
                                                      vpp, axis_name=pp_axis)
            else:
                out = ppipe.pipeline_spmd(stage_fn, local, x,
                                          axis_name=pp_axis)
            out = ppipe.last_stage_broadcast(out, pp_axis)
        else:
            out = torch.stack([stage_fn(local, x[i]) for i in range(M)])
        return head_ce({"ln_f": leaves["ln_f"],
                        "lm_head": leaves["lm_head"]}, out, labels)

    def loss_and_grads_1f1b(leaves, ids, labels):
        """The reference's ``spmd_1f1b_loss_grads`` (l.728): the layer
        gradients from the per-tick backward of ``pipeline_1f1b``; the
        embedding gradient folded in on stage 0 as each microbatch's
        input gradient arrives (full on every mp rank: no psum, no 1/mp
        rescale, see the module of the collectives)."""
        M, mb, S = ids.shape
        cos, sin = rope(S, ids.device)
        with torch.no_grad():
            x = embed(leaves, ids)
        w = leaves["embed"]
        per = w.shape[0]
        start = mp_axis.rank * per if mp_axis is not None else 0
        h = x.shape[-1]

        def gin_reducer(acc, gx, m_b):
            g = gx.float().reshape(-1, h)
            idx = ids[m_b].reshape(-1).long() - start
            ok = (idx >= 0) & (idx < per)
            return acc.index_add(0, torch.where(ok, idx, torch.zeros_like(
                idx)), torch.where(ok[:, None], g, torch.zeros_like(g)))

        layer = {k: leaves[k].detach() for k in LAYER_KEYS}
        head = {"ln_f": leaves["ln_f"].detach(),
                "lm_head": leaves["lm_head"].detach()}
        loss, lgrads, hgrads, gembed = ppipe.pipeline_1f1b(
            make_stage_fn(cos, sin, fsdp_axis), layer, x, labels, head_ce,
            axis_name=pp_axis, head_params=head, strip_stage_dim=False,
            input_grad_reducer=gin_reducer,
            input_grad_init=torch.zeros(w.shape, dtype=torch.float32,
                                        device=w.device))
        loss = ppipe.last_stage_broadcast(loss, pp_axis)
        grads = dict(lgrads, embed=gembed, **hgrads)
        return loss, {k: g / R for k, g in grads.items()}

    def batch_slab(t):
        """This rank's slab of a global (M, B, S) batch array."""
        B, S = t.shape[1], t.shape[2]
        rb = deg["dp"] * deg["sharding"]
        ib = group["dp"].rank * deg["sharding"] + group["sharding"].rank
        t = t[:, ib * (B // rb):(ib + 1) * (B // rb)]
        if use_sep:
            n = S // sep
            t = t[:, :, group["sep"].rank * n:(group["sep"].rank + 1) * n]
        return t

    # the axes whose ranks see different data (sep only when the
    # sequence is split; pp because each stage's loss copy is seeded on
    # the last stage only): a gradient is summed over those its spec
    # does not split it over (its all-gathers' reduce-scatters sum the
    # others); the mp ranks see one objective (Megatron) and never sum
    data_axes = ("dp", "sharding", "pp") + (("sep",) if use_sep else ())

    def reduce_grads(grads):
        """Sum each gradient over the data axes its spec does not split
        it over (the reference's implicit sums over replicated inputs)."""
        for k, g in grads.items():
            used = specs[k].used_axes()
            for ax in data_axes:
                if deg[ax] > 1 and ax not in used:
                    C.all_reduce(g, group=group[ax])
        return grads

    def one_step(params, opt_state, ids_g, labels_g):
        _check_real(params)
        ids, labels = batch_slab(ids_g), batch_slab(labels_g)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        if pipeline_schedule == "1f1b":
            loss, grads = loss_and_grads_1f1b(leaves, ids, labels)
            grads = {k: g.to(params[k].dtype) for k, g in grads.items()}
        else:
            loss = fill_drain_loss(leaves, ids, labels)
            # the global mean over R batch slabs and sep sequence slabs;
            # the loss is seeded on the last stage (the others' copies
            # run the backward with zeros, so that every rank takes part
            # in the rings' backward exchanges)
            seed = (1.0 / (R * (sep if use_sep else 1))) if last_stage \
                else 0.0
            (loss * seed).backward()
            grads = {k: leaves[k].grad for k in params}
        grads = reduce_grads(grads)
        with torch.no_grad():
            rep = loss.detach().float().clone()
            for ax in ("dp", "sharding") + (("sep",) if use_sep else ()):
                if deg[ax] > 1:
                    C.all_reduce(rep, op="avg", group=group[ax])
            t = opt_state["step"] + 1
            tf = t.float()
            bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32,
                                             device=tf.device), tf)
            bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32,
                                             device=tf.device), tf)
            lists = ([], [], [], [])
            for k, p in params.items():
                ts = (p, grads[k], opt_state["m"][k], opt_state["v"][k])
                parts = range(p.shape[0]) if k in LAYER_KEYS else (None,)
                for l in parts:
                    sl = slice(None) if l is None else l
                    for dst, x in zip(lists, ts):
                        dst.append(x[sl])
            adamw_update_(*lists, lr=lr, beta1=ADAM_B1, beta2=ADAM_B2,
                          eps=ADAM_EPS, weight_decay=WEIGHT_DECAY, bc1=bc1,
                          bc2=bc2)
            opt_state["step"] = t
        return rep, params, opt_state

    def step_fn(params, opt_state, ids, labels):
        if k_steps == 1:
            return one_step(params, opt_state, ids, labels)
        if ids.shape[0] != k_steps or labels.shape[0] != k_steps:
            raise ValueError(f"k_steps={k_steps} needs ids/labels with a "
                             f"leading axis of {k_steps}")
        loss = None
        for i in range(k_steps):
            loss, params, opt_state = one_step(params, opt_state, ids[i],
                                               labels[i])
        return loss, params, opt_state

    def init_fn(seed: int = 0):
        full = init_stacked_params(config, seed, device=device)
        params = shard(full)
        del full
        opt = init_opt_state(params)
        for k in params:
            for slot in ("m", "v"):
                mark_slab(opt[slot][k], infos[k])
        return params, opt

    step_fn.shard, step_fn.gather = shard, gather
    return step_fn, init_fn


# ---------------------------------------------------------------------------
# Imperative model (l.93-191)
# ---------------------------------------------------------------------------

class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        h, d = config.hidden_size, config.head_dim
        kv = config.num_key_value_heads * d
        kw = dict(has_bias=False, dtype=config.dtype, device=device)
        col = dict(kw, gather_output=False)
        self.q_proj = ColumnParallelLinear(h, h, **col)
        self.k_proj = ColumnParallelLinear(h, kv, **col)
        self.v_proj = ColumnParallelLinear(h, kv, **col)
        self.o_proj = RowParallelLinear(h, h, input_is_parallel=True, **kw)

    def forward(self, x, cos, sin):
        b, s, _ = x.shape
        d = self.config.head_dim
        q = self.q_proj(x).reshape([b, s, -1, d])
        k = self.k_proj(x).reshape([b, s, -1, d])
        v = self.v_proj(x).reshape([b, s, -1, d])
        q, k = rope_ops.fused_rotary_position_embedding(q, k, cos, sin)
        out = NF.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape([b, s, -1]))


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(has_bias=False, dtype=config.dtype, device=device)
        col = dict(kw, gather_output=False)
        self.gate_proj = ColumnParallelLinear(h, m, **col)
        self.up_proj = ColumnParallelLinear(h, m, **col)
        self.down_proj = RowParallelLinear(m, h, input_is_parallel=True, **kw)

    def forward(self, x):
        return self.down_proj(NF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        kw = dict(epsilon=config.rms_norm_eps, dtype=config.dtype,
                  device=device)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = LlamaAttention(config, device=device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.mlp = LlamaMLP(config, device=device)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, dtype=config.dtype,
            device=device)
        self.layers = LayerList([LlamaDecoderLayer(config, device=device)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            dtype=config.dtype, device=device)

    def forward(self, input_ids):
        cfg = self.config
        dev = getattr(input_ids, "_value", input_ids).device
        cos, sin = rope_ops.build_rope_cache(input_ids.shape[1], cfg.head_dim,
                                             cfg.rope_theta, device=dev)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """The eager Llama: (B, S) ids → (B, S, V) logits, parameters in
    ``config.dtype`` on ``device`` (``None`` means the card and raises
    without one; pass ``device="cpu"`` for the plain kernel versions).
    With ``tie_word_embeddings`` the logits are ``h @ embedᵀ`` (l.181)
    and there is no ``lm_head``."""

    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        self.llama = LlamaModel(config, device=device)
        self.lm_head = None if config.tie_word_embeddings else \
            ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                 has_bias=False, dtype=config.dtype,
                                 device=device)

    def forward(self, input_ids):
        h = self.llama(input_ids)
        if self.lm_head is None:
            return h @ self.llama.embed_tokens.weight.t()
        return self.lm_head(h)

    def compute_loss(self, input_ids, labels):
        """Mean cross-entropy in fp32 over the positions whose label is
        not −100."""
        logits = self(input_ids)
        return NF.cross_entropy(logits.reshape([-1, self.config.vocab_size]),
                                labels.reshape([-1]), ignore_index=-100)
