"""The fused decoder stack and the rest of ``incubate.nn.functional``:
the port (``paddle_tpu_torch.ops.fused_transformer_block``,
``incubate.nn.layer.fused_transformer.FusedMultiTransformer``,
``incubate.nn.functional``) against the JAX package's on the CPU, on the
same numpy inputs (the stacked weights of ``init_stacked_block_params``
are the same numpy draws on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.incubate.nn.layer import fused_transformer as JFT
from paddle_tpu.ops import fused_transformer_block as JB
import paddle_tpu.quantization as JQ
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.incubate.nn.layer import fused_transformer as TFT
from paddle_tpu_torch.ops import fused_transformer_block as TB
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# fp32, two layers: sums in other orders (test_torch_ernie's bound)
OUT = dict(rtol=1e-4, atol=1e-5)
L, B, S, H, NH, FF = 2, 3, 10, 32, 4, 64


def _params():
    jp = JB.init_stacked_block_params(L, H, FF, seed=3)
    tp = TB.init_stacked_block_params(L, H, FF, seed=3, device="cpu")
    return jp, tp


def _x(seed=0, shape=(B, S, H)):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


def _np(a):
    return np.asarray(a._value if hasattr(a, "_value") else a)


def test_init_stacked_block_params_is_the_references_bits():
    jp, tp = _params()
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)


@pytest.mark.parametrize("cache_len", [None, 16])
@pytest.mark.parametrize("masked", [False, True], ids=["flash", "mask"])
def test_prefill_matches_jax(cache_len, masked):
    """Prefill through the causal flash path, or the plain path under an
    additive mask; with ``max_cache_len`` the padded cache too."""
    jp, tp = _params()
    x = _x()
    mask = None
    if masked:
        mask = np.where(np.random.RandomState(1).rand(B, 1, 1, S) < 0.2,
                        -1e4, 0.0).astype(np.float32)
    jout, jkv = JB.fused_multi_transformer_array(
        jnp.asarray(x), jp, num_heads=NH,
        attn_mask=None if mask is None else jnp.asarray(mask),
        max_cache_len=cache_len)
    tout, tkv = TB.fused_multi_transformer_array(
        torch.from_numpy(x), tp, num_heads=NH,
        attn_mask=None if mask is None else torch.from_numpy(mask),
        max_cache_len=cache_len)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **OUT)
    if cache_len is None:
        assert jkv is None and tkv is None
    else:
        assert tuple(tkv.shape) == (L, 2, B, NH, cache_len, H // NH)
        np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), **OUT)


def test_prefill_longer_than_the_cache_raises():
    _, tp = _params()
    with pytest.raises(ValueError, match="exceeds cache length"):
        TB.fused_multi_transformer_array(torch.from_numpy(_x()), tp,
                                         num_heads=NH, max_cache_len=S - 1)


@pytest.mark.parametrize("span", [1, 3])
@pytest.mark.parametrize("at", [S, 14], ids=["next", "clamped"])
def test_decode_at_time_step_matches_jax(span, at):
    """Decode ``span`` new tokens at ``time_step`` against a prefilled
    cache of 16 slots: the output and the whole cache. At time_step 14 a
    3-token span does not fit: the write's start clamps to 13, as
    ``dynamic_update_slice`` clamps it. The port writes the cache in
    place and returns it."""
    jp, tp = _params()
    x = _x()
    _, jkv = JB.fused_multi_transformer_array(jnp.asarray(x), jp,
                                              num_heads=NH, max_cache_len=16)
    _, tkv = TB.fused_multi_transformer_array(torch.from_numpy(x), tp,
                                              num_heads=NH, max_cache_len=16)
    new = _x(2, (B, span, H))
    jout, jkv2 = JB.fused_multi_transformer_array(
        jnp.asarray(new), jp, num_heads=NH, cache_kv=jkv, time_step=at)
    with torch.no_grad():
        tout, tkv2 = TB.fused_multi_transformer_array(
            torch.from_numpy(new), tp, num_heads=NH, cache_kv=tkv,
            time_step=at)
    assert tkv2 is tkv
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **OUT)
    np.testing.assert_allclose(tkv2.numpy(), np.asarray(jkv2), **OUT)


def test_decode_without_a_cache_raises():
    _, tp = _params()
    with pytest.raises(ValueError, match="requires cache_kv"):
        TB.fused_multi_transformer_array(torch.from_numpy(_x()), tp,
                                         num_heads=NH, time_step=3)


def test_ragged_seq_lens_match_jax():
    """A ragged batch: rows prefilled to 4, 7 and 10 tokens of a padded
    prefill, then a 2-token decode at the padded length with
    ``seq_lens``: each row attends to its own prefix and the new span."""
    jp, tp = _params()
    x = _x()
    _, jkv = JB.fused_multi_transformer_array(jnp.asarray(x), jp,
                                              num_heads=NH, max_cache_len=16)
    _, tkv = TB.fused_multi_transformer_array(torch.from_numpy(x), tp,
                                              num_heads=NH, max_cache_len=16)
    lens = np.asarray([4, 7, 10], np.int32)
    new = _x(3, (B, 2, H))
    jout, jkv2 = JB.fused_multi_transformer_array(
        jnp.asarray(new), jp, num_heads=NH, cache_kv=jkv, time_step=S,
        seq_lens=jnp.asarray(lens))
    with torch.no_grad():
        tout, tkv2 = TB.fused_multi_transformer_array(
            torch.from_numpy(new), tp, num_heads=NH, cache_kv=tkv,
            time_step=S, seq_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **OUT)
    np.testing.assert_allclose(tkv2.numpy(), np.asarray(jkv2), **OUT)


def test_layer_names_shapes_and_outputs_match_jax():
    """``FusedMultiTransformer``: the reference's parameter names and
    shapes; its weights load by name and give the JAX layer's outputs,
    prefill with a cache and one decode step."""
    paddle.seed(4)
    jl = JFT.FusedMultiTransformer(H, NH, FF, num_layers=L)
    tl = TFT.FusedMultiTransformer(H, NH, FF, num_layers=L, device="cpu")
    want = {n: tuple(p.shape) for n, p in jl.named_parameters()}
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} == want
    from paddle_tpu_torch.nn.common_layers import load_layer_state
    load_layer_state(tl, {n: _np(p) for n, p in jl.named_parameters()})
    x = _x(5)
    jout, jkv = jl(paddle.to_tensor(x), gen_cache_len=12)
    with torch.no_grad():
        tout, tkv = tl(torch.from_numpy(x), gen_cache_len=12)
    np.testing.assert_allclose(tout.numpy(), _np(jout), **OUT)
    step = _x(6, (B, 1, H))
    jout = jl(paddle.to_tensor(step), caches=jkv, time_step=S)[0]
    with torch.no_grad():
        tout = tl(torch.from_numpy(step), caches=tkv, time_step=S)[0]
    np.testing.assert_allclose(tout.numpy(), _np(jout), **OUT)
    assert torch.is_tensor(tl(torch.from_numpy(x)))   # no cache asked


def test_layer_refuses_post_ln():
    with pytest.raises(NotImplementedError, match="post-LN"):
        TFT.FusedMultiTransformer(H, NH, FF, normalize_before=False,
                                  device="cpu")


def test_functional_stack_matches_jax():
    jp, tp = _params()
    x = _x(7)
    jout, jkv = JF.fused_multi_transformer(
        paddle.to_tensor(x), {k: paddle.to_tensor(np.asarray(v))
                              for k, v in jp.items()},
        num_heads=NH, max_cache_len=12)
    tout, tkv = TF.fused_multi_transformer(torch.from_numpy(x), tp,
                                           num_heads=NH, max_cache_len=12)
    np.testing.assert_allclose(tout.numpy(), _np(jout), **OUT)
    np.testing.assert_allclose(tkv.numpy(), _np(jkv), **OUT)
    # per-layer lists give the stacked tensors' result
    lists = {k: list(v) for k, v in tp.items()}
    np.testing.assert_array_equal(
        TF.fused_multi_transformer(torch.from_numpy(x), lists,
                                   num_heads=NH).numpy(),
        TF.fused_multi_transformer(torch.from_numpy(x), tp,
                                   num_heads=NH).numpy())


def test_fused_rms_norm_matches_jax():
    x, w = _x(8), 1 + 0.1 * _x(9, (H,))
    want = JF.fused_rms_norm(paddle.to_tensor(x), paddle.to_tensor(w), 1e-5)
    got = TF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT)


@pytest.mark.parametrize("case", ["qkv_4d_cache", "position_ids", "q_only"])
def test_fused_rotary_position_embedding_matches_jax(case):
    """The reference's argument order (q, k, v, sin, cos, ...): Paddle's
    (1, S, 1, D) caches, gathered by ``position_ids``, or one input."""
    D = 8
    q, k, v = (_x(s, (2, 6, 4, D)) for s in (10, 11, 12))
    ang = np.outer(np.arange(6), 1.0 / 10000 ** (np.arange(0, D, 2) / D))
    emb = np.concatenate([ang, ang], -1).astype(np.float32)
    cos, sin = np.cos(emb), np.sin(emb)
    kw = {}
    if case == "qkv_4d_cache":
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    if case == "position_ids":
        pid = np.asarray([[5, 4, 3, 2, 1, 0], [0, 0, 1, 1, 2, 2]], np.int64)
        kw = dict(position_ids=pid)
    ins = (q, None, None) if case == "q_only" else (q, k, v)

    def run(wrap, f):
        args = [None if a is None else wrap(a) for a in ins]
        extra = {n: wrap(a) for n, a in kw.items()}
        return f(*args, sin=wrap(sin), cos=wrap(cos), **extra)

    want = run(paddle.to_tensor, JF.fused_rotary_position_embedding)
    got = run(torch.from_numpy, TF.fused_rotary_position_embedding)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), _np(w), **OUT)
    with pytest.raises(NotImplementedError):
        TF.fused_rotary_position_embedding(
            torch.from_numpy(q), sin=torch.from_numpy(sin),
            cos=torch.from_numpy(cos), use_neox_rotary_style=False)


@pytest.mark.parametrize("rate,training,mode", [
    (0.0, True, "upscale_in_train"), (0.3, False, "upscale_in_train"),
    (0.3, False, "downscale_in_infer")])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(rate, training,
                                                            mode):
    x, r = _x(13), _x(14)
    b, g, be = _x(15, (H,)), 1 + 0.1 * _x(16, (H,)), _x(17, (H,))
    want = JF.fused_bias_dropout_residual_layer_norm(
        *(paddle.to_tensor(a) for a in (x, r, b, g, be)), dropout_rate=rate,
        training=training, mode=mode)
    got = TF.fused_bias_dropout_residual_layer_norm(
        *(torch.from_numpy(a) for a in (x, r, b, g, be)), dropout_rate=rate,
        training=training, mode=mode)
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT)


def test_fused_softmax_masks_match_jax():
    x = _x(18, (2, 3, 5, 7))
    mask = np.where(_x(19, (2, 1, 5, 7)) > 0.5, -1e4, 0.0).astype(
        np.float32)
    want = JF.fused_softmax_mask(paddle.to_tensor(x), paddle.to_tensor(mask),
                                 scale=0.5)
    got = TF.fused_softmax_mask(torch.from_numpy(x), torch.from_numpy(mask),
                                scale=0.5)
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT)
    want = JF.fused_softmax_mask_upper_triangle(paddle.to_tensor(x),
                                                scale=0.5)
    got = TF.fused_softmax_mask_upper_triangle(torch.from_numpy(x),
                                               scale=0.5)
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT)


def test_int8_and_training_dropout_raise_not_ported():
    """The int8 stack runs (``int8=True`` over quantized weights, with a
    calibrated range on one projection): the JAX stack's output on the
    same int8 weights."""
    jp, tp = _params()
    for params, wq in ((jp, None), (tp, None)):
        for w in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
            pairs = [(JQ if params is jp else TQ).weight_quantize(
                params[w][i], **({} if params is jp else {"device": "cpu"}))
                for i in range(L)]
            stack = jnp.stack if params is jp else torch.stack
            params[w + "_q"] = stack([q for q, _ in pairs])
            params[w + "_scale"] = stack([s for _, s in pairs])
        params["out_w_in_scale"] = (jnp.asarray([2.0, 3.0], jnp.float32)
                                    if params is jp else
                                    torch.tensor([2.0, 3.0]))
    jout, _ = JB.fused_multi_transformer_array(jnp.asarray(_x()), jp,
                                               num_heads=NH, int8=True)
    tout, _ = TB.fused_multi_transformer_array(torch.from_numpy(_x()), tp,
                                               num_heads=NH, int8=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **OUT)
    # training dropout runs now (the eager key stream is ported): the same
    # seed draws the JAX package's mask, so the outputs agree
    import paddle_tpu_torch
    xn = _x()
    x = torch.from_numpy(xn)
    paddle.seed(5)
    want = JF.fused_bias_dropout_residual_layer_norm(
        paddle.to_tensor(xn), paddle.to_tensor(xn), dropout_rate=0.1,
        training=True)
    paddle_tpu_torch.seed(5)
    got = TF.fused_bias_dropout_residual_layer_norm(x, x, dropout_rate=0.1,
                                                    training=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **OUT)
