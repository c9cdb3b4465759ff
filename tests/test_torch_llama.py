"""Llama serving step: the PyTorch port (``paddle_tpu_torch.models.llama``,
``ops.rope``) against the JAX package on the same numpy inputs, with the
JAX package's weights carried across through numpy. The port runs on the
CPU (its plain kernel versions)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import rope as jrope
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import rope as trope

# ragged_step in fp32: two layers of products, norms and softmax summed
# in different orders by XLA and PyTorch
STEP = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d,base,offset", [(64, 16, 10000.0, 0),
                                               (33, 128, 10000.0, 7),
                                               (16, 64, 500000.0, 0)])
def test_rope_cache_matches_jax(seq, d, base, offset):
    jc, js = jrope.build_rope_cache(seq, d, base, position_offset=offset)
    tc, ts = trope.build_rope_cache(seq, d, base, position_offset=offset,
                                    device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("batched_cos", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(batched_cos, dtype):
    rng = np.random.RandomState(0)
    B, S, H, D = 2, 5, 3, 16
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    pos = rng.randint(0, 40, (B, S)) if batched_cos else np.arange(S)
    cos_f, sin_f = jrope.build_rope_cache(64, D)
    cos = np.asarray(cos_f)[pos]
    sin = np.asarray(sin_f)[pos]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk = jrope.apply_rope_array(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                    jnp.asarray(cos), jnp.asarray(sin))
    tq, tk = trope.apply_rope_array(torch.from_numpy(q).to(tdt),
                                    torch.from_numpy(k).to(tdt),
                                    torch.from_numpy(cos),
                                    torch.from_numpy(sin))
    assert tq.dtype == tdt and tk.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=0, atol=3e-2)          # one bf16 rounding of O(1) values
    for t_out, j_out in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(t_out.float().numpy(),
                                   np.asarray(j_out.astype(jnp.float32)),
                                   **tol)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama2_7b", "llama_tiny"])
def test_configs_and_param_count_match_jax(name):
    jc = getattr(JL, name)()
    tc = getattr(TL, name)()
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.head_dim == jc.head_dim
    assert TL.param_count(tc) == JL.param_count(jc)


def test_init_params_seeded_layout():
    cfg = TL.llama_tiny(num_hidden_layers=2, num_key_value_heads=2)
    a = TL.init_params(cfg, seed=7, device="cpu")
    b = TL.init_params(cfg, seed=7, device="cpu")
    c = TL.init_params(cfg, seed=8, device="cpu")
    jshapes = {k: tuple(v.shape) for k, v in
               JL.init_stacked_params(JL.llama_tiny(
                   num_hidden_layers=2, num_key_value_heads=2)).items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == jshapes
    assert sum(v.numel() for v in a.values()) == TL.param_count(cfg)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["wq"], c["wq"])
    assert torch.equal(a["ln1"], torch.ones_like(a["ln1"]))
    assert abs(float(a["w_up"].std()) - 0.02) < 2e-3


def test_params_from_numpy_carries_jax_weights():
    jcfg = JL.llama_tiny(num_hidden_layers=1, dtype=jnp.bfloat16)
    jp = JL.init_stacked_params(jcfg, seed=1)
    cfg = TL.llama_tiny(num_hidden_layers=1, dtype=torch.bfloat16)
    tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              cfg, device="cpu")
    for k, v in jp.items():
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[k].float().numpy(), np.asarray(v.astype(jnp.float32)))


def test_params_from_numpy_refuses_int8_and_bad_shapes():
    cfg = TL.llama_tiny(num_hidden_layers=1)
    with pytest.raises(NotImplementedError, match="quantization"):
        TL.params_from_numpy({"wq": {"q": np.zeros((1, 64, 64), np.int8),
                                     "scale": np.ones((1, 64))}}, cfg,
                             device="cpu")
    with pytest.raises(ValueError, match="shape"):
        TL.params_from_numpy({"wq": np.zeros((1, 64, 32), np.float32)},
                             cfg, device="cpu")


# ---------------------------------------------------------------------------
# ragged_step on the mixed layout
# ---------------------------------------------------------------------------

def _step_inputs(seed=0, NPAGES=32, PAGE=4, nkv=4):
    """JAX-made weights and a mixed packed batch: row 0 decodes at
    position 8, row 1 prefills 6 tokens cold, row 2 a warm suffix of 3
    tokens at q_start 5, row 3 is idle, then two pad slots. Pools start
    from random contents (the warm/decode rows' cached prefix)."""
    jcfg = JL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    cfg = TL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    params = {k: np.asarray(v) for k, v in
              JL.init_stacked_params(jcfg, seed=seed).items()}
    rng = np.random.RandomState(seed)
    pool = (2, NPAGES, PAGE, nkv, cfg.head_dim)
    k_pages = rng.randn(*pool).astype(np.float32)
    v_pages = rng.randn(*pool).astype(np.float32)
    mgr = jpa.PagedKVCacheManager(1, NPAGES, PAGE, 1, 1)
    for sid, n in enumerate((9, 6, 8, 1)):
        mgr.allocate(sid, n)
    bt, _ = mgr.block_tables([0, 1, 2, 3])
    token_row = np.array([0] + [1] * 6 + [2] * 3 + [-1, -1], np.int32)
    positions = np.array([8] + list(range(6)) + [5, 6, 7] + [0, 0],
                         np.int32)
    ids = rng.randint(1, cfg.vocab_size, len(token_row)).astype(np.int32)
    ids[token_row < 0] = 0
    kv_lens = np.array([9, 6, 8, 0], np.int32)
    last_idx = np.array([0, 6, 9, 0], np.int32)
    arrays = (ids, token_row, positions, kv_lens, last_idx)
    return jcfg, cfg, params, arrays, k_pages, v_pages, bt.astype(np.int32)


def _run_both(seed, nkv, monkeypatch=None):
    jcfg, cfg, params, arrays, kp, vp, bt = _step_inputs(seed, nkv=nkv)
    jout = JL.ragged_step({k: jnp.asarray(v) for k, v in params.items()},
                          *(jnp.asarray(a) for a in arrays),
                          jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                          jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = TL.ragged_step(TL.params_from_numpy(params, cfg, device="cpu"),
                          *(torch.from_numpy(a) for a in arrays), tk, tv,
                          torch.from_numpy(bt), cfg)
    assert tout[1] is tk and tout[2] is tv      # pools updated in place
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


@pytest.mark.parametrize("seed,nkv", [(0, 4), (1, 2)])
def test_ragged_step_matches_jax_array_path(seed, nkv):
    """Logits and both updated pools against the JAX step on its XLA
    attention path. Page 0 is left out of the pool comparison: it is the
    pad page that pad slots write into, and the JAX array path's pad
    rows carry a masked-uniform attention average where the port (like
    the kernels) writes zeros, so from layer 2 on the pad K/V differ."""
    (jl, jk, jv), (tl, tk, tv) = _run_both(seed, nkv)
    assert tl.shape == (4, 256)
    np.testing.assert_allclose(tl, jl, **STEP)
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **STEP)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], **STEP)


def test_ragged_step_matches_jax_pallas_kernel_path(monkeypatch):
    """The same step with the JAX side's attention through the Pallas
    ragged kernel (interpret mode): pad rows are zero on both sides, so
    the whole pools — page 0 included — agree."""
    real = jpa.ragged_paged_attention_pallas

    def pallas(q, kp, vp, bt, tr, pos, kvl, scale=None, mesh=None,
               mp_axis="mp"):
        return real(q, kp, vp, bt, tr, pos, kvl, scale, interpret=True)

    monkeypatch.setattr(jpa, "ragged_paged_attention", pallas)
    (jl, jk, jv), (tl, tk, tv) = _run_both(2, 2)
    np.testing.assert_allclose(tl, jl, **STEP)
    np.testing.assert_allclose(tk, jk, **STEP)
    np.testing.assert_allclose(tv, jv, **STEP)


def test_ragged_step_clamps_positions_past_the_table():
    """A position past the table span is clamped to its last slot for
    rope, the scatter and the mask, as in the JAX step."""
    jcfg, cfg, params, arrays, kp, vp, bt = _step_inputs(3)
    ids, token_row, positions, kv_lens, last_idx = arrays
    span = bt.shape[1] * 4
    positions = positions.copy()
    positions[0] = span + 5                      # over-decoded token
    kv_lens = kv_lens.copy()
    kv_lens[0] = span
    arrays = (ids, token_row, positions, kv_lens, last_idx)
    jl, jk, _ = JL.ragged_step({k: jnp.asarray(v) for k, v in params.items()},
                               *(jnp.asarray(a) for a in arrays),
                               jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(bt), jcfg)
    tk = torch.from_numpy(kp.copy())
    tl, tk, _ = TL.ragged_step(TL.params_from_numpy(params, cfg, "cpu"),
                               *(torch.from_numpy(a) for a in arrays), tk,
                               torch.from_numpy(vp.copy()),
                               torch.from_numpy(bt), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **STEP)


def test_ragged_step_refuses_int8_weights():
    jcfg, cfg, params, arrays, kp, vp, bt = _step_inputs(0)
    tp = TL.params_from_numpy(params, cfg, "cpu")
    tp["wq"] = {"q": tp["wq"].to(torch.int8), "scale": torch.ones(2, 64)}
    with pytest.raises(NotImplementedError, match="quantization"):
        TL.ragged_step(tp, *(torch.from_numpy(a) for a in arrays),
                       torch.from_numpy(kp), torch.from_numpy(vp),
                       torch.from_numpy(bt), cfg)
