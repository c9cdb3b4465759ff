"""GPT on the fused decoder stack: the PyTorch port
(``paddle_tpu_torch.models.gpt``) against the JAX package's
``paddle_tpu.models.gpt`` on the CPU, on the same numpy inputs, with the
JAX model's weights carried across by name (``params_from_numpy``). The
port runs its plain kernel versions here; ``chip_smoke.py`` phase 25
holds the card against the CPU."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.optimizer.adamw import AdamW
from paddle_tpu_torch.testing import key_bias_split, one_cpu_thread

one_cpu_thread()

# fp32 logits: the reference test's bound is 2e-3 (tests/test_gpt.py:74);
# the two stacks sum products, LayerNorms and softmaxes in other orders,
# and agree far inside it (observed max |diff| ~3e-7 at these widths)
LOGITS = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
# after 8 AdamW steps at lr 1e-3: a small fraction of one step
# (test_torch_ernie's bound)
PARAMS = dict(rtol=1e-4, atol=2e-6)
LR, STEPS = 1e-3, 8

#: hd 8 (the reference's gpt_tiny) and hd 16
WIDTHS = {"hd8": {}, "hd16": dict(hidden_size=64, num_attention_heads=4)}


def _pair(seed, **over):
    """The JAX model (seeded) and the port's, with the JAX weights."""
    paddle.seed(seed)
    jm = JG.GPTForCausalLM(JG.gpt_tiny(**over))
    tm = TG.GPTForCausalLM(TG.gpt_tiny(**over), device="cpu")
    TG.params_from_numpy(tm, {n: np.asarray(p._value)
                              for n, p in jm.named_parameters()})
    return jm, tm


def _ids(seed, shape, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def test_parameter_names_and_shapes_are_the_references():
    jm, tm = _pair(0)
    want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_logits_match_jax(width):
    jm, tm = _pair(5, **WIDTHS[width])
    ids = _ids(0, (2, 7))
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    got = tm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, **LOGITS)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("eos", [None, "hit"])
def test_generate_tokens_equal_jax(width, eos):
    """Greedy KV-cache generation (prefill + the fused decode path):
    identical tokens; with an ``eos_token_id`` that the stream hits,
    everything after the first EOS is EOS on both sides."""
    jm, tm = _pair(3, **WIDTHS[width])
    prompt = _ids(4, (3, 5))
    plain = jm.generate(prompt, max_new_tokens=8)
    eos_id = None
    if eos == "hit":
        eos_id = int(plain[0, 2])        # row 0 hits it at its 3rd token
    want = jm.generate(prompt, max_new_tokens=8, eos_token_id=eos_id)
    got = tm.generate(prompt, max_new_tokens=8, eos_token_id=eos_id)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    if eos_id is not None:
        assert (got[0, 3:] == eos_id).all()


def test_generate_refuses_more_than_the_position_table():
    _, tm = _pair(3)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(_ids(0, (1, 60)), max_new_tokens=8)


@pytest.mark.parametrize("offset", [0, 5, 60])
def test_position_offset_slice_matches_jax(offset):
    """The embeddings take positions ``[offset, offset + s)`` of the
    table; past its end the start clamps, as ``dynamic_slice_in_dim``
    clamps it."""
    jm, tm = _pair(1)
    ids = _ids(2, (2, 6))
    want = jm.gpt.embeddings(paddle.to_tensor(ids), position_offset=offset)
    got = tm.gpt.embeddings(torch.from_numpy(ids), position_offset=offset)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(want._value))


def test_decode_step_logits_match_jax():
    """A prefill that builds the cache, then two decode steps: the
    logits and the cache of each step."""
    jm, tm = _pair(7, **WIDTHS["hd16"])
    ids = _ids(8, (2, 6))
    jl, jkv = jm(paddle.to_tensor(ids), gen_cache_len=12)
    with torch.no_grad():
        tl, tkv = tm(torch.from_numpy(ids), gen_cache_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value), **LOGITS)
    for t in (6, 7):
        step = _ids(t, (2, 1))
        jl, jkv = jm(paddle.to_tensor(step), caches=jkv, time_step=t)
        with torch.no_grad():
            tl, tkv = tm(torch.from_numpy(step), caches=tkv, time_step=t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                                   **LOGITS)
        np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv._value),
                                   **LOGITS)


def test_adamw_steps_match_jax_eager():
    """8 steps of ``compute_loss`` + AdamW (lr 1e-3, wd 0.01) on both
    stacks from the same weights: losses, and every weight within a
    small fraction of one step (the key bias, whose true gradient is 0,
    within 2·lr·steps)."""
    jm, tm = _pair(1, num_hidden_layers=1)
    h = tm.config.hidden_size
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    to = AdamW(learning_rate=LR, parameters=tm.named_parameters())
    ids = _ids(2, (4, 16))
    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    labels[:, -1] = -100
    losses = []
    for i in range(STEPS):
        want = jm.compute_loss(paddle.to_tensor(ids),
                               paddle.to_tensor(labels))
        want.backward()
        jo.step()
        jo.clear_grad()
        to.clear_grad()
        got = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
        got.backward()
        to.step()
        np.testing.assert_allclose(float(got), float(want), err_msg=str(i),
                                   **LOSS)
        losses.append(float(got))
    assert losses[-1] < losses[0]
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        gk, got = key_bias_split(name, p.detach(), h)
        wk, want = key_bias_split(
            name, torch.from_numpy(np.asarray(jparams[name]._value)), h)
        if gk is not None:
            torch.testing.assert_close(gk, wk, rtol=0, atol=2 * LR * STEPS)
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name,
                                   **PARAMS)


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        TG.GPTForCausalLM(TG.gpt_tiny())


def test_init_is_seeded_with_the_reference_distributions():
    def make(seed):
        return dict(TG.init(TG.GPTForCausalLM(TG.gpt_tiny(), device="cpu"),
                            seed).named_parameters())

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["gpt.decoder.qkv_weights.0"],
                           c["gpt.decoder.qkv_weights.0"])
    assert torch.equal(a["gpt.decoder.ln_scales.1"], torch.ones(32))
    assert not a["gpt.decoder.ffn1_biases.0"].any()
    assert 0.015 < a["gpt.embeddings.word_embeddings"].std() < 0.025
    w = a["gpt.decoder.ffn1_weights.0"]
    limit = (6.0 / (32 + 64)) ** 0.5
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
