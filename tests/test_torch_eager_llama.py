"""The imperative Llama of the PyTorch port
(``paddle_tpu_torch.models.llama.LlamaForCausalLM`` over the one-device
``meta_parallel`` layers) against the JAX package's eager model on the
CPU, with the JAX model's weights carried across by name
(``load_layer_state``): logits, loss and every parameter's gradient in
fp32, then main-grad training — ``MixPrecisionLayer`` under
``GradientMergeOptimizer(MixPrecisionOptimizer(AdamW(multi_precision=
True)), k_steps=2)`` — for 3 steps of 2 micro-batches, in fp32 and with
bf16 parameters. The port runs its plain kernel versions here;
chip_smoke.py (phase 18) holds the card against the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet import meta_optimizers as jmo
from paddle_tpu.distributed.fleet.utils import mix_precision_utils as jmpu
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmo
from paddle_tpu_torch.distributed.fleet.utils import (
    mix_precision_utils as tmpu)
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.optimizer.adamw import AdamW
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close

one_cpu_thread()

# fp32, two layers: products, norms and softmaxes summed in other orders
# by XLA and PyTorch (test_torch_ernie's tolerances)
OUT = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-3, atol=1e-6)
LR, STEPS, K = 1e-3, 3, 2
CFG = dict(num_hidden_layers=2)


def _np(a):
    return np.asarray(a._value if hasattr(a, "_value") else a, np.float32)


def _models(tie=False, bf16=False, seed=0):
    paddle.seed(seed)
    jnet = JL.LlamaForCausalLM(JL.llama_tiny(tie_word_embeddings=tie, **CFG))
    tnet = TL.LlamaForCausalLM(TL.llama_tiny(tie_word_embeddings=tie, **CFG),
                               device="cpu")
    TL.load_layer_state(tnet, {n: _np(p) for n, p in jnet.named_parameters()})
    if bf16:
        for p in jnet.parameters():
            p._value = p._value.astype(jnp.bfloat16)
        tnet.to(torch.bfloat16)
    return jnet, tnet


def _batch(shape, seed=1, vocab=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, shape).astype(np.int64)
    labels = np.roll(ids, -1, axis=-1)
    labels[..., -1] = -100                   # the last position is unscored
    return ids, labels


def test_parameter_names_and_shapes_equal_jax():
    jnet, tnet = _models()
    assert ({n: tuple(p.shape) for n, p in jnet.named_parameters()}
            == {n: tuple(p.shape) for n, p in tnet.named_parameters()})
    assert "llama.layers.1.self_attn.q_proj.weight" in dict(
        tnet.named_parameters())


def test_load_layer_state_refuses_missing_extra_and_misshapen():
    jnet, tnet = _models()
    state = {n: _np(p) for n, p in jnet.named_parameters()}
    with pytest.raises(ValueError, match="missing"):
        TL.load_layer_state(tnet, {k: v for k, v in state.items()
                                   if k != "lm_head.weight"})
    with pytest.raises(ValueError, match="unknown"):
        TL.load_layer_state(tnet, dict(state, extra=np.zeros(3)))
    with pytest.raises(ValueError, match="shape"):
        TL.load_layer_state(tnet, dict(state, **{
            "llama.norm.weight": np.zeros(3, np.float32)}))


@pytest.mark.parametrize("tie", [False, True], ids=["lm_head", "tied"])
def test_logits_loss_and_every_gradient_match_jax(tie):
    jnet, tnet = _models(tie=tie)
    ids, labels = _batch((2, 24))
    np.testing.assert_allclose(
        tnet(torch.from_numpy(ids)).detach().numpy(),
        _np(jnet(paddle.to_tensor(ids))), **OUT)
    want = jnet.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    want.backward()
    got = tnet.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    got.backward()
    jp = dict(jnet.named_parameters())
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jp[name].grad),
                                   err_msg=name, **GRADS)


def _train(jnet, tnet, on_main_grads):
    """``STEPS`` updates of ``K`` micro-batches on both sides through the
    main-grad wrappers; ``on_main_grads(step)`` runs after each step's
    last fold, before its update. Returns both sides' losses."""
    jw, tw = jmpu.MixPrecisionLayer(jnet), tmpu.MixPrecisionLayer(tnet)
    jo = jmo.GradientMergeOptimizer(jmpu.MixPrecisionOptimizer(jopt.AdamW(
        learning_rate=LR, parameters=jnet.parameters(),
        multi_precision=True)), k_steps=K)
    to = tmo.GradientMergeOptimizer(tmpu.MixPrecisionOptimizer(AdamW(
        parameters=tnet.parameters(), learning_rate=LR,
        multi_precision=True)), k_steps=K)
    ids, labels = _batch((STEPS, K, 2, 24), seed=2)
    losses = []
    for s in range(STEPS):
        for m in range(K):
            jl = jw.compute_loss(paddle.to_tensor(ids[s, m]),
                                 paddle.to_tensor(labels[s, m]))
            jl.backward()
            jw.accumulate_main_grads()
            tl = tw.compute_loss(torch.from_numpy(ids[s, m]),
                                 torch.from_numpy(labels[s, m]))
            tl.backward()
            tw.accumulate_main_grads()
            losses.append((float(jl), float(tl.detach())))
            if m == K - 1:
                on_main_grads(s)
            jo.step()
            to.step()
            jo.clear_grad()
            to.clear_grad()
    return np.array(losses), tmpu.unwrap_optimizer(to.inner_opt), \
        jmpu.unwrap_optimizer(jo.inner_opt)


def _main_grads(jnet, tnet):
    jp = dict(jnet.named_parameters())
    return [(name, p.main_grad, _np(jp[name].main_grad))
            for name, p in tnet.named_parameters()]


def test_main_grad_training_in_fp32_matches_jax():
    """Losses, every ``main_grad`` before each update and the weights
    after the three updates, fp32."""
    jnet, tnet = _models()

    def check(step):
        for name, got, want in _main_grads(jnet, tnet):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want,
                                       err_msg=f"step {step} {name}",
                                       **GRADS)

    losses, _, _ = _train(jnet, tnet, check)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], **LOSS)
    trained_weights_close(
        {n: p.detach() for n, p in tnet.named_parameters()},
        {n: torch.from_numpy(_np(p)) for n, p in jnet.named_parameters()},
        LR, STEPS, msg="eager llama fp32")


def test_main_grad_training_with_bf16_parameters_matches_jax():
    """bf16 parameters, fp32 main grads, fp32 master weights. The two
    packages round bf16 activations at other places, so the bounds are
    bf16's: losses within 2^-8; each ``main_grad`` within a relative L2
    error of 2^-4 of JAX's (a micro-batch dropped or not averaged is an
    error of 1/2); every master weight within 2·lr·steps of JAX's (AdamW
    moves each element at most ~lr a step), and each parameter's total
    update within a relative L2 error of 2^-2 (AdamW divides each
    element's gradient by its own rms, which magnifies the bf16
    differences of the smallest gradients). The bf16 weights are their
    masters' rounding."""
    jnet, tnet = _models(bf16=True)
    start = {n: p.detach().float().clone() for n, p in tnet.named_parameters()}

    def check(step):
        for name, got, want in _main_grads(jnet, tnet):
            assert got.dtype == torch.float32
            err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            assert err <= 2 ** -4, (step, name, err)

    losses, base, jbase = _train(jnet, tnet, check)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=2 ** -8)
    for key, (name, jp), p in zip(base._names, jnet.named_parameters(),
                                  tnet.parameters()):
        got = base.state[key]["master"]
        want = _np(jbase._accumulators[id(jp)]["master"])
        assert np.abs(got.numpy() - want).max() <= 2 * LR * STEPS, name
        upd, jupd = got - start[name], want - start[name].numpy()
        err = np.linalg.norm(upd.numpy() - jupd) / np.linalg.norm(jupd)
        assert err <= 2 ** -2, (name, err)
        assert torch.equal(p.detach(), got.to(torch.bfloat16)), name
