"""Main-grad training's wrappers in the PyTorch port
(``paddle_tpu_torch.distributed.fleet.utils.mix_precision_utils`` and
``...meta_optimizers.GradientMergeOptimizer``) against the JAX package's
on the CPU: the same small net (test_fleet_utils.py's, Linear-ReLU-
Linear) with the JAX net's weights carried across by name, the same
numpy inputs and the same sequence of calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet import meta_optimizers as jmo
from paddle_tpu.distributed.fleet.utils import mix_precision_utils as jmpu
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmo
from paddle_tpu_torch.distributed.fleet.utils import (
    mix_precision_utils as tmpu)
from paddle_tpu_torch.nn.common_layers import Linear, load_layer_state
from paddle_tpu_torch.optimizer.adamw import AdamW
from paddle_tpu_torch.optimizer.optimizer import SGD
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# fp32 nets: products summed in another order by XLA and PyTorch
F32 = dict(rtol=1e-5, atol=1e-6)


def _np(a):
    return np.asarray(a._value if hasattr(a, "_value") else a, np.float32)


def _nets(bf16=False, seed=0):
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tnet = torch.nn.Sequential(Linear(4, 8, device="cpu"), torch.nn.ReLU(),
                               Linear(8, 2, device="cpu"))
    load_layer_state(tnet, {n: _np(p) for n, p in jnet.named_parameters()})
    if bf16:
        for p in jnet.parameters():
            p._value = p._value.astype(jnp.bfloat16)
        tnet.to(torch.bfloat16)
    return jnet, tnet


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(4, 4).astype(np.float32) for _ in range(n)]


def _run_micro(jw, tw, x, dtype):
    """One micro-batch's forward, backward and fold on both sides."""
    jl = jw(paddle.to_tensor(x).astype(dtype)).astype("float32").sum()
    jl.backward()
    jw.accumulate_main_grads()
    tl = tw(torch.from_numpy(x).to(getattr(torch, dtype))).float().sum()
    tl.backward()
    tw.accumulate_main_grads()


def test_main_grad_after_three_bf16_micro_batches_matches_jax():
    """``MixPrecisionLayer`` folds each bf16 gradient into an fp32
    ``main_grad`` and clears ``.grad``, as the JAX wrapper does, over
    three different micro-batches. Tolerance: each side's bf16 gradient
    is one rounding of an fp32 value whose last bits differ between XLA
    and PyTorch, so a fold may differ by one bf16 step (2^-8 relative)
    of one micro-batch's gradient."""
    jnet, tnet = _nets(bf16=True)
    jw = jmpu.MixPrecisionLayer(jnet, dtype="bfloat16")
    tw = tmpu.MixPrecisionLayer(tnet)
    for x in _batches(3):
        _run_micro(jw, tw, x, "bfloat16")
        assert all(p.grad is None for p in tnet.parameters())
    jp = dict(jnet.named_parameters())
    for name, p in tnet.named_parameters():
        assert p.main_grad.dtype == torch.float32, name
        np.testing.assert_allclose(p.main_grad.numpy(),
                                   _np(jp[name].main_grad), rtol=2 ** -7,
                                   atol=2 ** -7, err_msg=name)


def test_layer_wrapper_delegates_to_the_module():
    _, tnet = _nets()
    tw = tmpu.MixPrecisionLayer(tnet)
    x = torch.randn(3, 4)
    torch.testing.assert_close(tw(x), tnet(x))
    torch.testing.assert_close(tw.forward(x), tnet(x))
    assert tw.training is tnet.training
    assert list(tw.parameters()) == list(tnet.parameters())


def _set_main_grads(jnet, tnet, seed):
    """The same main_grad on both sides for the first layer's weight and
    the last layer's bias; ``.grad`` (in the parameter's dtype) for the
    first layer's bias."""
    rng = np.random.RandomState(seed)
    jp = dict(jnet.named_parameters())
    tp = dict(tnet.named_parameters())
    for name in ("0.weight", "2.bias"):
        mg = rng.randn(*tp[name].shape).astype(np.float32)
        jp[name].main_grad = paddle.to_tensor(mg)
        tp[name].main_grad = torch.from_numpy(mg)
    g = rng.randn(*tp["0.bias"].shape).astype(np.float32)
    jp["0.bias"]._grad_value = jnp.asarray(g, jp["0.bias"]._value.dtype)
    tp["0.bias"].grad = torch.from_numpy(g).to(tp["0.bias"].dtype)


def _assert_weights_match(jnet, tnet, tol=F32):
    jp = dict(jnet.named_parameters())
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   _np(jp[name]), err_msg=name, **tol)


@pytest.mark.parametrize("set_to_zero", [False, True])
def test_optimizer_steps_from_main_grad_then_clears_like_jax(set_to_zero):
    """``MixPrecisionOptimizer(SGD)`` steps each parameter from its
    ``main_grad`` where it has one and from ``.grad`` otherwise, skips
    the rest, and ``clear_grad`` zeros ``main_grad`` in place
    (``set_to_zero``) or drops it, and drops every ``.grad``."""
    jnet, tnet = _nets()
    jopt_ = jmpu.MixPrecisionOptimizer(jopt.SGD(
        learning_rate=0.5, parameters=jnet.parameters(), weight_decay=0.1))
    topt = tmpu.MixPrecisionOptimizer(SGD(
        learning_rate=0.5, parameters=tnet.parameters(), weight_decay=0.1))
    w0 = tnet[2].weight.detach().clone()
    _set_main_grads(jnet, tnet, seed=2)
    jopt_.step()
    topt.step()
    _assert_weights_match(jnet, tnet)
    assert torch.equal(tnet[2].weight, w0)           # no gradient: skipped
    mg = tnet[0].weight.main_grad
    jopt_.clear_grad(set_to_zero=set_to_zero)
    topt.clear_grad(set_to_zero=set_to_zero)
    jp = dict(jnet.named_parameters())
    for name, p in tnet.named_parameters():
        assert p.grad is None and jp[name].grad is None, name
        jmg = jp[name].main_grad
        if jmg is None:
            assert getattr(p, "main_grad", None) is None, name
        else:
            assert p.main_grad is not None and not p.main_grad.any(), name
            assert not np.any(_np(jmg)), name
    if set_to_zero:
        assert tnet[0].weight.main_grad is mg        # zeroed in place


def test_optimizer_steps_bf16_parameters_from_fp32_main_grad():
    """A bf16 parameter steps from its fp32 ``main_grad`` (torch would
    refuse it as ``.grad``) onto its fp32 master weight, as JAX's
    multi-precision AdamW does; the main_grad is not rounded to bf16."""
    jnet, tnet = _nets(bf16=True)
    jopt_ = jmpu.MixPrecisionOptimizer(jopt.AdamW(
        learning_rate=1e-2, parameters=jnet.parameters(),
        multi_precision=True))
    topt = tmpu.MixPrecisionOptimizer(AdamW(
        parameters=tnet.parameters(), learning_rate=1e-2,
        multi_precision=True))
    for step in range(3):
        _set_main_grads(jnet, tnet, seed=10 + step)
        jopt_.step()
        topt.step()
        jopt_.clear_grad()
        topt.clear_grad()
    # fp32 master weights agree to fp32 rounding; the bf16 weights are
    # their one rounding, so they agree but for a rare flip of one step
    base = tmpu.unwrap_optimizer(topt)
    jacc = jmpu.unwrap_optimizer(jopt_)._accumulators
    stepped = 0
    for key, (name, jp) in zip(base._names, jnet.named_parameters()):
        if id(jp) not in jacc:               # never had a gradient
            assert key not in base.state, name
            continue
        stepped += 1
        np.testing.assert_allclose(base.state[key]["master"].numpy(),
                                   _np(jacc[id(jp)]["master"]),
                                   err_msg=name, **F32)
    assert stepped == 3
    _assert_weights_match(jnet, tnet, dict(rtol=2 ** -7, atol=1e-6))


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_over_main_grads_matches_jax(avg):
    """``GradientMergeOptimizer(MixPrecisionOptimizer(SGD), k_steps=2)``
    over four micro-batches: an update every second ``step``, from the
    two micro-batches' ``main_grad`` divided by k when ``avg``;
    ``clear_grad`` between them keeps the accumulation."""
    jnet, tnet = _nets()
    jw, tw = jmpu.MixPrecisionLayer(jnet), tmpu.MixPrecisionLayer(tnet)
    jgm = jmo.GradientMergeOptimizer(jmpu.MixPrecisionOptimizer(
        jopt.SGD(learning_rate=0.1, parameters=jnet.parameters())),
        k_steps=2, avg=avg)
    tgm = tmo.GradientMergeOptimizer(tmpu.MixPrecisionOptimizer(
        SGD(learning_rate=0.1, parameters=tnet.parameters())),
        k_steps=2, avg=avg)
    w0 = tnet[0].weight.detach().clone()
    for i, x in enumerate(_batches(4, seed=3)):
        _run_micro(jw, tw, x, "float32")
        jgm.step()
        tgm.step()
        jgm.clear_grad()
        tgm.clear_grad()
        if i == 0:
            assert torch.equal(tnet[0].weight, w0)   # accumulating
            assert tnet[0].weight.main_grad is not None
        if i % 2:
            assert getattr(tnet[0].weight, "main_grad", None) is None
        _assert_weights_match(jnet, tnet)
    assert not torch.equal(tnet[0].weight, w0)


def test_optimizer_needs_parameters():
    with pytest.raises(ValueError):
        SGD(learning_rate=0.1)
    _, tnet = _nets()
    with pytest.raises(ValueError):
        SGD(learning_rate=0.1, parameters=tnet.parameters(),
            named_parameters=tnet.named_parameters())
