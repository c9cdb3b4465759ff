"""The port's random stream (``paddle_tpu_torch.random`` over
``inference.prng``'s Threefry bits) against the JAX package's: after the
same ``seed``, ``rand``, ``uniform``, ``randint``, ``bernoulli``,
``randperm``, ``multinomial`` and the dropout mask of
``fused_bias_dropout_residual_layer_norm`` are equal bit for bit;
``randn``/``normal`` are ``sqrt(2)·erfinv`` of equal uniforms, held to
1e-6 (torch's ``erfinv`` and XLA's round differently in the last
bits). The port runs on the CPU."""

import numpy as np
import pytest

import paddle_tpu as JP
import paddle_tpu_torch as TP
from paddle_tpu_torch import random as TR
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _draws(fn, seed):
    out = []
    for p in (JP, TP):
        p.seed(seed)
        r = fn(p)
        out.append([np.asarray(t.numpy()) for t in r]
                   if isinstance(r, (list, tuple)) else np.asarray(r.numpy()))
    return out


_EXACT = {
    "rand": lambda p: [p.rand([5, 7]), p.rand([3])],
    "uniform": lambda p: [p.uniform([64], min=-2.0, max=3.0),
                          p.uniform([4, 4]), p.uniform([5], seed=11)],
    "randint": lambda p: [p.randint(0, 10, [50]), p.randint(-5, 1000, [3, 4]),
                          p.randint(7, shape=[6]), p.randint(3, 3, [2])],
    "bernoulli": lambda p: [p.bernoulli(p.full([40], 0.3)),
                            p.bernoulli(p.to_tensor(np.linspace(
                                0, 1, 17).astype(np.float32)))],
    "randperm": lambda p: [p.randperm(10), p.randperm(1), p.randperm(3000)],
    "multinomial": lambda p: [
        p.multinomial(p.to_tensor([0.1, 0.2, 0.3, 0.4]), 6, replacement=True),
        p.multinomial(p.to_tensor([0.1, 0.2, 0.3, 0.4]), 3),
        p.multinomial(p.to_tensor([[0.5, 0.25, 0.25]]), 1)],
}


@pytest.mark.parametrize("seed", [0, 123, 2 ** 31 - 5])
@pytest.mark.parametrize("kind", sorted(_EXACT))
def test_draws_equal_the_reference_bit_for_bit(kind, seed):
    ref, port = _draws(_EXACT[kind], seed)
    for r, t in zip(ref, port):
        assert t.dtype == r.dtype, (kind, t.dtype, r.dtype)
        np.testing.assert_array_equal(t, r)


@pytest.mark.parametrize("seed", [0, 99])
def test_normal_draws_within_erfinv_rounding(seed):
    def fn(p):
        return [p.randn([8, 9]), p.normal(1.0, 2.0, [33]),
                p.normal(p.to_tensor([0.0, 10.0]), p.to_tensor([1.0, 0.5])),
                p.create_parameter([4, 6])]
    ref, port = _draws(fn, seed)
    for r, t in zip(ref, port):
        np.testing.assert_allclose(t, r, rtol=0, atol=1e-6)


def test_the_stream_advances_and_restores():
    TP.seed(5)
    a = TP.rand([4]).numpy()
    state = TP.get_rng_state()
    b = TP.rand([4]).numpy()
    assert not np.array_equal(a, b)
    TP.set_rng_state(state)
    np.testing.assert_array_equal(TP.rand([4]).numpy(), b)
    assert state[0] == 1 and TR.next_key().shape == (2,)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_mask_equals_the_reference(mode):
    from paddle_tpu.incubate.nn import functional as JF
    from paddle_tpu_torch.incubate.nn import functional as TF
    rng = np.random.RandomState(3)
    x, r = (rng.randn(6, 32).astype(np.float32) for _ in range(2))
    g, b = (rng.randn(32).astype(np.float32) for _ in range(2))
    outs = []
    for p, F in ((JP, JF), (TP, TF)):
        p.seed(21)
        t = [p.to_tensor(a) for a in (x, r, g, b)]
        outs.append(np.asarray(F.fused_bias_dropout_residual_layer_norm(
            t[0], t[1], None, t[2], t[3], dropout_rate=0.25, training=True,
            mode=mode).numpy()))
        # the mask itself: zeroed inputs come out as the residual alone
        p.seed(21)
        ones = p.to_tensor(np.full_like(x, 1e3))
        outs.append(np.asarray(F.fused_bias_dropout_residual_layer_norm(
            ones, p.to_tensor(np.zeros_like(x)), dropout_rate=0.25,
            training=True, mode=mode).numpy()))
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[3], outs[1], rtol=1e-5, atol=1e-5)
    # torch tensors take the same draw
    TP.seed(21)
    import torch
    plain = TF.fused_bias_dropout_residual_layer_norm(
        *(torch.from_numpy(a) for a in (x, r)), None,
        *(torch.from_numpy(a) for a in (g, b)), dropout_rate=0.25,
        training=True, mode=mode)
    np.testing.assert_allclose(plain.numpy(), outs[0], rtol=1e-5, atol=1e-5)


def test_dropout_rate_zero_and_inference_draw_nothing():
    from paddle_tpu_torch.incubate.nn import functional as TF
    TP.seed(1)
    x = TP.ones([2, 8])
    TF.fused_bias_dropout_residual_layer_norm(x, x, dropout_rate=0.5,
                                              training=False)
    TF.fused_bias_dropout_residual_layer_norm(x, x, dropout_rate=0.0)
    assert TP.get_rng_state()[0] == 0
