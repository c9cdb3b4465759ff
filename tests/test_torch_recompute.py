"""``paddle_tpu_torch.distributed.fleet.recompute`` against the run
without recompute and against ``paddle_tpu``'s recompute.

Dropout draws from the port's key stream, which torch's checkpoint
does not replay: the port puts the stream back for the recomputation.
With dropout on, the loss and every gradient equal those of the run
without recompute bit for bit, and the stream's counter afterwards is
the reference's (its ``jax.checkpoint`` advances it once a call, as
the call without recompute does). The reference's own numbers agree at
fp32 tolerance, its masks bit for bit (the same seed, the same draws).
"""

import jax  # noqa: F401  (the conftest's CPU backend)
import numpy as np
import pytest
import torch

import paddle_tpu as rpaddle
import paddle_tpu.random as rrandom
from paddle_tpu.distributed.fleet import _recompute_mod as rrecompute

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.random as trandom
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import _recompute_mod as trc
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# fp32 gradients through two Linear/GELU layers: XLA's and PyTorch's
# GELU and products round differently by a few ulp
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    tpaddle.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _net(pkg, width=8, depth=2, p=0.5):
    pkg.seed(0)
    layers = []
    for _ in range(depth):
        layers += [pkg.nn.Linear(width, width), pkg.nn.Dropout(p),
                   pkg.nn.GELU()]
    return pkg.nn.Sequential(*layers)


def _x(pkg):
    x = pkg.to_tensor(np.random.RandomState(1).randn(4, 8)
                      .astype(np.float32))
    x.stop_gradient = False
    return x


def _grads(pkg, net, x):
    return [np.asarray(p.grad.numpy()) for p in net.parameters()] + \
        [np.asarray(x.grad.numpy())]


def _run(pkg, rand_mod, how, seed=5):
    """Loss, gradients and the stream's counter after the forward and
    after the backward. Both packages draw once after seeding: the
    reference makes its seeded base key lazily, and a key first made
    inside its ``jax.checkpoint`` trace leaks as a tracer, so that the
    next draw after the call raises."""
    net, x = _net(pkg), _x(pkg)
    pkg.seed(seed)
    pkg.rand([1])   # makes the reference's lazy base key outside its trace
    if how == "plain":
        y = net(x)
    elif how == "recompute":
        y = (tfleet if pkg is tpaddle else rrecompute).recompute(net, x)
    else:
        segs = {"segments": 2}
        y = (trc if pkg is tpaddle else rrecompute).recompute_sequential(
            segs, net, x)
    after_fwd = rand_mod._state.counter
    loss = (y * y).sum()
    loss.backward()
    return (float(loss.numpy()), _grads(pkg, net, x), after_fwd,
            rand_mod._state.counter)


@pytest.mark.parametrize("how", ["recompute", "sequential"])
def test_dropout_gradients_equal_the_run_without_recompute(how):
    want = _run(tpaddle, trandom, "plain")
    got = _run(tpaddle, trandom, how)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    # the forward advances the stream once a draw; the backward draws
    # nothing
    assert got[2:] == want[2:] and got[2] == got[3]


@pytest.mark.parametrize("how", ["recompute", "sequential"])
def test_stream_position_and_numbers_are_the_references(how):
    want = _run(rpaddle, rrandom, how)
    got = _run(tpaddle, trandom, how)
    assert got[2:] == want[2:]
    assert want[2:] == _run(rpaddle, rrandom, "plain")[2:]
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **TOL)


def test_draws_after_the_recomputed_call_are_the_references():
    """A draw after the recomputed call is the reference's."""
    draws = []
    for pkg, rc in ((rpaddle, rrecompute), (tpaddle, trc)):
        net, x = _net(pkg), _x(pkg)
        pkg.seed(11)
        draws.append(np.asarray(pkg.rand([2]).numpy()))   # see _run
        (rc.recompute(net, x) ** 2).sum().backward()
        draws.append(np.asarray(pkg.rand([16]).numpy()))
    np.testing.assert_array_equal(draws[0], draws[2])
    np.testing.assert_array_equal(draws[1], draws[3])


def test_recompute_inside_a_compiled_programs_key_scope():
    """Inside a compiled program's body the stream folds the body's key:
    the recomputation replays that key's draws too."""
    key = trandom.prng.prng_key(77)
    out = []
    for use_rc in (False, True):
        net, x = _net(tpaddle), _x(tpaddle)
        with trandom.traced_key_scope(key):
            y = tfleet.recompute(net, x) if use_rc else net(x)
            (y * y).sum().backward()
            pos = trandom._state.counter
        out.append((_grads(tpaddle, net, x), pos))
    assert out[0][1] == out[1][1]
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)


class _WithAux(tpaddle.nn.Layer):
    """A layer that writes an auxiliary loss onto itself, as the MoE
    gate does."""

    def __init__(self):
        super().__init__()
        self.fc = tpaddle.nn.Linear(8, 8)
        self.drop = tpaddle.nn.Dropout(0.5)
        self.l_aux = None

    def forward(self, x, scale=1.0):
        h = self.drop(self.fc(x))
        self.l_aux = (h * h).mean() * scale
        return h, h.sum()


def test_side_channel_values_and_outputs_survive_the_recomputation():
    out = []
    for use_rc in (False, True):
        tpaddle.seed(0)
        layer = _WithAux()
        x = _x(tpaddle)
        tpaddle.seed(3)
        h, s = (tfleet.recompute(layer, x, scale=2.0) if use_rc
                else layer(x, scale=2.0))
        aux = layer.l_aux
        (h.sum() + s + aux).backward()
        assert layer.l_aux is aux     # the recomputation's write is undone
        out.append((float(aux.numpy()), _grads(tpaddle, layer, x)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_closure_and_partial_layers_get_gradients():
    import functools
    net = _net(tpaddle, p=0.0)
    x = _x(tpaddle)
    assert trc._find_layers(lambda v: net(v)) == [net]
    assert trc._find_layers(functools.partial(net.forward)) == [net]
    y = tfleet.recompute(lambda v: net(v), x)
    y.sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    got = trc.recompute_hybrid({}, net, x)
    np.testing.assert_array_equal(np.asarray(got.numpy()),
                                  np.asarray(y.numpy()))


def test_amp_optimizer_over_a_recomputed_model_steps_as_the_plain_one():
    """Phase 35 (c) in small: a recomputed model with dropout under
    ``AMPOptimizer`` takes the steps of the plain one, bit for bit."""
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as M
    weights = []
    for use_rc in (False, True):
        net = _net(tpaddle)
        opt = M.AMPOptimizer(tpaddle.optimizer.AdamW(
            learning_rate=1e-2, parameters=net.parameters()), {"level": "O1"})
        tpaddle.seed(9)
        for i in range(3):
            x = _x(tpaddle)
            y = tfleet.recompute(net, x) if use_rc else net(x)
            (y * y).mean().backward()
            opt.step()
            opt.clear_grad()
        weights.append([p.detach().clone() for p in net.parameters()])
    for a, b in zip(*weights):
        assert torch.equal(a, b)
