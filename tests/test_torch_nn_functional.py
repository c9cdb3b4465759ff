"""``paddle_tpu_torch.nn.functional`` against ``paddle_tpu.nn.functional``
on the CPU, the activations, dropouts, linear family, convolutions,
pools and norms (``torch_functional_cases.CASES``; padding, resizing,
the losses and attention are ``test_torch_nn_losses.py``): one case per
function (and per option family where the function has several), the
same numpy inputs made Tensors in each package, forward outputs and,
where the function is differentiable, the gradients of ``Σ out·c`` with
respect to its float inputs. The random functions run under one seed in
both packages: the dropouts and ``rrelu`` match bit for bit (the same
Threefry masks), ``gumbel_softmax`` to its ``log``'s rounding. fp32
throughout."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as TP
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

from torch_functional_cases import CASES, check_case, f

one_cpu_thread()

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


@pytest.mark.parametrize("name,call,arrays,n_grad,exact", CASES,
                         ids=[c[0] for c in CASES])
def test_function_matches_the_reference(name, call, arrays, n_grad, exact):
    check_case(J, JF, TP, TF, name, call, arrays, n_grad, exact, TOL)


def test_dropout_takes_a_key_only_when_it_drops():
    x = np.ones((3, 4), np.float32)
    for pkg, F in ((J, JF), (TP, TF)):
        pkg.seed(1)
        F.dropout(pkg.to_tensor(x), 0.0)
        F.dropout(pkg.to_tensor(x), 0.5, training=False)
        assert pkg.get_rng_state()[0] == 0
        F.dropout(pkg.to_tensor(x), 0.5)
        F.scaled_dot_product_attention(*[pkg.to_tensor(f(1, 2, 1, 8))] * 3)
        assert pkg.get_rng_state()[0] == 1
        F.scaled_dot_product_attention(
            *[pkg.to_tensor(f(1, 2, 1, 8))] * 3,
            attn_mask=pkg.to_tensor(np.zeros((2, 2), np.float32)),
            training=False)
        assert pkg.get_rng_state()[0] == 2


def test_torch_tensors_run_directly():
    """Given torch tensors the functions run on them and return torch
    tensors (the ported models call them so)."""
    x = torch.randn(2, 3, 4, 4)
    w = torch.randn(5, 3, 3, 3)
    y = TF.conv2d(x, w, padding=1)
    assert isinstance(y, torch.Tensor) and y.shape == (2, 5, 4, 4)
    assert isinstance(TF.cross_entropy(torch.randn(3, 4),
                                       torch.tensor([0, 1, 3]),
                                       reduction="sum"), torch.Tensor)
