"""``paddle_tpu_torch.nn.functional``'s padding, resizing and patches,
losses and attention against ``paddle_tpu.nn.functional`` on the CPU
(``torch_functional_cases.LOSS_CASES``): ``pad`` in every mode,
``interpolate`` (``jax.image.resize``'s kernels), ``unfold``/``fold``,
``grid_sample``, the shuffles, every loss with its options (``cross_entropy``'s class
weights, reductions, soft labels, axis, probabilities and label
smoothing among them), ``label_smooth``, the masked, dropout and
unmasked ``scaled_dot_product_attention`` (a dropout attention's mask
is the key stream's, bit for bit), ``flash_attention``,
``flash_attn_unpadded`` and ``gather_tree``; forward outputs and the
gradients of ``Σ out·c``. fp32."""

import pytest

import paddle_tpu as J
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as TP
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

from torch_functional_cases import LOSS_CASES, check_case

one_cpu_thread()

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


@pytest.mark.parametrize("name,call,arrays,n_grad,exact", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_loss_or_attention_matches_the_reference(name, call, arrays, n_grad,
                                                 exact):
    check_case(J, JF, TP, TF, name, call, arrays, n_grad, exact, TOL)
