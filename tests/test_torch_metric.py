"""``paddle_tpu_torch.metric`` against ``paddle_tpu.metric`` on the CPU:
``Accuracy`` (top-k, labels with a trailing axis, batches accumulated),
``Precision``, ``Recall``, ``Auc`` and ``accuracy``, on the same data.
``Accuracy`` decides top-k membership on the tensor's device by counting
the logits strictly greater than the label's; without ties that is the
reference's host sort's answer, and the tie rule (a tie counts in the
label's favour) is checked on logits with ties."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


R = np.random.RandomState(0)


def _np(t):
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
@pytest.mark.parametrize("label_axis", [False, True])
def test_accuracy_matches_the_reference(topk, label_axis):
    res = []
    for pkg in (J, TP):
        m = pkg.metric.Accuracy(topk=topk)
        per = []
        for b in range(3):
            rs = np.random.RandomState(b)
            pred = rs.randn(4, 6, 9).astype(np.float32)
            lab = rs.randint(0, 9, (4, 6, 1) if label_axis else (4, 6))
            correct = m.compute(pkg.to_tensor(pred), pkg.to_tensor(
                lab.astype(np.int32)))
            per.append(np.asarray(m.update(correct)))
            assert _np(correct).shape == (4, 6, m.maxk)
        res.append((per, m.accumulate(), m.name()))
        m.reset()
        assert np.asarray(m.accumulate()).sum() == 0
    (rp, ra, rn), (pp, pa, pn) = res
    assert pn == rn
    np.testing.assert_allclose(pp, rp)
    np.testing.assert_allclose(pa, ra)


def test_accuracy_ties_count_for_the_label():
    """Logits tied with the label's: the label ranks before all of
    them."""
    pred = np.array([[1.0, 1.0, 1.0, 0.0],      # label 2 ties two others
                     [2.0, 1.0, 1.0, 1.0],      # label 3: one greater
                     [0.0, 0.0, 0.0, 0.0]],     # all tied
                    np.float32)
    lab = np.array([2, 3, 1], np.int32)
    m = TP.metric.Accuracy(topk=(1, 2))
    c = _np(m.compute(TP.to_tensor(pred), TP.to_tensor(lab)))
    np.testing.assert_array_equal(c, [[True, False], [False, True],
                                      [True, False]])
    assert m.update(c).tolist() == [2 / 3, 1.0]
    # a logit strictly above every other is the reference's answer too
    dist = R.randn(5, 7).astype(np.float32)
    lab = dist.argmax(-1).astype(np.int32)
    for pkg in (J, TP):
        assert float(_np(pkg.metric.accuracy(
            pkg.to_tensor(dist), pkg.to_tensor(lab)))) == 1.0


def test_accuracy_stays_on_the_tensors_device():
    m = TP.metric.Accuracy()
    c = m.compute(torch.randn(3, 5), torch.tensor([1, 2, 3]))
    assert isinstance(c, torch.Tensor) and c.dtype == torch.bool


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_the_reference(name):
    res = []
    for pkg in (J, TP):
        m = getattr(pkg.metric, name)()
        for b in range(3):
            rs = np.random.RandomState(10 + b)
            p = rs.uniform(0, 1, (16, 2) if name == "Auc" else (16,))
            lab = rs.randint(0, 2, (16,))
            m.update(pkg.to_tensor(p.astype(np.float32)),
                     pkg.to_tensor(lab.astype(np.int32)))
        res.append((m.accumulate(), m.name()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-12)
    assert res[1][1] == res[0][1]


def test_accuracy_function_matches_the_reference():
    pred = R.randn(6, 5).astype(np.float32)
    lab = R.randint(0, 5, (6, 1)).astype(np.int32)
    got = [float(_np(pkg.metric.accuracy(pkg.to_tensor(pred),
                                         pkg.to_tensor(lab), k=2)))
           for pkg in (J, TP)]
    assert got[1] == got[0]
