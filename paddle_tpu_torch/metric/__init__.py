"""Metrics — counterpart of ``paddle_tpu/metric/__init__.py``:
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and
``accuracy``.

``Accuracy.compute`` decides top-k membership on the tensor's own device
instead of copying the logits to the host and sorting them, as the
reference does: a label is in the top ``k`` when fewer than ``k``
logits are strictly greater than the label's own. Without ties this is
the reference's answer. Tie rule: a label whose logit equals others
counts as ranked before all of them (the reference's unstable host sort
orders ties arbitrarily). The result keeps the reference's shape,
``(..., maxk)`` with column ``j`` true where the label ranks ``j``.
``update`` reads one count per ``k`` back to the host. ``Precision``,
``Recall`` and ``Auc`` accumulate on the host, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _torch(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _host(x):
    return _torch(x).detach().cpu().numpy()


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        p, lab = _torch(pred), _torch(label).to(_torch(pred).device)
        if lab.dim() == p.dim():
            lab = lab.squeeze(-1)
        own = torch.gather(p, -1, lab.long()[..., None])
        rank = (p > own).sum(dim=-1, keepdim=True)
        return rank == torch.arange(self.maxk, device=p.device)

    def update(self, correct, *args):
        c = _torch(correct)
        n = c[..., 0].numel()
        hits = torch.stack([c[..., :k].any(dim=-1).sum() for k in self.topk])
        for i, h in enumerate(hits.tolist()):
            self.total[i] += h
            self.count[i] += n
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _host(preds).round()
        lab = _host(labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _host(preds).round()
        lab = _host(labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        lab = _host(labels).ravel()
        if p.ndim == 2:
            p = p[:, -1]
        idx = np.minimum((p * self.num_thresholds).astype(int),
                         self.num_thresholds)
        np.add.at(self._stat_pos, idx[lab != 0], 1)
        np.add.at(self._stat_neg, idx[lab == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    m = Accuracy(topk=(k,))
    acc = m.update(m.compute(input, label))
    return Tensor(np.asarray(acc, dtype=np.float32))
