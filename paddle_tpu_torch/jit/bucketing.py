"""Dynamic-shape bucketing — counterpart of
``paddle_tpu/jit/bucketing.py``: pad ragged inputs to a few bucket
shapes, so a compiled function sees a few signatures (each one CUDA
graph here, one XLA program there) instead of one per shape.
:class:`ShapeBucketer` rounds each configured axis up to its next bucket
and reports the valid extents for masking."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["next_bucket", "pad_to_bucket", "ShapeBucketer"]


def next_bucket(n: int, buckets: Optional[Sequence[int]] = None,
                multiple: int = 64) -> int:
    """Smallest bucket >= n. With an explicit ``buckets`` list, pick from
    it (the last bucket caps — larger inputs raise); otherwise round up to
    ``multiple`` (the reference's default, 64)."""
    if buckets:
        for b in sorted(buckets):
            if n <= b:
                return int(b)
        raise ValueError(
            f"size {n} exceeds the largest bucket {max(buckets)}; add a "
            "larger bucket or pre-truncate")
    return int(-(-n // multiple) * multiple)


def pad_to_bucket(x, axis: int = 0, buckets: Optional[Sequence[int]] = None,
                  multiple: int = 64, pad_value=0):
    """Pad ``x`` (a Tensor, torch tensor or array) along ``axis`` up to
    the next bucket. Returns ``(padded, valid_len)``, ``valid_len`` the
    original extent."""
    if isinstance(x, Tensor):
        arr = x._value
    elif isinstance(x, torch.Tensor):
        arr = x
    else:
        arr = np.asarray(x)
    n = arr.shape[axis]
    target = next_bucket(n, buckets, multiple)
    if target == n:
        return x if isinstance(x, (Tensor, torch.Tensor)) else arr, n
    if isinstance(arr, torch.Tensor):
        shape = list(arr.shape)
        shape[axis] = target - n
        pad = torch.full(shape, pad_value, dtype=arr.dtype, device=arr.device)
        out = torch.cat([arr, pad], dim=axis)
        return (Tensor._wrap(out, True) if isinstance(x, Tensor) else out), n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=pad_value), n


class ShapeBucketer:
    """Pads a batch of arrays to shared bucket shapes before a compiled
    call, and counts the distinct bucket signatures it produced.

    Example (ragged detection eval)::

        bucketer = ShapeBucketer(axes={0: (64, 128, 256)})
        padded, valid = bucketer(boxes)      # (128, 4), valid == {0: 87}
        scores = compiled_fn(padded)[:valid[0]]
    """

    def __init__(self, axes: dict, multiple: int = 64, pad_value=0):
        #: axes: {axis: buckets tuple or None (round to ``multiple``)}
        self.axes = dict(axes)
        self.multiple = multiple
        self.pad_value = pad_value
        self.signatures: set = set()

    def __call__(self, x) -> Tuple[object, dict]:
        """Pad every configured axis; returns (padded, {axis: valid_len})."""
        valid = {}
        for axis, buckets in sorted(self.axes.items()):
            x, n = pad_to_bucket(x, axis=axis, buckets=buckets,
                                 multiple=self.multiple,
                                 pad_value=self.pad_value)
            valid[axis] = n
        shape = tuple(x.shape)
        self.signatures.add(shape)
        return x, valid

    @property
    def num_signatures(self) -> int:
        return len(self.signatures)
