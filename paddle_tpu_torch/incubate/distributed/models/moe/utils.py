"""``global_scatter`` / ``global_gather`` — counterpart of
``paddle_tpu/incubate/distributed/models/moe/utils.py``: tokens sorted by
expert into the expert-major (E, C, d) slots and back, with the
count-based ragged layout padded to a capacity (the largest count), as
the reference's dispatch masks do. Reading the counts is a host read,
as in the reference."""

from __future__ import annotations

import torch

from .....core.dispatch import apply, unwrap
from .....core.tensor import Tensor
from .....ops import moe_ops


def _counts(c):
    return torch.as_tensor(unwrap(c)).to(torch.int64).cpu()


def global_scatter(x, local_count, global_count, group=None):
    """Tokens (N, d) sorted by destination expert -> (E, C, d), C the
    largest count."""
    lc = _counts(local_count)
    n_expert = lc.shape[0]
    cap = int(lc.max())

    def fn(v):
        ids = torch.repeat_interleave(torch.arange(n_expert), lc)
        ids = torch.nn.functional.pad(ids, (0, v.shape[0] - ids.shape[0]),
                                      value=n_expert - 1).to(v.device)
        disp, _ = moe_ops.dispatch_combine_masks(
            ids, torch.ones(ids.shape, device=v.device), n_expert, cap)
        return moe_ops.moe_dispatch(v, disp.to(v.dtype))
    return apply(fn, x, op_name="global_scatter") \
        if isinstance(x, Tensor) else fn(torch.as_tensor(x))


def global_gather(x, local_count, global_count, group=None):
    """The inverse of :func:`global_scatter`: (E, C, d) back to token
    order."""
    lc = _counts(local_count)
    n_expert = lc.shape[0]
    total = int(lc.sum())

    def fn(v):
        cap = v.shape[1] if v.dim() == 3 else int(lc.max())
        ids = torch.repeat_interleave(torch.arange(n_expert), lc).to(v.device)
        disp, _ = moe_ops.dispatch_combine_masks(
            ids, torch.ones(total, device=v.device), n_expert, cap)
        return moe_ops.moe_combine(v.reshape(n_expert, cap, -1),
                                   disp.to(v.dtype))
    return apply(fn, x, op_name="global_gather") \
        if isinstance(x, Tensor) else fn(torch.as_tensor(x))
