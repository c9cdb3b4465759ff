"""Token selection for the serving step — counterpart of
``paddle_tpu/inference/sampling.py``.

Only the greedy tail is ported so far; per-request temperature/top-k/
top-p sampling and grammar masks come with the sampling slice.
"""

from __future__ import annotations

import torch


def greedy_rows(logits: torch.Tensor) -> torch.Tensor:
    """(R, V) logits -> (R,) int32 argmax, taken in fp32. The cast is
    value-exact for bf16/f16 logits, and ties go to the first index,
    as in ``jnp.argmax``."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
