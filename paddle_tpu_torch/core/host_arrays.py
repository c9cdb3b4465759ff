"""Host (numpy) copies of device tensors, bfloat16 included, without
``ml_dtypes``.

The JAX package hands KV slabs to the wire format as numpy arrays and
frames bfloat16 through ``ml_dtypes``' numpy extension dtype, under the
dtype name ``"bfloat16"``. numpy itself has no bfloat16, so the port
carries a bf16 host array as :data:`BFLOAT16`: a 2-byte record whose
one field holds the raw 16-bit pattern. The bytes are the same, so a
frame built from either carrier is byte-equal, and nothing here does
arithmetic on them: they go to the wire and back onto the card.

Only numpy at import time; :func:`to_host` and :func:`from_host` import
torch when called (the wire format imports this module and stays
importable with stdlib + numpy).
"""

from __future__ import annotations

import numpy as np

#: the host carrier of bfloat16 bit patterns (see module docstring)
BFLOAT16 = np.dtype([("bfloat16", "<u2")])

#: torch dtype name -> the numpy-style name the wire format records
_DTYPE_NAMES = {"torch.bfloat16": "bfloat16", "torch.float32": "float32",
                "torch.float16": "float16"}


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``) or of a host array's dtype (:data:`BFLOAT16` ->
    ``"bfloat16"``), as the JAX package's ``str(array.dtype)`` spells
    it."""
    if isinstance(dtype, np.dtype):
        return "bfloat16" if dtype == BFLOAT16 else str(dtype)
    key = str(dtype)
    if key not in _DTYPE_NAMES:
        raise ValueError(f"no wire name for dtype {key}")
    return _DTYPE_NAMES[key]


def to_host(t) -> np.ndarray:
    """A contiguous host copy of tensor ``t`` (waits for the work queued
    on ``t``'s stream); bf16 comes back as :data:`BFLOAT16`."""
    import torch
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).cpu().numpy()
        return np.ascontiguousarray(bits).view(np.uint16).view(BFLOAT16)
    return np.ascontiguousarray(t.cpu().numpy())


def from_host(a: np.ndarray, dtype, device=None):
    """Tensor of ``dtype`` on ``device`` from a host array: a
    :data:`BFLOAT16` array moves its bit patterns unchanged; any other
    array converts as ``torch.as_tensor(a, dtype=dtype)``."""
    import torch
    a = np.asarray(a)
    if a.dtype == BFLOAT16:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = bits.view(torch.bfloat16)
        if dtype != torch.bfloat16:
            t = t.to(dtype)
        return t.to(device)
    return torch.as_tensor(a, dtype=dtype, device=device)
