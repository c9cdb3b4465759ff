"""Data types — counterpart of ``paddle_tpu/core/dtype.py``.

Paddle's dtype names are torch dtypes here (``paddle.float32`` is
``torch.float32``), so ``x.dtype == paddle.int32`` reads as it does in
the JAX package.

The JAX package runs with x64 off: an int64 or float64 request, a Python
int list or a float64 numpy array all become int32 or float32 there
(``canonical_dtype``, ``creation.to_tensor``). The port gives the same
result dtypes: :func:`canonical_dtype` maps the 64-bit types to their
32-bit ones, and every ``core.tensor.Tensor`` holds a canonical dtype.
Ops that need int64 indices in torch cast inside the op.
"""

from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}

_NP_TO_DTYPE = {np.dtype(k): v for k, v in _STR_TO_DTYPE.items()
                if k != "bfloat16"}

#: the x64-off canonicalisation of the JAX package
X64_TO_32 = {torch.int64: torch.int32, torch.float64: torch.float32,
             torch.complex128: torch.complex64}

_default_dtype = [torch.float32]


def convert_dtype(dtype) -> torch.dtype:
    """Normalise a str / numpy / torch dtype spelling to a torch dtype."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("paddle."):] if dtype.startswith("paddle.") else dtype
        if name not in _STR_TO_DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR_TO_DTYPE[name]
    try:
        npd = np.dtype(dtype)
    except TypeError:
        raise ValueError(f"Unknown dtype: {dtype!r}") from None
    if npd.name == "bfloat16":
        return torch.bfloat16
    if npd not in _NP_TO_DTYPE:
        raise ValueError(f"Unknown dtype: {dtype!r}")
    return _NP_TO_DTYPE[npd]


def canonical_dtype(dtype) -> torch.dtype:
    """``convert_dtype`` plus the x64-off canonicalisation: int64 and
    float64 (and complex128) requests give int32 and float32
    (complex64), as in the JAX package."""
    d = convert_dtype(dtype)
    if d is None:
        return None
    return X64_TO_32.get(d, d)


def dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"``, ...: the dtype's name without the
    ``torch.`` prefix."""
    return str(convert_dtype(dtype)).rpartition(".")[2]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def set_default_dtype(d) -> None:
    _default_dtype[0] = convert_dtype(d)


def get_default_dtype():
    return _default_dtype[0]
