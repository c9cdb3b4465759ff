"""Numerics debugging: nan/inf detection in eager code and inside
functions — counterpart of ``paddle_tpu/amp/debugging.py``.

* :func:`enable_tensor_checker` arms the dispatcher's scan
  (``FLAGS_check_nan_inf``, ``core.dispatch``): every dispatched op's
  floating outputs are scanned, by op name, with the config's abort or
  report mode and op include/skip lists;
* :func:`check_numerics` scans one tensor;
* :func:`checkify_wrap` is the counterpart of the reference's JAX
  ``checkify`` wrapper, which names the primitive that produced a nan or
  inf inside a compiled function. Here the wrapped function runs under a
  ``TorchDispatchMode`` that scans the floating outputs of every ATen op
  it executes and raises FloatingPointError naming the first op that
  produced a nan or inf (one host read per op: a debugging tool, as the
  reference's is).
"""

from __future__ import annotations

import functools
from enum import Enum
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.tensor import Tensor
from ..flags import set_flags


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    """Parity with paddle.amp.debugging.TensorCheckerConfig."""

    def __init__(self, enable: bool = True,
                 debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def enable_tensor_checker(checker_config: TensorCheckerConfig) -> None:
    """Arm the dispatch-level nan/inf scan (FLAGS_check_nan_inf), honouring
    debug_mode (abort vs report-only) and the op include/skip lists."""
    from ..core import dispatch as _d
    set_flags({"check_nan_inf": bool(checker_config.enable)})
    _d.nan_inf_abort[0] = (checker_config.debug_mode
                           == DebugMode.CHECK_NAN_INF_AND_ABORT)
    _d.nan_inf_skip_ops = set(checker_config.skipped_op_list or ())
    _d.nan_inf_check_ops = set(checker_config.checked_op_list or ())


def disable_tensor_checker() -> None:
    from ..core import dispatch as _d
    set_flags({"check_nan_inf": False})
    _d.nan_inf_abort[0] = True
    _d.nan_inf_skip_ops = set()
    _d.nan_inf_check_ops = set()


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Eager scan; raises FloatingPointError on nan/inf (abort mode) or
    returns (num_nan, num_inf) counts."""
    v = tensor._value if isinstance(tensor, Tensor) else torch.as_tensor(tensor)
    if not v.dtype.is_floating_point:
        return 0, 0
    v = v.detach()
    n_nan = int(torch.isnan(v).sum())
    n_inf = int(torch.isinf(v).sum())
    if (n_nan or n_inf) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(
            f"nan/inf in {op_type or 'tensor'} {var_name}: "
            f"{n_nan} nan, {n_inf} inf (shape {tuple(v.shape)})")
    return n_nan, n_inf


class _NanInfScan(TorchDispatchMode):
    """Raises at the first ATen op whose floating output holds a nan or
    an inf, naming the op."""

    def __init__(self, where: str):
        super().__init__()
        self.where = where

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if (isinstance(o, torch.Tensor) and o.dtype.is_floating_point
                    and not bool(torch.isfinite(o).all())):
                raise FloatingPointError(
                    f"nan/inf inside {self.where}: produced by {func}")
        return out


def checkify_wrap(fn: Callable, *, jit: bool = True) -> Callable:
    """Wrap a function so nan/inf produced INSIDE it raises
    FloatingPointError naming the ATen op that produced it (module
    docstring). ``jit`` is accepted for the reference's signature: the
    function runs eagerly either way."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NanInfScan(getattr(fn, "__name__", "fn")):
            return fn(*args, **kwargs)

    return wrapper


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "tensor-dump comparison is not part of the JAX package's surface "
        "(it raises there too); use checkify_wrap or check_numerics")
