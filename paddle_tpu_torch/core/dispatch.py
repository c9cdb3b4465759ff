"""Op dispatch — counterpart of ``paddle_tpu/core/dispatch.py``.

:func:`apply` is the single funnel every Tensor-level op goes through: it
runs the AMP cast hook, unwraps the Tensors, runs the torch function
(torch's autograd records the graph when an input does not stop
gradients) and wraps the outputs with ``stop_gradient`` set as the
reference's ``_apply_impl`` sets it. A function given card tensors
launches its kernels (or raises); given host tensors it runs the plain
versions.

Around that: the always-on dispatch telemetry (one boolean on the fast
path, ``observability.runtime.dispatch_armed``), the profiler span of a
capture window, the chain profiler's taps, the ``check_nan_inf`` scan
(with ``nan_inf_skip_ops`` / ``nan_inf_check_ops``) and the
``benchmark`` flag's wait for the card.
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, Sequence

import torch

from ..flags import _REGISTRY as _FLAGS
from ..observability import runtime as _obs
from ..observability.profiling import chain_armed as _chain_armed
from ..observability.profiling import chain_profiler as _chain_profiler
from ..observability.runtime import telemetry as _telemetry  # singleton
from ..profiler.record import RecordEvent, host_recorder
from .tensor import Tensor

_CHECK_NAN_INF = _FLAGS["check_nan_inf"]
_BENCHMARK = _FLAGS["benchmark"]


def unwrap(x):
    if isinstance(x, Tensor):
        return x._value
    return x


# AMP hook: paddle_tpu_torch.amp installs a caster here (op_name, args) ->
# args. A mutable slot, so the dispatcher has no import-time dependency on amp.
amp_cast_hook = None


def apply(fn: Callable, *args, op_name: str = "op", n_outputs: int = None, **static):
    """Run ``fn(*values, **static)`` over Tensor args.

    Positional args may be Tensors, torch tensors or Python scalars (a
    Tensor that does not stop gradients, or a torch tensor that requires
    grad, such as a ``Layer``'s parameter, makes the outputs carry
    gradients). Returns Tensor(s) mirroring fn's output structure (a
    single tensor or a tuple of tensors).
    """
    if _obs.dispatch_armed[0]:
        if host_recorder._enabled:
            return _dispatch_traced(fn, args, op_name, static)
        tele = _telemetry
        if tele._enabled:
            c = tele._counts
            n = c.get(op_name, 0)
            c[op_name] = n + 1
            if _chain_armed[0]:
                _chain_profiler.note(op_name)
            if n % tele.sample_every == 0:
                t0 = _time.perf_counter_ns()
                out = _apply_impl(fn, args, op_name, static)
                dur = _time.perf_counter_ns() - t0
                tele.observe_duration(dur)
                if _chain_armed[0]:
                    _chain_profiler.note_duration(op_name, dur)
                return out
    return _apply_impl(fn, args, op_name, static)


def _dispatch_traced(fn: Callable, args, op_name: str, static):
    """Capture-window path: wrap the dispatch in a profiler span (and
    still feed the telemetry counters)."""
    ev = RecordEvent(op_name, "Operator")
    ev.begin()
    try:
        tele = _telemetry
        if tele._enabled:
            if _chain_armed[0]:
                _chain_profiler.note(op_name)
            if tele.count(op_name):
                t0 = _time.perf_counter_ns()
                out = _apply_impl(fn, args, op_name, static)
                dur = _time.perf_counter_ns() - t0
                tele.observe_duration(dur)
                if _chain_armed[0]:
                    _chain_profiler.note_duration(op_name, dur)
                return out
        return _apply_impl(fn, args, op_name, static)
    finally:
        ev.end()


def _apply_impl(fn: Callable, args, op_name: str, static):
    if amp_cast_hook is not None:
        args = amp_cast_hook(op_name, args)
    grad = False
    vals = []
    for a in args:
        if isinstance(a, Tensor):
            vals.append(a._value)
            if not a._sg:
                grad = True
        else:
            # a layer's parameters are torch leaves: one that requires
            # grad carries gradients as a Parameter does
            if isinstance(a, torch.Tensor) and a.requires_grad:
                grad = True
            vals.append(a)
    stop = not (grad and torch.is_grad_enabled())
    out = fn(*vals, **static)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if _CHECK_NAN_INF.value:
        _check_nan_inf(op_name, outs)
    if _BENCHMARK.value:
        for o in outs:
            if isinstance(o, torch.Tensor) and o.is_cuda:
                torch.cuda.synchronize(o.device)
                break
    if isinstance(out, (tuple, list)):
        return tuple(Tensor._wrap(o, stop) for o in out)
    return Tensor._wrap(out, stop)


# nan/inf checker policy, configured by paddle_tpu_torch.amp.debugging
nan_inf_abort = [True]          # False: report (log) instead of raising
nan_inf_skip_ops: set = set()   # op names excluded from the scan
nan_inf_check_ops: set = set()  # when non-empty, ONLY these ops are scanned


def _check_nan_inf(op_name: str, outs: Sequence[Any]) -> None:
    """Debug pass (``FLAGS_check_nan_inf``): each floating output is
    scanned on its device and the verdict read back (one host read per
    output). For values inside a function use
    ``amp.debugging.checkify_wrap``."""
    if op_name in nan_inf_skip_ops:
        return
    if nan_inf_check_ops and op_name not in nan_inf_check_ops:
        return
    for i, o in enumerate(outs):
        if not isinstance(o, torch.Tensor) or not (
                o.dtype.is_floating_point or o.dtype.is_complex):
            continue
        if bool((~torch.isfinite(o.detach())).any()):
            msg = f"nan/inf detected in output {i} of op '{op_name}'"
            if nan_inf_abort[0]:
                raise FloatingPointError(msg)
            import logging
            logging.getLogger("paddle_tpu_torch.debugging").warning(msg)
            return


def any_tensor(*xs) -> bool:
    """Whether any argument is a ``Tensor``: the Tensor-level entries of
    ``nn.functional``, ``ops`` and ``incubate`` take the dispatcher for
    Tensors and keep their plain torch path for torch tensors."""
    return any(isinstance(x, Tensor) for x in xs)


# the op surface installs Tensor's methods and operators (math_ops imports
# this module back; apply is defined by now)
from . import math_ops  # noqa: E402,F401
