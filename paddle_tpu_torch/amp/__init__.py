"""Automatic mixed precision — counterpart of ``paddle_tpu/amp/__init__.py``.

* :func:`decorate` — O2 casts the models to the low dtype in place
  (``module.to(dtype)``: the same ``Parameter`` objects, so optimizers
  built over them keep them) and turns on the optimizers'
  ``_multi_precision`` (fp32 master weights); O1 leaves both.
* :class:`GradScaler` — the dynamic loss-scale state machine of the
  reference (l.114-209): ``scale(loss)``; ``step(opt)`` unscales the
  gradients, skips the update when any is inf or nan (the scale then
  shrinks by ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps)
  and otherwise steps (the scale grows by ``incr_ratio`` after
  ``incr_every_n_steps`` good ones).
* ``WHITE_LIST``, ``BLACK_LIST``, :func:`amp_state` and
  :func:`_target_dtype`: the reference's per-op cast rule.

:func:`auto_cast` casts each op's inputs through the dispatcher's hook
(``core.dispatch.amp_cast_hook``), as the reference's does: at O1 the
fp32 Tensor inputs of a white-listed op (``matmul``, ``linear``,
``flash_attention``, ...) are cast to the low dtype; at O2 the low-dtype
inputs of a black-listed op (``rms_norm``, ``cross_entropy``, ...) are
cast to fp32. The cast is a recorded op (``Tensor.astype``), so the
backward casts the gradient back. Only ``core.tensor.Tensor`` inputs
are cast: torch tensors handed to the ported models directly never pass
the dispatcher.

The unscaled gradients are fp32 and stay beside the optimizer, never in
``.grad``: torch refuses a ``.grad`` whose dtype differs from its bf16
parameter's, and a cast back would round. They reach the update through
the optimizer's ``_grads()`` for the step, so ``grad_clip`` sees them.
The inf/nan test is one reduction over all gradients and one host read
a step (the reference reads once per parameter; the verdict is the
same).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..core import dispatch as _dispatch
from ..core.tensor import Tensor
from ..distributed.fleet.meta_optimizers import unwrap_optimizer

# ops that benefit from low precision (matmul-class), as the reference's
WHITE_LIST = {"matmul", "mm", "bmm", "linear", "conv2d", "conv1d", "conv3d",
              "einsum", "flash_attention", "attention_masked"}
# ops kept in fp32 (reductions/normalizations/losses)
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "rms_norm", "mean", "sum", "norm", "logsumexp",
              "exp", "log", "cosine_similarity"}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_LOW = (torch.bfloat16, torch.float16)

_amp_state = {"enabled": False, "dtype": torch.bfloat16, "level": "O1",
              "custom_white": set(), "custom_black": set()}


def _convert_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype {dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[dtype]


def amp_state():
    return _amp_state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """The reference's per-op cast context (module docstring)."""
    prev = dict(_amp_state)
    _amp_state.update(
        enabled=enable, dtype=_convert_dtype(dtype), level=level,
        custom_white=set(custom_white_list or ()),
        custom_black=set(custom_black_list or ()))
    try:
        yield
    finally:
        _amp_state.update(prev)


amp_guard = auto_cast


def _target_dtype(op_name, cur_dtype):
    """The dtype an input of ``op_name`` is cast to under the active amp
    mode, or None for no cast."""
    level = _amp_state["level"]
    dt = _amp_state["dtype"]
    white = (WHITE_LIST | _amp_state["custom_white"]) \
        - _amp_state["custom_black"]
    black = BLACK_LIST | _amp_state["custom_black"]
    if level == "O2":
        if op_name in black and cur_dtype in _LOW:
            return torch.float32
        return None
    if op_name in white and cur_dtype == torch.float32:
        return dt
    return None


def _amp_hook(op_name, args):
    """The dispatcher's cast hook: each Tensor input cast to
    :func:`_target_dtype`'s dtype by a recorded cast op, and each
    floating torch tensor (a ``Layer``'s parameter) by a differentiable
    ``to``."""
    if not _amp_state["enabled"]:
        return args
    cast_args = []
    for a in args:
        if isinstance(a, Tensor):
            tgt = _target_dtype(op_name, a._value.dtype)
            if tgt is not None:
                a = a.astype(tgt)
        elif isinstance(a, torch.Tensor) and a.dtype.is_floating_point:
            tgt = _target_dtype(op_name, a.dtype)
            if tgt is not None:
                a = a.to(tgt)
        cast_args.append(a)
    return tuple(cast_args)


_dispatch.amp_cast_hook = _amp_hook


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2, cast the models to ``dtype`` in
    place and turn on the optimizers' master weights. Returns the models
    (and the optimizers, when given) in the shape they came in."""
    d = _convert_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    single_opt = not isinstance(optimizers, (list, tuple))
    model_list = [models] if single_model else list(models)
    opt_list = ([optimizers] if single_opt or optimizers is None
                else list(optimizers))
    if level == "O2":
        for m in model_list:
            if m is not None:
                m.to(dtype=d)
        for o in opt_list:
            if o is not None:
                unwrap_optimizer(o)._multi_precision = True
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list,
            optimizers if single_opt else opt_list)


class GradScaler:
    """Dynamic loss scaling, the reference's state machine (module
    docstring). ``enable=False`` passes everything through.

    One difference: the reference's ``step`` unscales again after an
    explicit ``unscale_`` that found no inf (dividing the gradients by
    the scale twice); here the unscaled gradients of an explicit
    ``unscale_`` are the ones ``step`` uses."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False
        #: the unscaled fp32 gradients of the pending step, aligned with
        #: the optimizer's parameter list (None: not unscaled yet)
        self._unscaled: Optional[list] = None
        #: host reads of the card (one per unscale_)
        self.host_reads = 0

    def is_enable(self) -> bool:
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Divide the gradients the optimizer would step from (its
        ``_grads()``) by the scale, into fp32 tensors kept for the step,
        and test them for inf/nan (one reduction, one host read)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = unwrap_optimizer(optimizer)._grads()
        live = [g for g in grads if g is not None]
        unscaled = torch._foreach_mul([g.float() for g in live], inv) \
            if live else []
        found = False
        if unscaled:
            amax = torch.stack(torch._foreach_norm(unscaled, float("inf")))
            found = not bool(torch.isfinite(amax).all())
            self.host_reads += 1
        it = iter(unscaled)
        self._unscaled = [None if g is None else next(it) for g in grads]
        self._found_inf = found

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        if self._unscaled is None:
            self.unscale_(optimizer)
        unscaled, self._unscaled = self._unscaled, None
        if self._found_inf:
            self._update_on_inf()
            self._found_inf = False
            return
        base = unwrap_optimizer(optimizer)
        base._grads = lambda: unscaled
        try:
            optimizer.step()
        finally:
            vars(base).pop("_grads", None)
        self._update_on_good()

    def minimize(self, optimizer, scaled_loss) -> None:
        self.step(optimizer)

    def update(self) -> None:
        """A no-op: ``step`` already moved the scale, as in the
        reference."""

    def _update_on_good(self) -> None:
        if not self._dynamic:
            return
        self._good += 1
        self._bad = 0
        if self._good >= self._incr_every:
            self._scale *= self._incr_ratio
            self._good = 0

    def _update_on_inf(self) -> None:
        if not self._dynamic:
            return
        self._bad += 1
        self._good = 0
        if self._bad >= self._decr_every:
            self._scale = max(self._scale * self._decr_ratio, 1.0)
            self._bad = 0

    def get_loss_scaling(self) -> float:
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good": self._good, "bad": self._bad}

    def load_state_dict(self, s) -> None:
        self._scale = s["scale"]
        self._good = s["good"]
        self._bad = s["bad"]


from . import debugging  # noqa: E402,F401
