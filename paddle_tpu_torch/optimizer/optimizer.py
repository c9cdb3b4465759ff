"""The eager optimizer surface of ``paddle_tpu/optimizer/optimizer.py``
that the ported training paths use: the ``Optimizer`` base (l.32-150:
the parameter list, ``clear_grad``, fp32 master weights for bf16/fp16
parameters under ``multi_precision``, l.78-82 and l.210-221) and
``SGD`` (l.224-230). ``AdamW`` is in :mod:`.adamw`.

Parameters come as ``parameters`` (a list, kept as ``_parameter_list``,
as in the reference) or as ``named_parameters`` (their names key the
state). A parameter steps from the gradient :meth:`Optimizer._grads`
gives it: its ``.grad``. A wrapper that steps from other gradients
(``MixPrecisionOptimizer``'s fp32 ``main_grad``) overrides that one
method: torch refuses a ``.grad`` whose dtype differs from its
parameter's, and a cast would round ``main_grad`` back to bf16.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate: float = 1e-3,
                 parameters: Optional[Iterable[torch.Tensor]] = None,
                 weight_decay: Optional[float] = None,
                 multi_precision: bool = False,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.Tensor]]] = None):
        if (parameters is None) == (named_parameters is None):
            raise ValueError("give the optimizer either parameters or "
                             "named_parameters")
        named = (list(named_parameters) if named_parameters is not None
                 else [(f"param_{i}", p) for i, p in enumerate(parameters)])
        self._names = [n for n, _ in named]
        self._parameter_list: List[torch.Tensor] = [p for _, p in named]
        self._lr = float(learning_rate)
        self._wd = float(weight_decay or 0.0)
        self._multi_precision = multi_precision
        #: name -> the parameter's fp32 state (moments, master weight)
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.step_count = 0

    def _grads(self) -> List[Optional[torch.Tensor]]:
        """The gradient each parameter of ``_parameter_list`` steps
        from, ``None`` to skip it: its ``.grad``."""
        return [p.grad for p in self._parameter_list]

    def _live(self):
        """``(name, parameter, gradient)`` of every parameter that has a
        gradient: the others are skipped (no decay, no state)."""
        return [(n, p, g) for n, p, g in
                zip(self._names, self._parameter_list, self._grads())
                if g is not None]

    def _new_state(self, p) -> Dict[str, torch.Tensor]:
        """A parameter's state at its first update: its fp32 master copy
        when it is bf16/fp16 under ``multi_precision``."""
        if self._multi_precision and p.dtype in _LOW:
            return {"master": p.detach().float()}
        return {}

    def _state_of(self, name, p) -> Dict[str, torch.Tensor]:
        s = self.state.get(name)
        if s is None:
            s = self.state[name] = self._new_state(p)
        return s

    def clear_grad(self, set_to_zero: bool = False):
        """Drop every gradient (``None``), as ``Optimizer.clear_grad``
        (which ignores ``set_to_zero`` too)."""
        for p in self._parameter_list:
            p.grad = None


class SGD(Optimizer):
    """``p ← p − lr·(g + wd·p)`` in fp32 (on the master copy where one
    is kept), cast back to the parameter's dtype."""

    @torch.no_grad()
    def step(self):
        self.step_count += 1
        for name, p, g in self._live():
            s = self._state_of(name, p)
            v32 = s.get("master")
            if v32 is None:
                v32 = p.float()
            g32 = g.float()
            if self._wd:
                g32 = g32 + self._wd * v32
            new = v32 - self._lr * g32
            if "master" in s:
                s["master"] = new
            p.copy_(new)
