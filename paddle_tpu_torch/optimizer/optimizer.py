"""The eager optimizers of ``paddle_tpu/optimizer/optimizer.py``: the
``Optimizer`` base (l.32-221) and ``SGD``, ``Momentum``, ``Adam``,
``Adamax``, ``Lamb``, ``RMSProp`` and ``Adagrad`` (l.224-461). ``AdamW``
is in :mod:`.adamw`.

The base follows the reference's step (l.113-145): the step count
rises, the learning rate is read once (a float, or an ``LRScheduler``'s
current value), the ``(param, grad)`` pairs of the parameters that have
a gradient and are ``trainable`` go through ``grad_clip``, and each
pair is updated with the learning rate times its parameter's
``optimize_attr["learning_rate"]`` and the weight decay where
``_decay_enabled`` (``apply_decay_param_fun`` / Lamb's
``exclude_from_weight_decay_fn``). A torch parameter has none of
``trainable``, ``optimize_attr`` and ``need_clip``: they are read with
the reference's defaults (``requires_grad``, a learning-rate factor of
1, ``True``), so a caller may set them as attributes.

Update arithmetic is fp32, on the fp32 master copy where one is kept
(bf16/fp16 parameters under ``multi_precision``, which
``amp.decorate(level="O2")`` turns on), and the result is cast back to
the parameter's dtype (``_cast_for_update``/``_finish_update``,
l.210-221). State is made at a parameter's first update, under the
reference's slot names. The update reads nothing back to the host.

Parameters come as ``parameters``: a list of tensors, or the
``(name, tensor)`` pairs of ``named_parameters()`` (also accepted as
``named_parameters=``), whose names ``apply_decay_param_fun`` and the
state keys use (tensors alone are named ``param_<i>``). A parameter
steps from the gradient :meth:`Optimizer._grads` gives it, its
``.grad``: wrappers that step from other gradients
(``MixPrecisionOptimizer``'s fp32 ``main_grad``, ``amp.GradScaler``'s
unscaled fp32 gradients) override that one method, since torch refuses
a ``.grad`` whose dtype differs from its parameter's. Clipping applies
to what it returns.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..observability.profiling import chain_armed as _chain_armed
from ..observability.profiling import note_chain as _note_chain
from .clip import ClipGradBase
from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)
_META = ("@step", "LR_Scheduler")


def _trainable(p) -> bool:
    return bool(getattr(p, "trainable", p.requires_grad))


def _lr_factor(p) -> float:
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


def _named(parameters) -> List[tuple]:
    """``(name, tensor)`` pairs from a list of tensors or of pairs. A
    ``core.tensor.Parameter`` (or Tensor) is unwrapped to its torch leaf,
    named by its ``name``; its ``trainable``, ``optimize_attr`` and
    ``need_clip`` live on that leaf."""
    items = list(parameters)
    if items and isinstance(items[0], tuple):
        return [(str(n), getattr(p, "_value", p)) for n, p in items]
    return [(p.name, p._value) if hasattr(p, "_value") else (f"param_{i}", p)
            for i, p in enumerate(items)]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = False, name=None, *,
                 named_parameters: Optional[Iterable[tuple]] = None):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(
                f"learning_rate must be a float or an LRScheduler, not "
                f"{type(learning_rate).__name__} (parameters go in "
                f"parameters=)")
        if (parameters is None) == (named_parameters is None):
            raise ValueError("give the optimizer either parameters or "
                             "named_parameters")
        named = _named(parameters if named_parameters is None
                       else named_parameters)
        self._names = [n for n, _ in named]
        self._parameter_list: List[torch.Tensor] = [p for _, p in named]
        self._learning_rate = learning_rate
        self._weight_decay = self._parse_wd(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        #: name -> the parameter's fp32 state (slots, master weight)
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        #: the fusion pass's optimizer region (``jit.fusion.
        #: install_optimizer_fusion``): ``step`` delegates to it when set
        self._fused_step = None

    @property
    def step_count(self) -> int:
        return self._step_count

    @staticmethod
    def _parse_wd(weight_decay) -> float:
        """A float, or the coefficient of an ``L2Decay``/``L1Decay``."""
        if weight_decay is None:
            return 0.0
        if isinstance(weight_decay, (int, float)):
            return float(weight_decay)
        for attr in ("_regularization_coeff", "_coeff", "coeff"):
            if hasattr(weight_decay, attr):
                return float(getattr(weight_decay, attr))
        return float(weight_decay)

    # -- learning rate ------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    # -- state --------------------------------------------------------------

    def _grads(self) -> List[Optional[torch.Tensor]]:
        """The gradient each parameter of ``_parameter_list`` steps
        from, ``None`` to skip it: its ``.grad``."""
        return [p.grad for p in self._parameter_list]

    def _new_state(self, p) -> Dict[str, torch.Tensor]:
        """A parameter's state at its first update: its fp32 master copy
        when it is bf16/fp16 under ``multi_precision``, and the family's
        slots (:meth:`_init_slots`)."""
        s = {}
        if self._multi_precision and p.dtype in _LOW:
            s["master"] = p.detach().float()
        s.update(self._init_slots(p))
        return s

    def _init_slots(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _state_of(self, name, p) -> Dict[str, torch.Tensor]:
        s = self.state.get(name)
        if s is None:
            s = self.state[name] = self._new_state(p)
        return s

    def _decay_enabled(self, name: str, p) -> bool:
        """Whether weight decay applies to this parameter
        (``apply_decay_param_fun(name)`` where given)."""
        fn = getattr(self, "_apply_decay_param_fun", None)
        return True if fn is None else bool(fn(name))

    # -- the step -----------------------------------------------------------

    def _live(self) -> List[tuple]:
        """``(name, param, grad)`` of every trainable parameter that has
        a gradient, after ``grad_clip``."""
        named = {id(p): n for n, p in zip(self._names, self._parameter_list)}
        pairs = [(p, g) for p, g in zip(self._parameter_list, self._grads())
                 if g is not None and _trainable(p)]
        if self._grad_clip is not None and pairs:
            pairs = self._grad_clip(pairs)
        return [(named[id(p)], p, g) for p, g in pairs if g is not None]

    @torch.no_grad()
    def step(self) -> None:
        if self._fused_step is not None:
            return self._fused_step.step()
        # armed-only profiling taps: the grad-transform -> update chain is
        # the fusion pass's optimizer_chain signature (jit/fusion.py);
        # disarmed cost is one list index
        armed = _chain_armed[0]
        self._step_count += 1
        lr = self.get_lr()
        t0 = time.perf_counter_ns() if armed else 0
        live = self._live()
        if armed and self._grad_clip is not None:
            _note_chain(op_name="grad_clip",
                        dur_ns=time.perf_counter_ns() - t0)
        items = []
        for name, p, g in live:
            wd = self._weight_decay if self._decay_enabled(name, p) else 0.0
            items.append((name, p, g, lr * _lr_factor(p), wd))
        t0 = time.perf_counter_ns() if armed else 0
        self._apply(items, self._step_count)
        if armed and items:
            share = (time.perf_counter_ns() - t0) / len(items)
            for _ in items:
                _note_chain(op_name="optimizer_update", dur_ns=share)

    def _apply(self, items, t: int) -> None:
        """Update each ``(name, param, grad, lr, wd)`` (one parameter at
        a time; ``AdamW`` groups them)."""
        for name, p, g, lr, wd in items:
            s = self._state_of(name, p)
            v32 = s.get("master")
            if v32 is None:
                v32 = p.float()
            new = self._update(v32, g.float(), s, lr, wd, t)
            if "master" in s:
                s["master"] = new
            p.copy_(new)

    def _update(self, v32, g32, s, lr, wd, t):
        """The fp32 value after one update (``_update`` of the
        reference); moves the state slots in ``s``."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every gradient (``None``), as ``Optimizer.clear_grad``
        (which ignores ``set_to_zero`` too)."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None) -> None:
        loss.backward()
        self.step()
        self.clear_grad()

    # -- serialization ------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """``{"@step": n, "{name}.{slot}": tensor, ...}``, plus
        ``"LR_Scheduler"`` under a scheduler. The tensors are the live
        state, updated in place by later steps: copy them to keep a
        snapshot."""
        out: Dict[str, Any] = {"@step": self._step_count}
        for name in self._names:
            for k, v in self.state.get(name, {}).items():
                out[f"{name}.{k}"] = v
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a state dict (tensors or numpy arrays), by name, or by
        position when the saved names are not this optimizer's (ref
        l.163-208): ``state_dict`` emits slots grouped per parameter in
        list order, so the i-th distinct saved name maps to the i-th
        parameter, all or nothing, once the counts agree and any saved
        name is unknown here; names that all end in a number (the
        reference's ``generated_tensor_<n>``) are sorted by it first."""
        self._step_count = int(state.get("@step", self._step_count))
        if "LR_Scheduler" in state and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        by_name = dict(zip(self._names, zip(self._names,
                                            self._parameter_list)))
        saved: List[str] = []
        for key in state:
            if key in _META:
                continue
            pname = key.rpartition(".")[0]
            if pname not in saved:
                saved.append(pname)
        if all(re.search(r"(\d+)$", n) for n in saved):
            saved.sort(key=lambda n: int(re.search(r"(\d+)$", n).group(1)))
        by_pos = {}
        if len(saved) == len(self._parameter_list) and \
                any(n not in by_name for n in saved):
            by_pos = dict(zip(saved, zip(self._names,
                                         self._parameter_list)))
        lookup = by_pos or by_name
        for key, v in state.items():
            if key in _META:
                continue
            pname, _, slot = key.rpartition(".")
            hit = lookup.get(pname)
            if hit is None:
                continue
            name, p = hit
            t = (v.detach() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v)))
            self._state_of(name, p)[slot] = t.to(p.device, copy=True)

    set_dict = set_state_dict


class SGD(Optimizer):
    """``p − lr·(g + wd·p)``."""

    def _update(self, v32, g32, s, lr, wd, t):
        if wd:
            g32 = g32 + wd * v32
        return v32 - lr * g32


class Momentum(Optimizer):
    """``velocity = μ·velocity + g``; ``p − lr·velocity`` (Nesterov:
    ``p − lr·(g + μ·velocity)``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, *, named_parameters=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name,
                         named_parameters=named_parameters)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, v32, g32, s, lr, wd, t):
        if wd:
            g32 = g32 + wd * v32
        vel = self._momentum * s["velocity"] + g32
        s["velocity"] = vel
        if self._use_nesterov:
            return v32 - lr * (g32 + self._momentum * vel)
        return v32 - lr * vel


class Adam(Optimizer):
    """Adam with the decay coupled into the gradient (L2)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, *, named_parameters=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name,
                         named_parameters=named_parameters)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots(self, p):
        z = torch.zeros_like(p, dtype=torch.float32)
        return {"moment1": z, "moment2": z.clone()}

    def _update(self, v32, g32, s, lr, wd, t):
        b1, b2 = self._beta1, self._beta2
        if wd:
            g32 = g32 + wd * v32
        m = b1 * s["moment1"] + (1 - b1) * g32
        v = b2 * s["moment2"] + (1 - b2) * g32 * g32
        s["moment1"], s["moment2"] = m, v
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return v32 - lr * (mhat / (torch.sqrt(vhat) + self._epsilon))


class Adamax(Adam):
    """Adam over the infinity norm: ``inf_norm = max(β2·u, |g|)``."""

    def _init_slots(self, p):
        z = torch.zeros_like(p, dtype=torch.float32)
        return {"moment1": z, "inf_norm": z.clone()}

    def _update(self, v32, g32, s, lr, wd, t):
        if wd:
            g32 = g32 + wd * v32
        m = self._beta1 * s["moment1"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * s["inf_norm"], torch.abs(g32))
        s["moment1"], s["inf_norm"] = m, u
        return v32 - lr / (1 - self._beta1 ** t) * m / (u + self._epsilon)


class Lamb(Optimizer):
    """LAMB: the Adam direction plus ``wd·p``, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0; fp32 norms, which agree
    with the reference's to summation order).
    ``exclude_from_weight_decay_fn(param)`` turns the decay off."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None, *, named_parameters=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name,
                         named_parameters=named_parameters)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_enabled(self, name, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return False
        return super()._decay_enabled(name, p)

    _init_slots = Adam._init_slots

    def _update(self, v32, g32, s, lr, wd, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * s["moment1"] + (1 - b1) * g32
        v = b2 * s["moment2"] + (1 - b2) * g32 * g32
        s["moment1"], s["moment2"] = m, v
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + wd * v32
        w_norm = torch.sqrt(torch.sum(v32 * v32))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return v32 - lr * trust * r


class RMSProp(Optimizer):
    """``mean_square = ρ·ms + (1−ρ)·g²`` (``centered``: less
    ``mean_grad²``); ``moment = μ·moment + lr·g / sqrt(· + ε)``;
    ``p − moment``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, *, named_parameters=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name, named_parameters=named_parameters)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_slots(self, p):
        z = torch.zeros_like(p, dtype=torch.float32)
        s = {"mean_square": z, "moment": z.clone()}
        if self._centered:
            s["mean_grad"] = z.clone()
        return s

    def _update(self, v32, g32, s, lr, wd, t):
        rho = self._rho
        if wd:
            g32 = g32 + wd * v32
        ms = rho * s["mean_square"] + (1 - rho) * g32 * g32
        s["mean_square"] = ms
        if self._centered:
            mg = rho * s["mean_grad"] + (1 - rho) * g32
            s["mean_grad"] = mg
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * s["moment"] + lr * g32 / denom
        s["moment"] = mom
        return v32 - mom


class Adagrad(Optimizer):
    """``moment += g²``; ``p − lr·g / (sqrt(moment) + ε)``, the moment
    starting at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, *,
                 named_parameters=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name, named_parameters=named_parameters)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _update(self, v32, g32, s, lr, wd, t):
        if wd:
            g32 = g32 + wd * v32
        acc = s["moment"] + g32 * g32
        s["moment"] = acc
        return v32 - lr * g32 / (torch.sqrt(acc) + self._epsilon)
