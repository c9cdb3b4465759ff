"""AdamW with fp32 master weights — counterpart of the eager ``AdamW`` of
``paddle_tpu/optimizer/optimizer.py`` (``Adam._update`` l.280-295 with
the decoupled decay of ``AdamW``, l.298-337) and of its multi-precision
path (``_init_state`` l.78-82, ``_cast_for_update``/``_finish_update``
l.210-221), which ``amp.decorate(level="O2")`` turns on.

Per parameter that has a gradient, with ``t`` the step count:

    m = b1·m + (1 − b1)·g;  v = b2·v + (1 − b2)·g²
    upd = (m / (1 − b1^t)) / (sqrt(v / (1 − b2^t)) + eps) + wd·p
    p = p − lr·upd

in fp32: ``p`` is the fp32 master copy when the parameter is bf16 or
fp16 and ``multi_precision`` is on, and the result is cast back to the
parameter's dtype. State is made at a parameter's first update, from its
value then. A parameter whose gradient is ``None`` is skipped: no
decay, no state, as in the reference's ``step`` (l.322, l.330). The
moments, master weights and parameters are updated in place.

:func:`adamw_update_` is that arithmetic, shared with the Llama training
step (``models/llama.py``, which has its own constants and no master
weights).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import torch

from .optimizer import Adam, Optimizer

#: elements per multi-tensor pass: each pass's fp32 temporaries stay
#: within a few times 256 MB however large the model
_CHUNK_ELEMS = 1 << 26
#: a tensor this large takes one-tensor ops: its passes are bound by the
#: device anyway, and PyTorch's element-wise kernels move its bytes faster
#: than the multi-tensor ones, whose launches cover at most 320 blocks of
#: 64 K elements (on an H100 the Llama step's AdamW, 1.9 G elements in
#: tensors of 16-131 M, ran 12 ms longer through them)
_BIG = 1 << 24

_OPS = ("mul", "mul_", "add_", "div", "div_", "sqrt_", "sub_", "copy_")


def _each(fn):
    """The per-tensor op ``fn`` over a list, called as ``torch._foreach_*``
    is: list arguments go element by element, others to every call."""
    def run(xs, *args):
        return [fn(x, *(a[i] if isinstance(a, list) else a for a in args))
                for i, x in enumerate(xs)]
    return run


_FOREACH = SimpleNamespace(**{n: getattr(torch, f"_foreach_{n}")
                              for n in _OPS})
_EACH = SimpleNamespace(**{n: _each(getattr(torch.Tensor, n)) for n in _OPS})


def _groups(n_elems: Sequence[int]):
    """``(slice, ops)`` over the tensors in order: each tensor of at least
    ``_BIG`` elements alone, with one-tensor ops; the others in runs of
    at most ``_CHUNK_ELEMS`` elements, with multi-tensor ops."""
    start, size = 0, 0
    for i, n in enumerate(n_elems):
        if n >= _BIG:
            if i > start:
                yield slice(start, i), _FOREACH
            yield slice(i, i + 1), _EACH
            start, size = i + 1, 0
        elif size + n > _CHUNK_ELEMS:
            yield slice(start, i), _FOREACH
            start, size = i, n
        else:
            size += n
    if start < len(n_elems):
        yield slice(start, len(n_elems)), _FOREACH


def adamw_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                  moment1: List[torch.Tensor], moment2: List[torch.Tensor],
                  *, lr: float, beta1: float, beta2: float, eps: float,
                  weight_decay: float, bc1, bc2,
                  masters: Optional[List[Optional[torch.Tensor]]] = None
                  ) -> None:
    """One AdamW update in place over lists of tensors, the arithmetic of
    the module docstring written out in fp32 once, as passes over lists:
    multi-tensor (``torch._foreach_*``) passes, a few launches each
    instead of a dozen eager ops per tensor, and one-tensor passes for
    the largest tensors (``_BIG``). ``bc1``/``bc2`` are the bias
    corrections ``1 − b**t``, Python floats or fp32 0-d tensors on the
    parameters' device. ``masters[i]``, where given, is parameter i's
    fp32 master copy: it is updated and then cast into the parameter;
    otherwise the parameter's own fp32 value is used.
    ``torch.optim.AdamW`` rounds its decoupled update differently, so it
    is not used."""
    if masters is None:
        masters = [None] * len(params)
    for sl, F in _groups([p.numel() for p in params]):
        ps, ms, vs = params[sl], moment1[sl], moment2[sl]
        g32 = [g.float() for g in grads[sl]]
        F.mul_(ms, beta1)
        F.add_(ms, F.mul(g32, 1 - beta1))
        F.mul_(vs, beta2)
        sq = F.mul(g32, 1 - beta2)
        F.mul_(sq, g32)
        F.add_(vs, sq)
        del g32, sq
        p32 = [p.float() if mp is None else mp
               for p, mp in zip(ps, masters[sl])]
        den = F.div(vs, bc2)
        F.sqrt_(den)
        F.add_(den, eps)
        upd = F.div(ms, bc1)
        F.div_(upd, den)
        del den
        if weight_decay:
            F.add_(upd, F.mul(p32, weight_decay))
        F.mul_(upd, lr)
        F.sub_(p32, upd)
        del upd
        # an fp32 parameter without a master copy was updated in place
        out = [(p, q) for p, q in zip(ps, p32) if q is not p]
        if out:
            F.copy_([p for p, _ in out], [q for _, q in out])


class AdamW(Optimizer):
    """``AdamW`` (ref l.298-343) over :func:`adamw_update_`: fp32
    moments, and fp32 master weights for bf16/fp16 parameters under
    ``multi_precision``; the reference's signature. ``lr_ratio`` and
    ``lazy_mode`` are accepted and ignored, as there. The parameters of
    a step go through :func:`adamw_update_` in groups of one learning
    rate and one decay (``optimize_attr`` and ``apply_decay_param_fun``
    split them), so a filter costs a group, not a pass per parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, *,
                 named_parameters=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name,
                         named_parameters=named_parameters)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = epsilon
        self._apply_decay_param_fun = apply_decay_param_fun

    _init_slots = Adam._init_slots

    def _apply(self, items, t: int) -> None:
        groups = {}
        for name, p, g, lr, wd in items:
            groups.setdefault((lr, wd), []).append(
                (p, g, self._state_of(name, p)))
        b1, b2 = self._beta1, self._beta2
        for (lr, wd), group in groups.items():
            adamw_update_([p for p, _, _ in group], [g for _, g, _ in group],
                          [s["moment1"] for _, _, s in group],
                          [s["moment2"] for _, _, s in group],
                          masters=[s.get("master") for _, _, s in group],
                          lr=lr, beta1=b1, beta2=b2, eps=self._epsilon,
                          weight_decay=wd, bc1=1 - b1 ** t, bc2=1 - b2 ** t)
