"""``paddle_tpu_torch.incubate.autograd`` — functional higher-order
autograd, counterpart of ``paddle_tpu/incubate/autograd.py``.

``jvp``, ``vjp``, ``Jacobian``, ``Hessian``, ``jacobian`` and ``hessian``
are ``torch.func``'s transforms (``jvp``, ``vjp``, ``jacrev``,
``hessian``, with ``vmap`` for a batched first axis), as the reference's
are ``jax``'s, so they compose to any order. ``func`` takes Tensors and
returns Tensors; results are Tensors that stop gradients.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.func as tf

from ..core.tensor import Tensor

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "jacobian", "hessian"]


def _unwrap(v):
    if isinstance(v, Tensor):
        return v._value.detach()
    return torch.as_tensor(v)


def _wrap(v):
    return Tensor(v, stop_gradient=True)


def _as_tuple(xs):
    if isinstance(xs, (list, tuple)):
        return tuple(xs), True
    return (xs,), False


def _lift(func: Callable) -> Callable:
    """A Tensor -> Tensor function as a torch -> torch one. The inputs
    are wrapped as Tensors that carry gradients, so the dispatcher keeps
    the transform's tracking on every op's output."""

    def tfn(*args):
        outs = func(*[Tensor._wrap(a, False) for a in args])
        if isinstance(outs, (list, tuple)):
            return tuple(o._value if isinstance(o, Tensor) else o
                         for o in outs)
        return outs._value if isinstance(outs, Tensor) else outs

    return tfn


def jvp(func: Callable, xs, v=None):
    """Forward-mode Jacobian-vector product: ``(func(xs), J·v)``; ``v``
    defaults to ones like ``xs`` (the reference's behaviour)."""
    xs_t, _ = _as_tuple(xs)
    primals = tuple(_unwrap(x) for x in xs_t)
    if v is None:
        tangents = tuple(torch.ones_like(p) for p in primals)
    else:
        v_t, _ = _as_tuple(v)
        tangents = tuple(_unwrap(t) for t in v_t)
    out, tan = tf.jvp(_lift(func), primals, tangents)
    if isinstance(out, tuple):
        return [_wrap(o) for o in out], [_wrap(t) for t in tan]
    return _wrap(out), _wrap(tan)


def vjp(func: Callable, xs, v=None):
    """Reverse-mode vector-Jacobian product: ``(func(xs), vᵀ·J)``; ``v``
    defaults to ones like the output."""
    xs_t, was_seq = _as_tuple(xs)
    primals = tuple(_unwrap(x) for x in xs_t)
    out, vjp_fn = tf.vjp(_lift(func), *primals)
    if v is None:
        cot = (tuple(torch.ones_like(o) for o in out)
               if isinstance(out, tuple) else torch.ones_like(out))
    elif isinstance(out, tuple):
        v_t, _ = _as_tuple(v)
        cot = tuple(_unwrap(t) for t in v_t)
    else:
        cot = _unwrap(v if not isinstance(v, (list, tuple)) else v[0])
    grads = vjp_fn(cot)
    outs = [_wrap(o) for o in out] if isinstance(out, tuple) else _wrap(out)
    gs = [_wrap(g) for g in grads]
    return outs, (gs if was_seq else gs[0])


def _numel(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out


class Jacobian:
    """Dense Jacobian of ``func`` at ``xs`` (the reference's
    ``incubate.autograd.Jacobian``), computed with ``jacrev`` on first
    access; indexes and slices like the reference's lazy object.

    For one input and output: (ys_size, xs_size) over the non-batch dims
    (``is_batched`` keeps axis 0: (B, ys_size, xs_size))."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._func = _lift(func)
        self._xs, self._multi_in = _as_tuple(xs)
        self._batched = is_batched
        self._mat = None

    def _compute(self):
        if self._mat is not None:
            return self._mat
        primals = tuple(_unwrap(x) for x in self._xs)
        argnums = tuple(range(len(primals)))
        if self._batched:
            # vmap(jacrev): the batch diagonal at O(B) cost
            jac = tf.vmap(tf.jacrev(self._func, argnums=argnums))(*primals)
        else:
            jac = tf.jacrev(self._func, argnums=argnums)(*primals)
        if isinstance(jac, tuple) and not self._multi_in:
            jac = jac[0]

        def flatten(j, y_shape, x_shape):
            m = _numel(y_shape) if y_shape else 1
            n = _numel(x_shape) if x_shape else 1
            if self._batched:
                return j.reshape((j.shape[0], m, n))
            return j.reshape((m, n))

        def shapes(j, x_shape):
            if self._batched:
                x_shape = x_shape[1:]
                return tuple(j.shape[1:j.dim() - len(x_shape)]), x_shape
            return tuple(j.shape[:j.dim() - len(x_shape)]), x_shape

        if self._multi_in:
            out = []
            for p, j in zip(primals, jac):
                ys, xs_ = shapes(j, tuple(p.shape))
                out.append(_wrap(flatten(j, ys, xs_)))
            self._mat = out
        else:
            ys, xs_ = shapes(jac, tuple(primals[0].shape))
            self._mat = _wrap(flatten(jac, ys, xs_))
        return self._mat

    def __getitem__(self, idx):
        m = self._compute()
        if isinstance(m, list):
            return [t[idx] for t in m]
        return m[idx]

    @property
    def shape(self):
        m = self._compute()
        return [t.shape for t in m] if isinstance(m, list) else m.shape


class Hessian:
    """Dense Hessian of a scalar-output ``func`` at ``xs`` (the
    reference's ``incubate.autograd.Hessian``): ``torch.func.hessian``."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._func = _lift(func)
        self._xs, self._multi_in = _as_tuple(xs)
        self._batched = is_batched
        self._mat = None

    def _compute(self):
        if self._mat is not None:
            return self._mat
        primals = tuple(_unwrap(x) for x in self._xs)
        if self._multi_in:
            raise NotImplementedError(
                "Hessian over multiple inputs: concatenate them first "
                "(the reference has the same single-block limitation)")
        x = primals[0]
        func = self._func

        def scalar(f_x):
            return torch.sum(func(f_x))  # the reference squeezes a (1,) output

        if self._batched:
            b = x.shape[0]
            n = x.numel() // b
            h = tf.vmap(tf.hessian(scalar))(x)
            self._mat = _wrap(h.reshape((b, n, n)))
        else:
            n = x.numel()
            self._mat = _wrap(tf.hessian(scalar)(x).reshape((n, n)))
        return self._mat

    def __getitem__(self, idx):
        return self._compute()[idx]

    @property
    def shape(self):
        return self._compute().shape


def jacobian(func: Callable, xs, is_batched: bool = False):
    """The materialized :class:`Jacobian` (a Tensor)."""
    return Jacobian(func, xs, is_batched=is_batched)._compute()


def hessian(func: Callable, xs, is_batched: bool = False):
    """The materialized :class:`Hessian` (a Tensor)."""
    return Hessian(func, xs, is_batched=is_batched)._compute()
