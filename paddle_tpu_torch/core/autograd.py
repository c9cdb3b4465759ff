"""Imperative autograd — counterpart of ``paddle_tpu/core/autograd.py``.

The JAX package records its own tape (a ``GradNode`` per op holding the
``jax.vjp`` closure) and walks it in ``backward``. Here the graph is
torch's: a ``core.tensor.Tensor`` holds a torch tensor, and the
functions below keep the reference's observable semantics on top of
``torch.autograd``:

* ``backward()`` on a non-scalar with no ``grad_tensor`` seeds ones
  (torch refuses that case, so the seed is passed explicitly);
* a second backward through a graph that was not retained raises
  RuntimeError with the reference's message, also where torch would
  not (a graph that saved no tensor);
* :func:`grad` never writes ``.grad``, and raises ValueError for an
  unused input unless ``allow_unused`` (torch raises RuntimeError).
"""

from __future__ import annotations

import contextlib

import torch

_RELEASED = ("Trying to backward through the graph a second time, but the "
             "graph buffers have already been released. Specify "
             "retain_graph=True on the first backward call.")


# --------------------------------------------------------------------------
# Grad mode
# --------------------------------------------------------------------------
def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


@contextlib.contextmanager
def no_grad():
    with torch.no_grad():
        yield


@contextlib.contextmanager
def enable_grad():
    with torch.enable_grad():
        yield


def set_grad_enabled(mode: bool):
    """Context manager form, parity with paddle.set_grad_enabled."""
    return enable_grad() if mode else no_grad()


# --------------------------------------------------------------------------
# Backward
# --------------------------------------------------------------------------
def _seed(value, grad_tensor):
    if grad_tensor is None:
        return torch.ones_like(value)
    g = grad_tensor._value if hasattr(grad_tensor, "_value") else grad_tensor
    return torch.as_tensor(g, dtype=value.dtype, device=value.device)


def _check_live(node) -> None:
    if node.metadata.get("paddle_released"):
        raise RuntimeError(_RELEASED)


def _release(nodes) -> None:
    for node in nodes:
        node.metadata["paddle_released"] = True


@contextlib.contextmanager
def _released_as_reference():
    """torch's own "backward a second time" error, reworded as the
    reference's."""
    try:
        yield
    except RuntimeError as e:
        if "a second time" in str(e):
            raise RuntimeError(_RELEASED) from e
        raise


def backward(tensor, grad_tensor=None, retain_graph: bool = False,
             capture=None) -> None:
    """Reverse accumulation from ``tensor`` into the ``.grad`` of the
    leaves that do not stop gradients (``paddle.autograd.backward`` /
    ``Tensor.backward()``). A tensor with no graph is a no-op, as in the
    reference. ``capture`` is the reference's internal hook for
    :func:`grad` and is not supported here."""
    if capture is not None:
        raise ValueError("capture= is internal to the JAX package's tape; "
                         "use paddle.grad")
    value = tensor._value
    node = value.grad_fn
    if node is None:
        return
    _check_live(node)
    with _released_as_reference():
        torch.autograd.backward(value, _seed(value, grad_tensor),
                                retain_graph=retain_graph)
    if not retain_graph:
        _release([node])


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (leaves or intermediates), as stop-gradient Tensors; no
    ``.grad`` is written. Non-scalar outputs are seeded with ones."""
    from .tensor import Tensor

    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    outs, seeds = [], []
    for i, o in enumerate(outputs):
        g = None if grad_outputs is None else grad_outputs[i]
        if o._value.grad_fn is not None:
            _check_live(o._value.grad_fn)
        if o._value.requires_grad:
            outs.append(o._value)
            seeds.append(_seed(o._value, g))
    keep = retain_graph or create_graph
    got = [None] * len(inputs)
    if outs:
        wrt = [t._value for t in inputs]
        live = [i for i, v in enumerate(wrt) if v.requires_grad]
        with _released_as_reference():
            res = torch.autograd.grad(outs, [wrt[i] for i in live], seeds,
                                      retain_graph=keep, allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
        if not keep:
            _release([o.grad_fn for o in outs if o.grad_fn is not None])
    results = []
    for g in got:
        if g is None:
            if not allow_unused:
                raise ValueError("an input tensor is unused in the graph")
            results.append(None)
        else:
            results.append(Tensor(g.detach(), stop_gradient=True))
    return results
