"""``paddle_tpu_torch.autograd`` — the public autograd surface,
counterpart of ``paddle_tpu/autograd/__init__.py``: ``backward``,
``grad``, the grad-mode contexts, :func:`jacobian` and :class:`PyLayer`
(a custom differentiable op, over ``torch.autograd.Function``).
``hessian`` raises, as the reference's does: its tape records
first-order gradients only.
"""

import torch

from ..core.autograd import backward, grad, no_grad, enable_grad, set_grad_enabled  # noqa: F401
from ..core.tensor import Tensor


def jacobian(ys, xs, batch_axis=None):
    """Dense jacobian of computed tensor(s) ``ys`` w.r.t. leaf tensor(s)
    ``xs`` (reference ``paddle.autograd.jacobian``): one seeded backward
    pass per element of ``ys`` (per non-batch element with
    ``batch_axis=0``). Shapes: ys (M…), xs (N…) -> (M_flat, N_flat);
    with ``batch_axis=0``, ys (B, M…), xs (B, N…) -> (B, M_flat,
    N_flat)."""
    if batch_axis not in (None, 0):
        raise ValueError("batch_axis must be None or 0")
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]
    if isinstance(ys, (list, tuple)):
        return [jacobian(y, xs, batch_axis=batch_axis) for y in ys]

    y_shape = tuple(ys.shape)
    yv = ys._value
    if batch_axis == 0:
        b = y_shape[0]
        m = int(torch.tensor(y_shape[1:]).prod()) if len(y_shape) > 1 else 1
    else:
        m = int(torch.tensor(y_shape).prod()) if y_shape else 1

    rows = []
    for j in range(m):
        if batch_axis == 0:
            seed = torch.zeros((b, m), dtype=yv.dtype, device=yv.device)
            seed[:, j] = 1
        else:
            seed = torch.zeros((m,), dtype=yv.dtype, device=yv.device)
            seed[j] = 1
        gs = grad([ys], xs_list, grad_outputs=[Tensor(seed.reshape(y_shape))],
                  retain_graph=True, allow_unused=True)
        rows.append([None if g is None else g._value for g in gs])

    outs = []
    for i, x in enumerate(xs_list):
        x_shape = tuple(x.shape)
        if batch_axis == 0:
            n = int(torch.tensor(x_shape[1:]).prod()) if len(x_shape) > 1 else 1
            cols = [torch.zeros((b, n), dtype=yv.dtype, device=yv.device)
                    if r[i] is None else r[i].reshape(b, n) for r in rows]
            outs.append(Tensor(torch.stack(cols, dim=1)))   # (B, M, N)
        else:
            n = int(torch.tensor(x_shape).prod()) if x_shape else 1
            cols = [torch.zeros((n,), dtype=yv.dtype, device=yv.device)
                    if r[i] is None else r[i].reshape(n) for r in rows]
            outs.append(Tensor(torch.stack(cols, dim=0)))   # (M, N)
    if isinstance(xs, (list, tuple)):
        return outs
    return outs[0]


def hessian(ys, xs, batch_axis=None):
    """Raises, as the reference's ``paddle.autograd.hessian`` does (its
    tape records first-order gradients only)."""
    raise NotImplementedError(
        "tape-based hessian needs double-grad, which the reference's tape "
        "does not record; the port keeps its surface")


class PyLayerContext:
    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _PyLayerFunction(torch.autograd.Function):
    """One PyLayer application: the user's forward on Tensors (no
    gradients recorded inside), the user's backward on Tensors of the
    output gradients."""

    @staticmethod
    def forward(fctx, cls, ctx, args, kwargs, slots, *values):
        it = iter(values)
        full = [Tensor._wrap(next(it), True) if s else a
                for a, s in zip(args, slots)]
        with torch.no_grad():
            outs = cls.forward(ctx, *full, **kwargs)
        single = not isinstance(outs, (tuple, list))
        outs_t = (outs,) if single else tuple(outs)
        ctx._single = single
        fctx.pylayer = (cls, ctx, slots)
        vals = tuple(o._value if isinstance(o, Tensor) else o for o in outs_t)
        # an output that is an input must be a new tensor to take a grad_fn
        return tuple(v.view_as(v) if any(v is x for x in values) else v
                     for v in vals)

    @staticmethod
    def backward(fctx, *cots):
        cls, ctx, slots = fctx.pylayer
        gs = cls.backward(ctx, *[Tensor._wrap(c, True) for c in cots])
        gs = (gs,) if isinstance(gs, Tensor) or gs is None else tuple(gs)
        grads = [None if g is None else g._value for g in gs]
        grads += [None] * (sum(slots) - len(grads))
        return (None, None, None, None, None) + tuple(grads[:sum(slots)])


class PyLayer:
    """Custom differentiable op, parity with paddle.autograd.PyLayer.

    Subclasses define ``forward(ctx, *args)`` and ``backward(ctx,
    *grads)`` on Tensors; ``backward`` returns one gradient per Tensor
    argument of ``forward`` (None for none)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        slots = tuple(isinstance(a, Tensor) for a in args)
        tensors = [a for a in args if isinstance(a, Tensor)]
        needs_grad = torch.is_grad_enabled() and any(
            not t.stop_gradient for t in tensors)
        if not needs_grad:
            with torch.no_grad():
                outs = cls.forward(ctx, *args, **kwargs)
            return outs if not isinstance(outs, (tuple, list)) else list(outs)
        vals = _PyLayerFunction.apply(cls, ctx, args, kwargs, slots,
                                      *[t._value for t in tensors])
        wrapped = [Tensor._wrap(v, not v.requires_grad) for v in vals]
        return wrapped[0] if ctx._single else wrapped
