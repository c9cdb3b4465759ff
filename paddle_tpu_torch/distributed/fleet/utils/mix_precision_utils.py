"""main_grad mixed precision — counterpart of
``paddle_tpu/distributed/fleet/utils/mix_precision_utils.py`` (l.23-93).

Parameters are low precision; each micro-batch's gradient is folded into
an fp32 ``main_grad`` buffer, a plain attribute of the parameter, and
the optimizer steps from that buffer. The fold adds ``grad.float()`` of
the gradient autograd produced in the parameter's dtype (the reference
folds ``g.astype(f32)``, l.50): recomputing it in fp32 would drift from
the reference by one bf16 rounding a micro-batch.
"""

from __future__ import annotations

from ..meta_optimizers import unwrap_optimizer as _base_optimizer


class MixPrecisionLayer:
    """Wraps a module: calls and attributes go to it; after each
    micro-batch's ``backward()``, :meth:`accumulate_main_grads` folds
    every parameter's gradient into its fp32 ``main_grad`` and clears
    the gradient."""

    def __init__(self, layers, dtype: str = "bfloat16"):
        self._layers = layers
        self._dtype = dtype

    def __getattr__(self, item):
        return getattr(self._layers, item)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    forward = __call__

    def accumulate_main_grads(self) -> None:
        """``main_grad += grad.float()`` (``main_grad`` made at the
        first fold) and ``grad = None`` for every parameter that has a
        gradient. The reference folds in a per-parameter backward hook;
        the JAX package, and the port with it, sweep once a micro-batch."""
        for p in self._layers.parameters():
            g = p.grad
            if g is None:
                continue
            mg = getattr(p, "main_grad", None)
            if mg is None:
                p.main_grad = g.float()
            else:
                mg.add_(g.float())
            p.grad = None


class MixPrecisionOptimizer:
    """Wraps an optimizer to step from ``main_grad`` instead of
    ``.grad``: for the step, the base optimizer's :meth:`_grads` gives
    each parameter its ``main_grad`` where it has one (its ``.grad``
    otherwise), as the reference swaps ``main_grad`` into the gradient
    slot (l.67-78)."""

    def __init__(self, optimizer):
        self._inner_opt = optimizer

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        base = _base_optimizer(self._inner_opt)
        params = base._parameter_list
        base._grads = lambda: [
            p.grad if getattr(p, "main_grad", None) is None else p.main_grad
            for p in params]
        try:
            self._inner_opt.step()
        finally:
            del base._grads

    def clear_grad(self, set_to_zero: bool = False):
        """``main_grad`` zeroed in place (``set_to_zero``) or dropped,
        then the wrapped optimizer's ``clear_grad``."""
        for p in _base_optimizer(self._inner_opt)._parameter_list:
            mg = getattr(p, "main_grad", None)
            if set_to_zero and mg is not None:
                mg.zero_()
            else:
                p.main_grad = None
        self._inner_opt.clear_grad(set_to_zero=False)


def unwrap_optimizer(optimizer):
    """The optimizer under any stack of ``MixPrecisionOptimizer``s."""
    opt = optimizer
    while isinstance(opt, MixPrecisionOptimizer):
        opt = opt._inner_opt
    return opt
