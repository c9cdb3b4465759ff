"""Optimizer wrappers of ``paddle_tpu/distributed/fleet/meta_optimizers``
that main-grad training needs: ``_DelegatingMetaOptimizer`` (l.33) and
``GradientMergeOptimizer`` (l.113-150), k-step accumulation. The other
strategies (AMP, recompute, sharding, pipeline, Lamb, localsgd) come
with later slices of the port.
"""

from __future__ import annotations


def unwrap_optimizer(opt):
    """Follow the wrapper chain (``_inner_opt`` / ``inner_opt``) to the
    base optimizer that holds the parameters and the update rule."""
    seen = set()
    while id(opt) not in seen:
        seen.add(id(opt))
        nxt = getattr(opt, "_inner_opt", None) or getattr(opt, "inner_opt",
                                                         None)
        if nxt is None:
            return opt
        opt = nxt
    return opt


class _DelegatingMetaOptimizer:
    """Wraps an inner optimizer; subclasses attach their transform."""

    def __init__(self, optimizer):
        self.inner_opt = optimizer

    def __getattr__(self, item):
        if item == "inner_opt":  # not set yet (unpickling): no recursion
            raise AttributeError(item)
        return getattr(self.inner_opt, item)

    def step(self):
        self.inner_opt.step()

    def clear_grad(self, *a, **k):
        self.inner_opt.clear_grad(*a, **k)


class GradientMergeOptimizer(_DelegatingMetaOptimizer):
    """k-step gradient accumulation: ``step`` applies the update only
    every k-th call (gradients keep accumulating between them), first
    dividing every ``.grad`` and ``main_grad`` by k when ``avg``;
    ``clear_grad`` drops gradients only after a real update."""

    def __init__(self, optimizer, k_steps: int = 1, avg: bool = True):
        super().__init__(optimizer)
        self._k = max(int(k_steps), 1)
        self._avg = bool(avg)
        self._calls = 0
        self._stepped = False

    def step(self):
        self._calls += 1
        if self._calls % self._k:
            self._stepped = False
            return
        if self._avg and self._k > 1:
            for p in unwrap_optimizer(self.inner_opt)._parameter_list:
                for g in (p.grad, getattr(p, "main_grad", None)):
                    if g is not None:
                        g.div_(self._k)
        self.inner_opt.step()
        self._stepped = True

    def clear_grad(self, *a, **k):
        if self._stepped:  # between accumulation steps grads must survive
            self.inner_opt.clear_grad(*a, **k)
