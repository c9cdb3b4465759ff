"""Strategy-driven optimizer wrappers — counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``.

Each wrapper performs its strategy's transform directly: AMP's master
weights and configured loss scaler, k-step gradient merge, local SGD's
periodic parameter averaging over the dp group, the swap to Lamb; or
carries the config that the model side reads (recompute, sharding,
pipeline). ``unwrap_optimizer`` reaches the base optimizer through any
stack of wrappers.
"""

from __future__ import annotations

from typing import Optional


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

    def clear_gradients(self, *a, **k):
        # dynamic dispatch, so that a subclass's clear_grad (gradient
        # merge) holds through the legacy name too
        return self.clear_grad(*a, **k)

    def state_dict(self):
        return self.inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self.inner_opt.set_state_dict(sd)


class AMPOptimizer(_DelegatingMetaOptimizer):
    """amp strategy: master weights at O2 and a configured
    ``GradScaler``. bfloat16 needs no loss scaling, so the scaler scales
    dynamically only for float16, as the reference decides."""

    def __init__(self, optimizer, configs: Optional[dict] = None):
        super().__init__(optimizer)
        c = dict(configs or {})
        self.amp_level = c.get("level", "O1")
        self.amp_dtype = c.get("dtype", "bfloat16")
        base = unwrap_optimizer(optimizer)
        if self.amp_level == "O2":
            base._multi_precision = True
        from ....amp import GradScaler

        self.scaler = GradScaler(
            enable=(self.amp_dtype == "float16"
                    and c.get("use_dynamic_loss_scaling", True)),
            init_loss_scaling=c.get("init_loss_scaling", 2.0 ** 15),
            incr_ratio=c.get("incr_ratio", 2.0),
            decr_ratio=c.get("decr_ratio", 0.5),
            incr_every_n_steps=c.get("incr_every_n_steps", 1000),
            decr_every_n_nan_or_inf=c.get("decr_every_n_nan_or_inf", 2),
        )

    def get_loss_scaler(self):
        return self.scaler


class RecomputeOptimizer(_DelegatingMetaOptimizer):
    """recompute strategy: the transform is model-side
    (``fleet.recompute`` on the layers that ``recompute_configs
    ['checkpoints']`` names); this wrapper carries the config."""

    def __init__(self, optimizer, configs: Optional[dict] = None):
        super().__init__(optimizer)
        self.recompute_configs = dict(configs or {})


class ShardingOptimizer(_DelegatingMetaOptimizer):
    """sharding strategy: the sharded optimizer of the Fleet
    hybrid-training slice reads it."""


class PipelineOptimizer(_DelegatingMetaOptimizer):
    """pipeline strategy: the pipeline engines of the Fleet
    hybrid-training slice read it."""


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


class LambOptimizer(_DelegatingMetaOptimizer):
    """lamb strategy: the update rule becomes the port's ``Lamb``, with
    the caller's learning rate, parameters (by name) and clip; a
    parameter whose name holds a fragment of
    ``exclude_from_weight_decay`` takes no decay."""

    def __init__(self, optimizer, configs: Optional[dict] = None):
        from ....optimizer import Lamb

        base = unwrap_optimizer(optimizer)
        c = dict(configs or {})
        exclude = list(c.get("exclude_from_weight_decay", []))
        exclude_fn = None
        if exclude:
            names = {id(p): n for n, p in zip(base._names,
                                              base._parameter_list)}

            def exclude_fn(p):
                name = names.get(id(p), getattr(p, "name", "")) or ""
                return any(frag in name for frag in exclude)
        lamb = Lamb(
            learning_rate=base._learning_rate,
            lamb_weight_decay=c.get("lamb_weight_decay", 0.01),
            grad_clip=base._grad_clip,
            exclude_from_weight_decay_fn=exclude_fn,
            named_parameters=list(zip(base._names, base._parameter_list)),
        )
        super().__init__(lamb)


class LocalSGDOptimizer(_DelegatingMetaOptimizer):
    """localsgd: the inner step every call; every ``k_steps`` (from
    ``begin_step`` on) the parameters are averaged over the dp group.
    At one rank there is nothing to average."""

    def __init__(self, optimizer, k_steps: int = 1, group=None,
                 begin_step: int = 1):
        super().__init__(optimizer)
        self._k = max(int(k_steps), 1)
        self._group = group
        self._begin = max(int(begin_step), 0)
        self._calls = 0

    def step(self):
        self.inner_opt.step()
        self._calls += 1
        if self._calls >= self._begin and self._calls % self._k == 0:
            self._average_parameters()

    def _average_parameters(self):
        from ... import collective as C

        g = C.get_group(self._group)
        if g.nranks <= 1:
            return
        for p in unwrap_optimizer(self.inner_opt)._parameter_list:
            C.all_reduce(p, op=C.ReduceOp.AVG, group=g)


class DGCOptimizer(_DelegatingMetaOptimizer):
    """deep gradient compression: kept for the strategy surface; the
    gradients go uncompressed."""
