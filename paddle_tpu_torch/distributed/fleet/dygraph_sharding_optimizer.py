"""Stage-1 sharding optimizer of the Fleet path — counterpart of
``paddle_tpu/distributed/fleet/dygraph_sharding_optimizer.py``.

ZeRO stage 1 by parameter: each rank of the sharding group owns the
optimizer state and the update of a size-balanced subset of the
parameters (the rank-to-parameter partition of the reference's
l.39-47, largest first onto the lightest rank). A step averages the
gradients over the group, clips over all of them (every rank holds
every averaged gradient, so the norm is global), updates the owned
parameters and broadcasts each parameter from its owner.
"""

from __future__ import annotations

import torch

from ...optimizer.optimizer import Optimizer, _lr_factor
from .. import collective as C
from ..sharding.group_sharded import (GroupShardedOptimizerStage2,
                                      _greedy_partition, _live)


class DygraphShardingOptimizer(GroupShardedOptimizerStage2):
    """Parity class name; stage 1 by parameter (the gradients and the
    parameters stay whole)."""

    def __init__(self, optimizer: Optimizer, hcg=None):
        group = hcg.get_sharding_parallel_group() if hcg is not None \
            else None
        super().__init__(list(optimizer._parameter_list), optimizer,
                         group=group, shard_grads=False)
        self.param2rank = _greedy_partition(
            list(zip(optimizer._names, optimizer._parameter_list)),
            self._degree)

    def _partition_parameters(self):
        rank2params = {}
        for name, r in self.param2rank.items():
            rank2params.setdefault(r, []).append(name)
        return {r: sorted(v) for r, v in rank2params.items()}

    @property
    def _rank2params(self):
        return self._partition_parameters()

    def _state_of(self, name, p):
        return self._optim._state_of(name, p)

    def _owned_update(self, lr, t) -> None:
        opt, g = self._optim, self._group
        n = g.nranks
        for p in opt._parameter_list:
            if p.grad is not None:
                C.all_reduce(p.grad, group=g)
                p.grad.div_(n)
        items = []
        for name, p, gr in opt._live():
            if self.param2rank.get(name, 0) != g.rank:
                continue
            wd = opt._weight_decay if opt._decay_enabled(name, p) else 0.0
            f = _lr_factor(p)
            items.append((name, p, gr, lr if f == 1.0 else lr * f, wd))
        opt._apply(items, t)
        for name, p in zip(opt._names, opt._parameter_list):
            C.broadcast(p, src=g.ranks[self.param2rank.get(name, 0)],
                        group=g)

    def _sharded_update(self, lr, t) -> None:
        if not _live(self._group):
            from ...jit import compiled_update
            return compiled_update(self._optim, lr, t)
        from ...jit import keep_slots
        held = {k: dict(s) for k, s in self._optim.state.items()}
        self._owned_update(lr, t)
        keep_slots(self._optim, held)

    @torch.no_grad()
    def step(self):
        if not _live(self._group):
            return self._optim.step()
        opt = self._optim
        opt._step_count += 1
        self._owned_update(opt.get_lr(), opt._step_count)
