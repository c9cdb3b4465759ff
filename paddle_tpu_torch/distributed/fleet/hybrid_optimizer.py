"""Hybrid-parallel optimizer wrapper — counterpart of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``
(``HybridParallelOptimizer`` and ``HybridParallelClipGrad``).

Each rank holds its slabs (mp-split weights, ZeRO slabs of gradients)
and only its pipeline stage's parameters, so the global gradient norm
is a sum over ranks: the squares of mp-split parameters
(``is_distributed``) are summed over the mp group, those of
ZeRO-sliced gradients over the sharding group, and the total over the
pp group; a replicated parameter counts once. With no group of more
than one rank the clip is ``ClipGradByGlobalNorm``'s own arithmetic
(bitwise). ``HybridParallelOptimizer.step`` averages the gradients over
the dp group first (the reference's one controller has global
gradients already), as Paddle's does.
"""

from __future__ import annotations

import torch

from ...optimizer.clip import ClipGradByGlobalNorm, _div, _need_clip
from ...optimizer.optimizer import Optimizer
from .. import collective as C


def _live(g) -> bool:
    return g is not None and g.nranks > 1 and C._communicates(g)


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    def __init__(self, clip, hcg):
        clip_norm = getattr(clip, "clip_norm", clip)
        super().__init__(float(clip_norm))
        self._hcg = hcg

    def _groups(self):
        h = self._hcg
        if h is None:
            return None, None, None
        return (h.get_model_parallel_group(),
                h.get_sharding_parallel_group(),
                h.get_pipe_parallel_group())

    def _communicates(self) -> bool:
        return any(_live(g) for g in self._groups())

    def global_norm(self, grads):
        """The norm of ``grads`` (this rank's), summed over the mp,
        sharding and pp groups, every gradient counted as split."""
        if not self._communicates():
            return ClipGradByGlobalNorm.global_norm(grads)
        grads = [g for g in grads if g is not None]
        sq = torch.zeros((), dtype=torch.float32,
                         device=grads[0].device if grads else None)
        for g in grads:
            sq = sq + g.float().pow(2).sum()
        for g in self._groups():
            if _live(g):
                sq = C._raw_all_reduce(sq, g)
        return torch.sqrt(sq)

    def _clip(self, params_grads):
        if not self._communicates():
            return super()._clip(params_grads)
        mp, sharding, pp = self._groups()
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and _need_clip(p)]
        out = list(params_grads)
        if not idx:
            return out
        dev = params_grads[idx[0]][1].device
        # [mp-split][zero-sliced] sums of squares
        sums = [[torch.zeros((), dtype=torch.float32, device=dev)
                 for _ in range(2)] for _ in range(2)]
        for i in idx:
            p, g = params_grads[i]
            a = int(bool(getattr(p, "is_distributed", False)))
            b = int(bool(getattr(g, "_zero_sliced", False)))
            sums[a][b] = sums[a][b] + g.float().pow(2).sum()
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(2):
            for b in range(2):
                s = sums[a][b]
                if a and _live(mp):
                    s = C._raw_all_reduce(s, mp)
                if b and _live(sharding):
                    s = C._raw_all_reduce(s, sharding)
                total = total + s
        if _live(pp):
            total = C._raw_all_reduce(total, pp)
        gnorm = torch.sqrt(total)
        scale = _div(self.clip_norm, torch.clamp(gnorm, min=self.clip_norm))
        for i in idx:
            p, g = params_grads[i]
            q = (g.float() * scale).to(g.dtype)
            if getattr(g, "_zero_sliced", False):
                q._zero_sliced = True
            out[i] = (p, q)
        return out


class HybridParallelOptimizer:
    """Delegating wrapper: stage-1 sharding (``DygraphShardingOptimizer``)
    when the sharding degree is above 1, the hybrid-aware clip in place
    of a ``ClipGradByGlobalNorm``, and the dp average of the gradients
    before each step."""

    def __init__(self, optimizer, hcg, strategy):
        from .meta_optimizers import unwrap_optimizer
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1 \
                and isinstance(unwrap_optimizer(optimizer), Optimizer) \
                and not self._already_sharded(optimizer):
            from .dygraph_sharding_optimizer import DygraphShardingOptimizer
            optimizer = DygraphShardingOptimizer(optimizer, hcg)
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        inner = unwrap_optimizer(optimizer)
        if isinstance(inner._grad_clip, ClipGradByGlobalNorm) and \
                not isinstance(inner._grad_clip, HybridParallelClipGrad) and \
                hcg is not None:
            inner._grad_clip = HybridParallelClipGrad(inner._grad_clip, hcg)

    @staticmethod
    def _already_sharded(optimizer) -> bool:
        from .dygraph_sharding_optimizer import DygraphShardingOptimizer
        o, seen = optimizer, set()
        while o is not None and id(o) not in seen:
            seen.add(id(o))
            if isinstance(o, DygraphShardingOptimizer):
                return True
            o = getattr(o, "_inner_opt", None) or getattr(o, "inner_opt", None)
        return False

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    @property
    def inner_opt(self):
        return self._inner_opt

    def step(self):
        from .utils.hybrid_parallel_util import fused_allreduce_gradients
        from .meta_optimizers import unwrap_optimizer
        h = self._hcg
        if h is not None and h.get_data_parallel_world_size() > 1:
            fused_allreduce_gradients(
                unwrap_optimizer(self._inner_opt)._parameter_list, h)
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)
