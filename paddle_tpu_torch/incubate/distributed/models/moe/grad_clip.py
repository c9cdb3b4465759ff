"""The expert-aware global-norm clip — counterpart of
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``.

Expert parameters (``p.expert``) may live on one rank of the expert
group: over a ``moe_group`` of more than one rank, each expert's squared
norm is counted on the rank that owns it (``p.expert_rank``, rank 0 for
an expert every rank holds alike) and summed over the group, so every
expert counts once; each replicated parameter counts once, locally.
Without a group (or over one rank) it is the plain global norm over both
kinds, as the reference's single controller computes it. The norm's
scale stays on the device.
"""

from __future__ import annotations

import torch

from .....optimizer.clip import ClipGradByGlobalNorm, _div, _need_clip
from .gate import live_group


def _sq_sum(grads, device=None):
    total = torch.zeros((), dtype=torch.float32, device=device)
    for g in grads:
        total = total + g.float().pow(2).sum()
    return total


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__(clip_norm, group_name)
        self.moe_group = moe_group
        self.is_expert_param_func = is_expert_param_func or (
            lambda p: getattr(p, "expert", False))

    def _clip(self, params_grads):
        pairs = [(p, g) for p, g in params_grads
                 if g is not None and _need_clip(p)]
        if not pairs:
            return list(params_grads)
        dev = pairs[0][1].device
        g = live_group(self.moe_group)
        normal = [gr for p, gr in pairs if not self.is_expert_param_func(p)]
        expert = [gr for p, gr in pairs if self.is_expert_param_func(p)
                  and (g is None or getattr(p, "expert_rank", 0) == g.rank)]
        sq_expert = _sq_sum(expert, dev)
        if g is not None:
            from .....distributed import collective as C
            sq_expert = C._raw_all_reduce(sq_expert, g)
        gnorm = torch.sqrt(_sq_sum(normal, dev) + sq_expert)
        scale = _div(self.clip_norm, torch.clamp(gnorm, min=self.clip_norm))
        return [(p, gr) if gr is None or not _need_clip(p)
                else (p, (gr.float() * scale).to(gr.dtype))
                for p, gr in params_grads]


ClipGradByGlobalNormForMOE = ClipGradForMOEByGlobalNorm
