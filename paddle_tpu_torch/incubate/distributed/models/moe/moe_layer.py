"""The MoE layer — counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``.

gate → dispatch → experts → combine. The gather dispatch (l.151-220):
``ops.moe_ops.dispatch_indices_topk`` routes each (token, choice) to a
slot of its expert in the joint top-K order, the slots are gathered
(``moe_dispatch_gather``), each expert runs on its ``C`` slots, and the
outputs are gathered back, weighted by the gate's probabilities
(``moe_combine_gather``). Every shape is static and nothing is read on
the host, so a compiled train step captures the layer.

Over a ``moe_group`` of more than one rank (one rank a process) the
layer's input is this rank's tokens, a slab of the global token set in
rank order, and its output this rank's slab of the reference's output:
the gate gates the global set (``gate.py``), and when every expert is
``Linear → activation → Linear`` the expert-parallel path runs
(``_forward_expert_parallel``, l.222): each rank dispatches its tokens
at ``ceil(C / n)`` slots an expert, an all-to-all over the group brings
each rank the slots of its ``E / n`` experts, and the inverse all-to-all
brings the outputs home. Otherwise the ranks' tokens are all-gathered,
the gather path runs on the global set, and each rank keeps its rows.

Every rank holds every expert's weights (the reference's global
arrays). On the expert-parallel path a rank runs only its own experts:
their gradients are the sum of every rank's contribution through the
all-to-all, and the other experts' gradients are 0 on it. The
data-parallel mean over the group (``jit.TrainStep``) then gives every
rank each expert's gradient of the global mean loss, so the replicas
stay equal. Expert parameters carry ``expert = True``, and on that path
``expert_rank``, the group rank that owns them
(``ClipGradForMOEByGlobalNorm`` counts an expert once, on its owner).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as TF

from .....core.dispatch import apply
from .....core.tensor import Tensor
from .....nn.layer import Layer, LayerList
from .....ops import moe_ops
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, live_group

_ACTS = {"GELU": "gelu", "ReLU": "relu", "SiLU": "silu", "Silu": "silu"}
_ACT_FNS = {"gelu": TF.gelu, "relu": TF.relu, "silu": TF.silu}


def _ffn_parts(expert):
    """``(lin1, lin2, act_name)`` when ``expert`` is exactly Linear →
    a known activation → Linear with one bias layout; None otherwise."""
    from .....nn.common_layers import Linear

    seq = []
    for _, sub in expert.named_sublayers(include_self=True):
        if isinstance(sub, Linear):
            seq.append(("linear", sub))
        elif type(sub).__name__ in _ACTS:
            seq.append(("act", _ACTS[type(sub).__name__]))
        elif not list(sub.children()):
            return None
    if [k for k, _ in seq] != ["linear", "act", "linear"]:
        return None
    l1, l2 = seq[0][1], seq[2][1]
    if l1.weight.shape[1] != l2.weight.shape[0] or \
            l1.weight.shape[0] != l2.weight.shape[1]:
        return None
    if (l1.bias is None) != (l2.bias is None):
        return None
    return l1, l2, seq[1][1]


class MoELayer(Layer):
    """``MoELayer(d_model, experts=[...], gate='gshard', ...)``.

    experts: Layers each mapping (n, d_model) -> (n, d_model).
    gate: a ``BaseGate`` or one of 'naive' | 'gshard' | 'switch'.
    ``dtype`` / ``device`` (the port's): where a gate built by name puts
    its weight (None: the current place).
    """

    def __init__(self, d_model: int, experts: Optional[List[Layer]] = None,
                 gate="gshard", moe_group=None, mp_group=None,
                 recompute_interval: int = 0, random_routing: bool = True,
                 capacity_factor=(1.2, 2.4), topk: Optional[int] = None,
                 *, dtype=None, device=None, **kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        if not experts:
            raise ValueError("experts list must be non-empty")
        self.d_model = d_model
        self.experts = LayerList(experts)
        self.num_expert = len(experts)
        self.moe_group = moe_group
        if isinstance(gate, BaseGate):
            self.gate = gate
        elif gate in (None, "naive"):
            self.gate = NaiveGate(d_model, self.num_expert, 1, topk=topk or 2,
                                  **kw)
        elif gate == "gshard":
            self.gate = GShardGate(d_model, self.num_expert, 1,
                                   capacity=capacity_factor,
                                   random_routing=random_routing, **kw)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, self.num_expert, 1,
                                   capacity=capacity_factor, **kw)
        else:
            raise ValueError(f"unknown gate {gate!r}")
        self.capacity_factor = capacity_factor
        for p in self.experts.parameters():
            p.expert = True
        self.l_aux = None
        self._group = live_group(moe_group)
        self.gate.group = self._group
        self._ep_parts = None
        if self._group is not None:
            parts = [_ffn_parts(e) for e in experts]
            homogeneous = (
                all(p is not None for p in parts)
                and len({p[2] for p in parts}) == 1
                and len({p[0].bias is None for p in parts}) == 1)
            n = self._group.nranks
            if homogeneous and self.num_expert % n == 0:
                self._ep_parts = parts
                per = self.num_expert // n
                for e, ex in enumerate(experts):
                    for p in ex.parameters():
                        p.expert_rank = e // per

    def forward(self, inp):
        if isinstance(inp, Tensor):
            out, aux = apply(lambda v, *_: self._moe(v), inp,
                             *self.parameters(), op_name="moe_layer")
            self.l_aux = aux
            return out
        out, self.l_aux = self._moe(inp)
        return out

    def _capacity(self, n_all: int) -> int:
        factor = getattr(self.gate, "capacity_factor", None)
        if factor is None:
            factor = self.capacity_factor
        if isinstance(factor, (tuple, list)):
            factor = factor[0] if self.training else factor[1]
        return max(int(np.ceil(factor * n_all / self.num_expert)), 1)

    def _moe(self, inp):
        """``(output, l_aux)`` over torch tensors."""
        shape = tuple(inp.shape)
        xf = inp.reshape(-1, shape[-1])
        g = self._group
        if g is not None and self._ep_parts is None:
            # the reference's gather path over the global token set; each
            # rank keeps its rows
            from .....distributed import collective as C
            n = xf.shape[0]
            self.gate.group = None
            try:
                out, aux = self._gather_path(C._AllGather.apply(xf, g, 0))
            finally:
                self.gate.group = g
            return out[g.rank * n:(g.rank + 1) * n].reshape(shape), aux
        path = self._gather_path if g is None else \
            self._forward_expert_parallel
        out, aux = path(xf)
        return out.reshape(shape), aux

    def _route(self, xf):
        """Gate, then the combine probabilities (``idx``, ``probs``): top-1
        keeps the raw gate probability (Switch: y = p·E(x)), top-k
        renormalizes over the admitted choices."""
        idx, topv, aux = self.gate._gate(xf)
        valid = (idx >= 0).to(topv.dtype)
        probs = topv * valid
        if idx.shape[1] > 1:
            probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return idx, probs, aux

    def _gather_path(self, xf):
        n = xf.shape[0]
        idx, probs, aux = self._route(xf)
        E, C = self.num_expert, self._capacity(n)
        routes = moe_ops.dispatch_indices_topk(idx, E, C)
        tfs, cfs, flats, oks = moe_ops.dispatch_plan(routes, E, C, n)
        expert_in = moe_ops.moe_dispatch_gather(xf, tfs, flats, oks, E, C)
        expert_out = torch.stack([self.experts[e](expert_in[e])
                                  for e in range(E)], dim=0)
        return (moe_ops.moe_combine_gather(expert_out, probs, flats, oks,
                                           tfs, cfs), aux)

    def _forward_expert_parallel(self, xf):
        """``(output, l_aux)`` of this rank's tokens through
        ``expert_parallel_apply`` over the group: capacity from the global token count, ``ceil(C / n)``
        slots an expert on each source rank (l.231), this rank's
        experts' weights sliced from the stacked ones (the other
        experts' gradients are 0 here)."""
        g = self._group
        nr = g.nranks
        idx, probs, aux = self._route(xf)
        capacity = self._capacity(xf.shape[0] * nr)
        cap_local = max(int(np.ceil(capacity / nr)), 1)
        l1s, l2s, acts = zip(*self._ep_parts)
        per = self.num_expert // nr
        mine = slice(g.rank * per, (g.rank + 1) * per)
        w1 = torch.stack([l.weight for l in l1s], dim=0)[mine]
        w2 = torch.stack([l.weight for l in l2s], dim=0)[mine]
        b1 = b2 = None
        if l1s[0].bias is not None:
            b1 = torch.stack([l.bias for l in l1s], dim=0)[mine]
            b2 = torch.stack([l.bias for l in l2s], dim=0)[mine]
        return moe_ops.expert_parallel_apply(
            xf, idx, probs, w1, w2, g, self.num_expert, cap_local,
            act=_ACT_FNS[acts[0]], b1_local=b1, b2_local=b2), aux
