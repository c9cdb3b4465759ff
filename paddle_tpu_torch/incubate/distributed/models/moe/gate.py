"""MoE gates — counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``: Naive top-k,
GShard top-2 and Switch top-1. Each gate returns ``(indices, probs)``,
(N, K) each, and keeps its load-balancing loss on ``self.l_aux``.

The probabilities and the auxiliary loss carry gradients; the indices
(top-k, capacity pruning, random routing) are index data. GShard's
random-routing uniform (l.92) and Switch's jitter (l.125) are draws of
the framework key stream, so they are the reference's bit for bit.

Over an expert group of more than one rank (``self.group``, which
``MoELayer`` sets on its expert-parallel path) a gate's input is this
rank's tokens, a slab of the global token set in rank order, and it
gates as the reference's gate gates the global set: the draws cover the
global token count and each rank keeps its rows, the capacity is the
global count's, and capacity pruning walks the global order (the
ranks' indices all-gathered). The auxiliary loss on a rank is the
rank's share: its tokens' mean probabilities against the global top-1
fractions, so that the ranks' mean is the reference's loss and the
data-parallel mean of the ranks' gradients is its gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from .....core.dispatch import apply
from .....core.tensor import Tensor
from .....nn.layer import Layer, layer_device
from .....ops import moe_ops
from ..... import random as _random


def live_group(group):
    """``group`` as this process's communicating group, or None (no
    group, one rank, or no process group)."""
    if group is None:
        return None
    from .....distributed import collective as C
    if getattr(group, "mesh", None) is not None:
        group = group.mesh.group(group.axis)
    live = C._live([group])
    return live[0] if live else None


def _rows(group, n_local: int):
    """This rank's rows of the global token order."""
    r = group.rank if group is not None else 0
    return slice(r * n_local, (r + 1) * n_local)


def _n_global(group, n_local: int) -> int:
    return n_local * (group.nranks if group is not None else 1)


def _gather_idx(idx, group):
    """The global (N, K) indices: every rank's, in rank order."""
    if group is None:
        return idx
    from .....distributed import collective as C
    return C._raw_all_gather(idx, group, 0)


class BaseGate(Layer):
    """``dtype`` / ``device`` (the port's): where the gate's weight is
    built; None is the current place."""

    def __init__(self, num_expert: int, world_size: int = 1, *, dtype=None,
                 device=None):
        super().__init__(dtype=dtype)
        if device is not None:
            self._build_device = layer_device(device)
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = num_expert * world_size
        self.l_aux = None
        #: the expert group whose ranks hold slabs of the tokens
        self.group = None

    def capacity(self, num_tokens: int, capacity_factor: float) -> int:
        return max(int(np.ceil(capacity_factor * num_tokens
                               / self.tot_expert)), 1)

    def forward(self, *inputs, **kwargs):
        """``(indices, probs)`` of the tokens ``inputs[0]`` (N, d); over
        Tensors through the dispatcher (the indices stop gradients),
        ``l_aux`` as the input's kind."""
        inp = inputs[0]
        if isinstance(inp, Tensor):
            def fn(v, *_):
                idx, val, aux = self._gate(v)
                return idx, val, aux
            idx, val, aux = apply(fn, inp, *self.parameters(),
                                  op_name=type(self).__name__)
            idx.stop_gradient = True
            self.l_aux = aux
            return idx, val
        idx, val, self.l_aux = self._gate(inp)
        return idx, val

    def _gate(self, x):
        raise NotImplementedError


def _gate_probs(gate_w, x):
    """fp32 softmax over the expert logits."""
    return torch.softmax((x @ gate_w).float(), dim=-1)


def _aux_loss(probs, top1_idx, num_experts: int, group=None):
    """GShard/Switch load balance: ``E · Σ_e mean(P_e) · frac_top1_e``;
    the fractions are index data. Over a group: this rank's mean
    probabilities against the global fractions (module docstring)."""
    counts = moe_ops._one_hot(top1_idx, num_experts,
                              torch.float32).sum(dim=0)
    n = top1_idx.shape[0]
    if group is not None:
        from .....distributed import collective as C
        counts = C._raw_all_reduce(counts, group)
        n = n * group.nranks
    ce = counts / n
    return (probs.mean(dim=0) * ce).sum() * float(num_experts)


class NaiveGate(BaseGate):
    """Plain linear top-k gate: no capacity, no auxiliary loss."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, *, dtype=None, device=None):
        super().__init__(num_expert, world_size, dtype=dtype, device=device)
        self.topk = topk
        self.gate = self.create_parameter((d_model, self.tot_expert))

    def _gate(self, x):
        probs = _gate_probs(self.gate, x)
        topv, topi = moe_ops._top_k(probs, self.topk)
        return topi.to(torch.int32), topv, probs.new_zeros(())


class GShardGate(BaseGate):
    """Top-2 gate with capacity, random routing of the second expert and
    the auxiliary loss (the reference's ``gshard_gate.py``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4),
                 random_routing: bool = True, group=None, *, dtype=None,
                 device=None):
        super().__init__(num_expert, world_size, dtype=dtype, device=device)
        assert topk == 2, "GShard gate is top-2"
        self.topk = 2
        self.capacity_factor = capacity
        self.random_routing = random_routing
        self.gate = self.create_parameter((d_model, self.tot_expert))

    def _gate(self, x):
        g = live_group(self.group)
        n = x.shape[0]
        n_all = _n_global(g, n)
        probs = _gate_probs(self.gate, x)
        topv, topi = moe_ops._top_k(probs, 2)
        idx = topi.to(torch.int32)
        aux = _aux_loss(probs, idx[:, 0], self.tot_expert, g)
        if self.random_routing and self.training:
            prob = _random.uniform_draw(_random.next_key(), (n_all,),
                                        device=x.device)[_rows(g, n)]
            idx = moe_ops.random_routing(idx, topv.detach(), prob)
        factor = self.capacity_factor
        if isinstance(factor, (tuple, list)):
            factor = factor[0] if self.training else factor[1]
        cap = self.capacity(n_all, factor)
        # joint capacity pruning in the GShard order, over the global set
        glob = _gather_idx(idx, g)
        routes = moe_ops.dispatch_indices_topk(glob, self.tot_expert, cap)
        rows = _rows(g, n)
        idx = torch.stack([torch.where(routes[k][1][rows], idx[:, k],
                                       torch.full_like(idx[:, k], -1))
                           for k in range(2)], dim=1)
        return idx, topv, aux


class SwitchGate(BaseGate):
    """Top-1 gate with capacity and the auxiliary loss (the reference's
    ``switch_gate.py``); in training the logits are multiplied by a
    U[1 − eps, 1 + eps] jitter."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1,
                 capacity=(1.2, 2.4), group=None, *, dtype=None,
                 device=None):
        super().__init__(num_expert, world_size, dtype=dtype, device=device)
        assert topk == 1, "Switch gate is top-1"
        self.topk = 1
        self.switch_eps = switch_eps
        self.capacity_factor = capacity
        self.gate = self.create_parameter((d_model, self.tot_expert))

    def _gate(self, x):
        g = live_group(self.group)
        n = x.shape[0]
        n_all = _n_global(g, n)
        logits = x @ self.gate
        if self.training:
            noise = _random.uniform_draw(
                _random.next_key(), (n_all, logits.shape[-1]),
                1.0 - self.switch_eps, 1.0 + self.switch_eps,
                device=x.device)[_rows(g, n)]
            logits = logits * noise.to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1)
        topv, topi = moe_ops._top_k(probs, 1)
        idx = topi[:, 0].to(torch.int32)
        aux = _aux_loss(probs, idx, self.tot_expert, g)
        factor = self.capacity_factor
        if isinstance(factor, (tuple, list)):
            factor = factor[0] if self.training else factor[1]
        cap = self.capacity(n_all, factor)
        glob = _gather_idx(idx, g)
        counts = moe_ops.number_count(glob, self.tot_expert)
        pruned = moe_ops.prune_gate_by_capacity(
            glob, torch.clamp(counts, max=cap), self.tot_expert)
        return pruned[_rows(g, n)][:, None], topv, aux
