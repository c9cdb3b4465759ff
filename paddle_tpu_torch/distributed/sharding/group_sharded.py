"""Group-sharded (ZeRO) stages — counterpart of
``paddle_tpu/distributed/sharding/group_sharded.py``.

The reference places the optimizer state, gradients and parameters
with ``SlabSharding``s over the ``sharding`` axis and lets XLA move
them. Here each rank of the group holds its slab: a tensor splits on its
first dim divisible by the group size (:func:`shard_spec_for`; one that
has none stays whole on every rank). One update (:func:`sharded_update`):

* every rank's gradient is averaged over the group (each rank's loss is
  its own batch's mean): an all-reduce, or at stage 2 and 3 a
  reduce-scatter that leaves only this rank's slab;
* the optimizer's clip sees the slabs, the global norm summed over the
  group (``HybridParallelClipGrad``);
* the optimizer updates this rank's slab of the parameter with its slab
  of the state (made at the slab's shape);
* the slabs are all-gathered back into the whole parameter, except at
  stage 3, where a parameter stays a slab between steps and the model
  wrapper all-gathers it before its forward.

With one rank in the group every stage is the plain optimizer: the same
operations, bitwise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ...nn.layer import Layer
from ...optimizer.optimizer import _lr_factor, _trainable
from ...parallel import mesh as _mesh
from .. import collective as C
from ..collective import Group

__all__ = [
    "group_sharded_parallel", "save_group_sharded_model",
    "GroupShardedOptimizerStage2", "GroupShardedStage2", "GroupShardedStage3",
    "shard_spec_for",
]


def _sharding_group(group: Optional[Group]) -> Group:
    if group is not None:
        return group
    mesh = _mesh.ensure_mesh()
    # the sharding axis, else dp (a pure-ZeRO run over the whole world)
    return mesh.group("sharding" if mesh.degree("sharding") > 1 else "dp")


def shard_spec_for(shape, axis: str, degree: int):
    """The PartitionSpec that splits the first dim divisible by
    ``degree``; whole (``P()``) if none is."""
    P = _mesh.PartitionSpec
    if degree <= 1:
        return P()
    for i, d in enumerate(shape):
        if d % degree == 0 and d > 0:
            return P(*([None] * i + [axis]))
    return P()


def _live(g: Optional[Group]) -> bool:
    return g is not None and g.nranks > 1 and C._communicates(g)


def slab_view(t: torch.Tensor, dim: Optional[int], g: Group) -> torch.Tensor:
    """This rank's slab of ``t`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    k = t.shape[dim] // g.nranks
    return t.narrow(dim, g.rank * k, k)


def tag_zero_state(opt, name: str, p, d: Optional[int], group: Group):
    """Tag the state of ``p``'s slab on ``d`` (made by the optimizer at
    the slab's shape) with where it sits in the global state, for
    sharded checkpoints."""
    if d is None:
        return
    full = tuple(getattr(p, "_zero_full", None) or p.shape)
    base = _mesh.slab_info(p) or _mesh.SlabInfo.whole(full)
    info = base.split(d, group)
    shape = info.pieces[0][2]
    for v in opt.state.get(name, {}).values():
        if tuple(v.shape) == shape:
            _mesh.mark_slab(v, info)


def sharded_update(opt, group: Group, dim_of, lr, t, *,
                   scatter_grads: bool, keep_sharded=frozenset(),
                   pre_reduced: bool = False) -> None:
    """One update of ``opt`` (a base optimizer) with its state split
    over ``group`` (module docstring). ``dim_of(p)`` is the dim a
    parameter splits on (None: whole); ``lr`` and ``t`` the rate and
    step (host numbers eagerly, device scalars in a compiled program);
    ``keep_sharded`` the ids of parameters that stay slabs (stage 3,
    where ``p`` holds the whole tensor during the step and its slab
    after). ``pre_reduced``: the gradients are already the group's
    average (slabs where ``scatter_grads``)."""
    n = group.nranks
    items = []
    pairs = []
    for name, p in zip(opt._names, opt._parameter_list):
        g = p.grad
        if g is None or not _trainable(p):
            continue
        d = dim_of(p)
        with torch.no_grad():
            if pre_reduced:
                gs = g
            elif d is not None and scatter_grads:
                gs = C._raw_reduce_scatter(g, group, d).div_(n)
            else:
                gs = slab_view(C._raw_all_reduce(g, group).div_(n), d, group)
        if d is not None:
            gs._zero_sliced = True
        pairs.append((name, p, gs, d))
    clip = getattr(opt, "_grad_clip", None)
    if clip is not None and pairs:
        clipped = clip([(p, gs) for _, p, gs, _ in pairs])
        pairs = [(name, p, gc, d) for (name, p, _, d), (_, gc)
                 in zip(pairs, clipped)]
    for name, p, gs, d in pairs:
        if gs is None:
            continue
        wd = opt._weight_decay if opt._decay_enabled(name, p) else 0.0
        f = _lr_factor(p)
        items.append((name, slab_view(p.detach(), d, group), gs,
                      lr if f == 1.0 else lr * f, wd))
    with torch.no_grad():
        opt._apply(items, t)
        for name, p, gs, d in pairs:
            if d is None:
                continue
            tag_zero_state(opt, name, p, d, group)
            if id(p) in keep_sharded:
                p.data = slab_view(p.detach(), d, group).clone()
            else:
                p.detach().copy_(C._raw_all_gather(
                    slab_view(p.detach(), d, group), group, d))


class GroupShardedOptimizerStage2:
    """The optimizer of the ``os`` and ``os_g`` levels (and of
    ``p_g_os`` under its model wrapper): state split over the group by
    :func:`shard_spec_for`, gradients averaged over it (reduce-scattered
    with ``shard_grads``). ``step`` is eager; a compiled ``TrainStep``
    calls ``_sharded_update``."""

    def __init__(self, params, optim, group: Optional[Group] = None,
                 offload: bool = False, shard_grads: bool = True,
                 device: str = "gpu", **kwargs):
        self._optim = optim
        self._group = _sharding_group(group)
        self._offload = offload
        self._shard_grads = shard_grads
        self._params = list(params)
        self._axis = self._group.axis
        self._degree = self._group.nranks
        names = {id(p): n for n, p in zip(optim._names,
                                          optim._parameter_list)}
        self.param2rank = _greedy_partition(
            [(names.get(id(p), str(i)), p)
             for i, p in enumerate(self._params)], self._degree)
        self._stage3 = set()

    def _dim(self, p) -> Optional[int]:
        if not _live(self._group):
            return None
        d = getattr(p, "_zero_dim", "unset")
        if d == "unset":
            spec = shard_spec_for(tuple(p.shape), self._axis, self._degree)
            d = next((i for i, e in enumerate(spec) if e is not None), None)
        return d

    # -- delegation --------------------------------------------------------
    def __getattr__(self, item):
        return getattr(self.__dict__["_optim"], item)

    @property
    def inner_opt(self):
        return self._optim

    def _state_of(self, name, p):
        """The state of ``p``'s slab (made at the slab's shape; a
        stage-3 parameter is its slab between steps)."""
        held = p.detach()
        d = self._dim(p)
        if getattr(p, "_zero_full", None) != tuple(p.shape):
            held = slab_view(held, d, self._group)
        s = self._optim._state_of(name, held)
        tag_zero_state(self._optim, name, p, d, self._group)
        return s

    def _sharded_update(self, lr, t) -> None:
        if not _live(self._group):
            from ...jit import compiled_update
            return compiled_update(self._optim, lr, t)
        from ...jit import keep_slots
        held = {n: dict(s) for n, s in self._optim.state.items()}
        sharded_update(self._optim, self._group, self._dim, lr, t,
                       scatter_grads=self._shard_grads,
                       keep_sharded=self._stage3)
        keep_slots(self._optim, held)

    @torch.no_grad()
    def step(self):
        if not _live(self._group):
            return self._optim.step()
        opt = self._optim
        opt._step_count += 1
        sharded_update(opt, self._group, self._dim, opt.get_lr(),
                       opt._step_count, scatter_grads=self._shard_grads,
                       keep_sharded=self._stage3)

    def clear_grad(self, *a, **k):
        self._optim.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._optim.state_dict()

    def set_state_dict(self, sd):
        return self._optim.set_state_dict(sd)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()


class _ShardedModelWrapper(Layer):
    """A model wrapper: the wrapped layer is its only sublayer."""

    def __init__(self, layer):
        super().__init__()
        self._layers = layer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, item):
        try:
            return super().__getattr__(item)
        except AttributeError:
            return getattr(self._modules["_layers"], item)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


class GroupShardedStage2(_ShardedModelWrapper):
    """Gradient and optimizer-state sharding (ZeRO-2); the wrapped
    optimizer does the sharding at its update."""

    def __init__(self, layer, sharding_optimizer, group: Optional[Group] = None,
                 sync_buffers: bool = False, buffer_max_size: int = 2 ** 23,
                 auto_refresh_trainable: bool = True, device: str = "gpu",
                 dp_group: Optional[Group] = None, **kwargs):
        super().__init__(layer)
        self._sharding_optimizers = (
            sharding_optimizer if isinstance(sharding_optimizer, (list, tuple))
            else [sharding_optimizer])
        self._group = _sharding_group(group)

    def get_all_parameters(self):
        """Stage 2 keeps every parameter whole."""
        return self._layers.parameters()


class GroupShardedStage3(_ShardedModelWrapper):
    """Parameter, gradient and optimizer-state sharding (ZeRO-3): each
    trainable parameter that splits is this rank's slab between steps
    (``_sharding_spec`` says on which dim); the forward all-gathers the
    whole parameters first, and the optimizer's update leaves slabs."""

    def __init__(self, layer, optimizer=None, group: Optional[Group] = None,
                 sync_buffers: bool = False, device: str = "gpu",
                 segment_size: int = 2 ** 20, pertrain_sync_models: bool = True,
                 offload: bool = False, sync_comm: bool = False,
                 dp_group: Optional[Group] = None, exclude_layer=None, **kw):
        super().__init__(layer)
        self._group = g = _sharding_group(group)
        self._optimizer = optimizer
        self._sharded: List[tuple] = []
        for p in layer.parameters():
            if not _trainable(p):
                continue
            if getattr(p, "_sharding_spec", None) is not None and tuple(
                    p._sharding_spec):
                continue            # tensor-parallel slabs keep their spec
            spec = shard_spec_for(tuple(p.shape), g.axis, g.nranks)
            d = next((i for i, e in enumerate(spec) if e is not None), None)
            if d is None:
                continue
            p._sharding_spec = spec
            p._zero_dim = d
            p._zero_full = tuple(p.shape)
            if _live(g):
                p.data = slab_view(p.detach(), d, g).clone()
            self._sharded.append((p, d))

    def _gather_params(self) -> None:
        g = self._group
        if not _live(g):
            return
        with torch.no_grad():
            for p, d in self._sharded:
                if tuple(p.shape) != p._zero_full:
                    p.data = C._raw_all_gather(p.detach(), g, d)

    def forward(self, *args, **kwargs):
        self._gather_params()
        return self._layers(*args, **kwargs)

    def get_all_parameters(self, convert2cpu: bool = False):
        """Every sharded parameter gathered back whole, its spec
        cleared (the reference's all-gather for saving)."""
        self._gather_params()
        for p, _ in self._sharded:
            p._sharding_spec = None
            del p._zero_dim, p._zero_full
            if isinstance(self._optimizer, GroupShardedOptimizerStage2):
                self._optimizer._stage3.discard(id(p))
        self._sharded = []
        return self._layers.parameters()


def _greedy_partition(named_params, degree: int) -> Dict[str, int]:
    """Size-balanced rank assignment (the reference's Stage-2 param2rank
    map): largest first onto the lightest rank."""
    sizes = [0] * max(degree, 1)
    mapping = {}
    for name, p in sorted(named_params,
                          key=lambda q: -int(np.prod(tuple(q[1].shape)
                                                     or (1,)))):
        r = int(np.argmin(sizes))
        mapping[name] = r
        sizes[r] += int(np.prod(tuple(p.shape) or (1,)))
    return mapping


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group: Optional[Group] = None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20, sync_comm: bool = False,
                           dp_group: Optional[Group] = None,
                           exclude_layer=None):
    """``paddle.distributed.sharding.group_sharded_parallel``: level
    ``"os"`` (stage 1), ``"os_g"`` (stage 2) or ``"p_g_os"`` (stage 3).
    Returns ``(model, optimizer, scaler)``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be one of 'os', 'os_g', 'p_g_os'")
    g = _sharding_group(group)
    params = list(model.parameters())
    if level in ("os", "os_g"):
        optimizer = GroupShardedOptimizerStage2(
            params, optimizer, group=g, offload=offload,
            shard_grads=(level == "os_g"))
        model = GroupShardedStage2(model, optimizer, group=g,
                                   sync_buffers=sync_buffers,
                                   buffer_max_size=buffer_max_size,
                                   dp_group=dp_group)
    else:
        model = GroupShardedStage3(model, optimizer=None, group=g,
                                   sync_buffers=sync_buffers,
                                   segment_size=segment_size, offload=offload,
                                   sync_comm=sync_comm, dp_group=dp_group,
                                   exclude_layer=exclude_layer)
        optimizer = GroupShardedOptimizerStage2(
            params, optimizer, group=g, offload=offload, shard_grads=True)
        optimizer._stage3 = {id(p) for p, _ in model._sharded}
        model._optimizer = optimizer
    return model, optimizer, scaler


def save_group_sharded_model(model, output: str, optimizer=None):
    """Gather the whole parameters and save the layer's (and the
    optimizer's) state under the directory ``output``: ``model.pdmodel``
    and ``opt.pdopt``, written by the group's first rank."""
    from ...framework import io_save
    if os.path.splitext(output)[1]:
        raise ValueError("save_group_sharded_model expects a directory path")
    target, group = model, None
    while isinstance(target, _ShardedModelWrapper):
        if isinstance(target, GroupShardedStage3):
            target.get_all_parameters()
        group = getattr(target, "_group", group)
        target = target._layers
    if group is None or group.rank <= 0:
        os.makedirs(output, exist_ok=True)
        io_save.save(target.state_dict(), os.path.join(output,
                                                       "model.pdmodel"))
        if optimizer is not None:
            io_save.save(optimizer.state_dict(),
                         os.path.join(output, "opt.pdopt"))
