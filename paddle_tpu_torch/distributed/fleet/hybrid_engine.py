"""The compiled hybrid-parallel train step — counterpart of
``paddle_tpu/distributed/fleet/hybrid_engine.py`` (``HybridTrainStep``,
l.53-122).

The reference jits one GSPMD program over the global mesh. Here every
rank runs ``jit.TrainStep``'s body (a CUDA graph on the card) on its
slab of the batch and of the weights:

* the batch splits on dim 0 over ``batch_axes`` (``("dp",
  "sharding")`` by default; ``TrainStep(in_shardings=)``);
* mp-split weights (the tensor-parallel layers' slabs) get their
  gradients from the layers' collectives (Megatron), whole ones
  replicated over mp get the same gradient on every mp rank;
* the gradients are averaged over dp, and over ``sharding`` by the ZeRO
  update: stage 1 splits the optimizer state, stage 2 the gradients
  too (a reduce-scatter), stage 3 the parameters too, each tensor on
  dim 0 where ``sharding`` is not used yet and divides it
  (:func:`_spec_with_axis0`); the clip's norm is summed over the
  groups (``HybridParallelClipGrad``).

With one rank on every axis the step is ``TrainStep``'s, bitwise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...jit import TrainStep, compiled_update, keep_slots
from ...parallel import mesh as _mesh
from .. import collective as C
from ..sharding.group_sharded import (_live, sharded_update, slab_view,
                                      tag_zero_state)


def _spec_with_axis0(spec, axis: str, ndim: int, dim0: int, degree: int):
    """``spec`` with ``axis`` added to dim 0 when it is free there and
    divides it (the reference's l.33)."""
    P = _mesh.PartitionSpec
    dims = list(spec) + [None] * (ndim - len(list(spec)))
    used = set()
    for d in dims:
        if d is None:
            continue
        for a in (d if isinstance(d, tuple) else (d,)):
            used.add(a)
    if axis in used or ndim == 0 or degree <= 1 or dim0 % degree != 0:
        return P(*dims) if dims else P()
    if dims[0] is None:
        dims[0] = axis
    elif isinstance(dims[0], tuple):
        dims[0] = tuple(list(dims[0]) + [axis])
    else:
        dims[0] = (dims[0], axis)
    return P(*dims)


class HybridTrainStep(TrainStep):
    """``TrainStep`` over the mesh's groups (module docstring). Used
    directly or through ``fleet.distributed_model(...).
    compile_train_step(...)``."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 zero_stage: int = 1, batch_axes=("dp", "sharding"),
                 donate: bool = True):
        self.mesh = mesh if mesh is not None else _mesh.ensure_mesh()
        self.zero_stage = int(zero_stage)
        self.batch_axes = tuple(ax for ax in batch_axes
                                if self.mesh.degree(ax) > 1)
        self._sharding = self.mesh.group("sharding")
        self._dp = self.mesh.group("dp")
        sh = (_mesh.SlabSharding(self.mesh, _mesh.PartitionSpec(self.batch_axes))
              if self.batch_axes else None)
        self._zero3 = set()
        if self.zero_stage >= 3 and _live(self._sharding):
            for p in model.parameters():
                d = self._zero_dim(p)
                if d is not None and getattr(p, "trainable",
                                             p.requires_grad):
                    self._zero3.add(id(p))
        self._params = list(model.parameters())
        self.optimizer = optimizer
        self._state_slabs()
        super().__init__(model, loss_fn, optimizer, in_shardings=sh,
                         donate=donate)
        if self._zero3:
            # stage 3: the parameters are slabs between steps
            with torch.no_grad():
                for p in self._params:
                    if id(p) in self._zero3:
                        p._zero_full = tuple(p.shape)
                        p.data = slab_view(p.detach(), 0,
                                           self._sharding).clone()

    def _zero_dim(self, p) -> Optional[int]:
        """0 where the ZeRO split applies to ``p`` (``_spec_with_axis0``
        adds ``sharding`` to its dim 0), else None."""
        if self.zero_stage < 1 or not _live(self._sharding) or not p.dim():
            return None
        spec = getattr(p, "_sharding_spec", None) or _mesh.PartitionSpec()
        full = tuple(getattr(p, "_zero_full", None) or p.shape)
        s = _spec_with_axis0(spec, "sharding", len(full), full[0],
                             self._sharding.nranks)
        return 0 if "sharding" in (s[0] if isinstance(s[0], tuple)
                                   else (s[0],)) else None

    def _body(self, batch, key, lr, t):
        if self._zero3:
            with torch.no_grad():
                for p in self._params:
                    if id(p) in self._zero3 and tuple(p.shape) != \
                            p._zero_full:
                        p.data = C._raw_all_gather(p.detach(),
                                                   self._sharding, 0)
        return super()._body(batch, key, lr, t)

    def _batch_groups(self) -> list:
        return [g for g in (self._dp, self._sharding) if _live(g)]

    def _update(self, lr, t) -> None:
        opt = self.optimizer
        if _live(self._dp):
            for p in self._params:
                if p.grad is not None:
                    C.all_reduce(p.grad, op="avg", group=self._dp)
        if not _live(self._sharding):
            return compiled_update(opt, lr, t)
        held = {n: dict(s) for n, s in opt.state.items()}
        sharded_update(opt, self._sharding, self._zero_dim, lr, t,
                       scatter_grads=self.zero_stage >= 2,
                       keep_sharded=self._zero3)
        keep_slots(opt, held)

    def _state_slabs(self):
        """The optimizer state at the ZeRO slabs' shapes."""
        opt = self.optimizer
        ids = {id(p) for p in self._params}
        for name, p in zip(opt._names, opt._parameter_list):
            if id(p) in ids and getattr(p, "trainable", p.requires_grad):
                d = self._zero_dim(p)
                held = p
                if d is not None and tuple(p.shape) == tuple(
                        getattr(p, "_zero_full", p.shape)):
                    held = slab_view(p.detach(), d, self._sharding)
                opt._state_of(name, held)
                tag_zero_state(opt, name, p, d, self._sharding)
