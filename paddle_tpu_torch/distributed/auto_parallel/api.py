"""Auto-parallel (semi-automatic SPMD) API — counterpart of
``paddle_tpu/distributed/auto_parallel/api.py`` (``ProcessMesh``,
``shard_tensor``, the placements, ``reshard``, ``shard_layer``,
``Strategy``).

The reference's ``ProcessMesh`` wraps a ``jax.sharding.Mesh`` over the
devices of its one controller, and ``shard_tensor`` places the global
array over it. Here a rank is a process, as everywhere in the port's
distributed package: a :class:`ProcessMesh` lays its process ids (ranks)
out on named dims over a ``parallel.mesh.Mesh``, and a distributed
tensor is THIS rank's slab of the global tensor. Every rank passes the
global tensor, as the hybrid step's ranks do; the slab is tagged with
``parallel.mesh.mark_slab``, so a sharded checkpoint writes it at its
offset. :func:`reshard` moves slabs by collectives over the mesh's
groups: a dim the source splits is all-gathered, a dim the target
splits is cut. Building a ProcessMesh in a job with a process group is
collective (the mesh makes its subgroups). A mesh may name more ranks
than the job has: each rank still takes its slab, but a gather over the
missing ranks raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...core.tensor import Tensor
from ...parallel import mesh as _mesh


class Placement:
    pass


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Partial(Placement):
    """Pending-reduction placement. As in the reference, the API treats
    it as Replicate: no slab here holds a partial value."""

    def __repr__(self):
        return "Partial()"


class ProcessMesh:
    """``paddle.distributed.ProcessMesh``: ranks on named dims. ``shape``,
    ``process_ids``, ``dim_names`` and ``mesh`` (the flat process ids) as
    in the reference; :meth:`rank_mesh` is the ``parallel.mesh.Mesh``
    the slabs are cut over (the reference's ``jax_mesh``)."""

    def __init__(self, mesh: Sequence, dim_names: Optional[List[str]] = None,
                 process_ids=None):
        arr = np.asarray(mesh)
        self.shape = list(arr.shape)
        self.process_ids = arr.flatten().tolist()
        self.dim_names = dim_names or [f"d{i}" for i in range(arr.ndim)]
        dist = _mesh._dist()
        if dist is not None and max(self.process_ids) >= _mesh.world_size():
            raise ValueError(f"{self!r} names a rank outside this job of "
                             f"{_mesh.world_size()} ranks")
        self._rank_mesh = _mesh.Mesh(arr, tuple(self.dim_names))

    @property
    def mesh(self):
        return self.process_ids

    def rank_mesh(self) -> "_mesh.Mesh":
        return self._rank_mesh

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self.shape == other.shape
                and self.process_ids == other.process_ids)

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


def _placements_to_spec(placements, ndim: int, mesh: ProcessMesh):
    dims = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            name = mesh.dim_names[mesh_dim]
            if dims[pl.dim] is None:
                dims[pl.dim] = name
            elif isinstance(dims[pl.dim], tuple):
                dims[pl.dim] = dims[pl.dim] + (name,)
            else:
                dims[pl.dim] = (dims[pl.dim], name)
    return _mesh.PartitionSpec(*dims)


def _distributed(value, spec, mesh: ProcessMesh, stop_gradient: bool,
                 name=None) -> Tensor:
    """This rank's slab of the global ``value`` under ``spec``, as a
    tagged distributed Tensor."""
    sh = _mesh.SlabSharding(mesh.rank_mesh(), spec)
    out = Tensor(sh.shard(value), stop_gradient=stop_gradient, name=name)
    _mesh.mark_slab(out._value, _mesh.SlabInfo.of(sh, tuple(value.shape)))
    out._value._process_mesh = mesh
    out._sharding_spec = spec
    out.is_distributed = True
    return out


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 stop_gradient=True) -> Tensor:
    """This rank's slab of the global tensor ``data`` under
    ``placements`` over ``mesh`` (the reference's ``shard_tensor``; its
    ``dtype`` is unused there too). A rank outside the mesh gets
    ``data`` back, as the reference without the mesh's devices."""
    t = data if isinstance(data, Tensor) else Tensor(data)
    if _mesh.world_rank() not in mesh.process_ids:
        return t
    spec = _placements_to_spec(placements, t._value.ndim, mesh)
    return _distributed(t._value.detach(), spec, mesh, stop_gradient, t.name)


def _global(tensor: Tensor):
    """The global tensor of a distributed Tensor (an all-gather over the
    dims its spec splits: collective), or the tensor itself."""
    v = tensor._value.detach()
    spec = tensor._sharding_spec
    src = getattr(tensor._value, "_process_mesh", None)
    if spec is None or src is None or not spec.used_axes():
        return v
    if max(src.process_ids) >= _mesh.world_size():
        raise ValueError(f"gathering over {src!r} needs all its ranks; "
                         f"this job has {_mesh.world_size()}")
    return _mesh.SlabSharding(src.rank_mesh(), spec).gather(v)


def reshard(tensor: Tensor, mesh: ProcessMesh, placements) -> Tensor:
    """``tensor`` under new ``placements`` over ``mesh``: the dims it is
    split on are all-gathered over the source mesh's groups (Shard ->
    Replicate), then this rank's slab of the target is cut (Replicate
    -> Shard). Collective where it gathers: every rank calls it."""
    if _mesh.world_rank() not in mesh.process_ids:
        return tensor
    full = _global(tensor)
    spec = _placements_to_spec(placements, full.ndim, mesh)
    return _distributed(full, spec, mesh, tensor.stop_gradient)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs) -> Tensor:
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def _place_param(p, sharded: Tensor) -> None:
    """Put a distributed Tensor's slab into the layer parameter ``p`` in
    place of its value (the reference's ``p._value = ...``): the torch
    leaf the optimizer holds stays the same object."""
    import torch
    with torch.no_grad():
        p.data = sharded._value.detach().to(p.dtype)
    for a in ("_slab", "_process_mesh"):
        if hasattr(sharded._value, a):
            setattr(p, a, getattr(sharded._value, a))
    p._sharding_spec = sharded._sharding_spec


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Shard a Layer's parameters over ``process_mesh`` in place
    (reference api.py::shard_layer). ``shard_fn(sublayer_name, sublayer,
    process_mesh)`` places each sublayer's parameters itself; the
    default replicates every parameter. ``input_fn``/``output_fn`` are
    registered as forward pre/post hooks like the reference."""
    from ...nn.layer import Layer

    if not isinstance(layer, Layer):
        raise TypeError(f"expected a Layer, got {type(layer).__name__}")

    def default_shard(name, sub, mesh):
        for _, p in sub.named_parameters(include_sublayers=False):
            sharded = shard_tensor(p.detach(), mesh,
                                   [Replicate()] * max(1, p.ndim))
            if sharded.is_distributed:
                _place_param(p, sharded)

    fn = shard_fn or default_shard
    for name, sub in layer.named_sublayers(include_self=True):
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda lyr, inp, out: output_fn(out, process_mesh))
    return layer


class _StrategyConfig:
    """Attribute bag with defaults (enable=False style, reference
    paddle.distributed.Strategy sub-configs)."""

    def __init__(self, **defaults):
        self.__dict__.update(defaults)


class Strategy:
    """Reference ``paddle.distributed.Strategy``: sub-configs for
    sharding / amp / pipeline / fused passes, read by
    :class:`~.engine.Engine`; advisory, as in the reference."""

    def __init__(self, config=None):
        cfg = dict(config or {})

        def sub(name, **defaults):
            defaults.update(cfg.get(name, {}))
            return _StrategyConfig(**defaults)

        self.sharding = sub("sharding", enable=False, degree=1, stage=1)
        self.amp = sub("amp", enable=False, dtype="float16", level="O1")
        self.pipeline = sub("pipeline", enable=False,
                            schedule_mode="1F1B", micro_batch_size=1,
                            accumulate_steps=1)
        self.fused_passes = sub("fused_passes", enable=False,
                                fused_passes_list=[])

    def __repr__(self):
        parts = []
        for k in ("sharding", "amp", "pipeline", "fused_passes"):
            parts.append(f"{k}={getattr(self, k).__dict__}")
        return f"Strategy({', '.join(parts)})"
