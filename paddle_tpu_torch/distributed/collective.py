"""Collective communication — counterpart of
``paddle_tpu/distributed/collective.py``.

The reference runs one controller: a ``Group`` is a mesh axis and a
collective is a compiled ``shard_map`` program over global arrays,
whose dim-0 shard *i* is device *i*'s tensor. Here a rank is a process
(``torch.distributed``: gloo for CPU tensors, NCCL for CUDA tensors)
and each rank holds its own tensor. The correspondence, which the
parity tests hold both packages to:

* ``all_reduce``: every rank's tensor becomes the reduction (the
  reference's every shard); in place, as Paddle's is;
* ``all_gather(x)``: every rank gets the concatenation of the ranks'
  tensors on dim 0 (the reference's global ``x``); the list form fills
  the list with each rank's tensor;
* ``reduce_scatter(r)``: every rank passes ``r`` and gets slab *i* of
  the reduction on dim 0;
* ``alltoall(x)``: ``all_to_all_single`` on each rank's slab;
* ``broadcast``: a real broadcast from ``src`` (the reference's is the
  identity, its global arrays being consistent already);
* ``reduce`` and ``gather`` keep the reference's result: every rank gets
  the reduction, every rank's list is filled (code written against the
  reference runs unchanged);
* ``scatter``: rank *i* gets ``tensor_list[i]`` from ``src``;
* the object collectives are ``torch.distributed``'s, with the
  reference's lists out.

Without an initialised process group there is one rank and each
collective is the identity on it (as the reference's at one device).
With one (``init_parallel_env``), every call goes through
``torch.distributed``, at world size 1 too.

The collectives of the reference's compiled hybrid step (``lax.psum``,
``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute`` inside
``shard_map``) are the functions of the last section: each works on
this rank's torch tensor over a mesh axis (a ``Group``, an axis name of
the global mesh, or a tuple of names, major to minor) and carries an
autograd rule (``torch.autograd.Function``):

=====================  ================================================
forward                backward
=====================  ================================================
all_gather_grad        reduce-scatter (sum)
reduce_scatter_grad    all-gather
all_to_all_grad        the inverse all-to-all
ppermute               the inverse permutation
copy_to_group          all-reduce (Megatron's identity entering a
                       tensor-parallel region)
reduce_from_group      identity (Megatron's all-reduce leaving it);
                       ``psum`` is this pair's all-reduce
scatter_to_group       all-gather
gather_from_group      this rank's slice
=====================  ================================================

JAX transposes ``psum`` as ``psum``; the port's gradients follow
Megatron instead: a loss that every rank of a group computes alike is
one objective, and each rank's backward gives the gradient of its own
tensors. Over a one-rank axis (or without a process group) every one of
them returns its input itself: no copy, no autograd node.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.tensor import Tensor
from ..parallel import mesh as _mesh


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    import torch.distributed as dist
    table = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
             "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
             "avg": dist.ReduceOp.AVG}
    if op not in table:
        raise ValueError(f"unsupported reduce op {op}")
    return table[op]


class Group:
    """A communication group: the world ranks ``ranks`` of one mesh
    axis (``axis``) with their ``torch.distributed`` process group
    (``pg``: None when the group has one rank or no process group is
    initialised). ``rank`` is this process's index in the group."""

    def __init__(self, axis: str, mesh=None, ranks: Optional[List[int]] = None,
                 *, pg=None):
        self.axis = axis
        self.mesh = mesh
        self._ranks = list(ranks) if ranks is not None else None
        self.pg = pg

    @property
    def ranks(self) -> List[int]:
        if self._ranks is not None:
            return self._ranks
        return list(range(_mesh.world_size()))

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        me = _mesh.world_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def get_group_rank(self, rank):
        """The group rank of world rank ``rank`` (-1 outside it)."""
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(axis={self.axis!r}, nranks={self.nranks})"


_WORLD: List[Optional[Group]] = [None]


def _world_group() -> Group:
    m = _mesh.ensure_mesh()
    if _WORLD[0] is None or _WORLD[0].mesh is not m:
        _WORLD[0] = m.group("dp")  # rebuilt whenever the global mesh changes
    return _WORLD[0]


def get_group(group: Optional[Group]) -> Group:
    return group if group is not None else _world_group()


def new_group(ranks=None, backend=None, axis: Optional[str] = None,
              timeout=None) -> Group:
    """A group over the world ranks ``ranks`` (collective: every rank
    calls it, members or not), or this process's group along the
    global mesh's ``axis``; the world group when neither is given."""
    if ranks is None:
        return _mesh.ensure_mesh().group(axis or "dp")
    ranks = sorted(int(r) for r in ranks)
    dist = _mesh._dist()
    pg = None
    if dist is not None and len(ranks) == dist.get_world_size():
        pg = dist.group.WORLD
    elif dist is not None and len(ranks) > 1:
        pg = dist.new_group(ranks)
    return Group(axis or "dp", _mesh.get_global_mesh(), ranks, pg=pg)


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _like(ref, value):
    """``value`` as the kind of object ``ref`` is (a Tensor or a torch
    tensor)."""
    return Tensor._wrap(value, True) if isinstance(ref, Tensor) else value


def _communicates(g: Group) -> bool:
    """Whether a call on ``g`` goes through ``torch.distributed``: a
    process group is initialised and ``g`` has more than one rank or is
    the world."""
    dist = _mesh._dist()
    return dist is not None and (g.pg is not None or g.nranks > 1)


def _pg(g: Group):
    import torch.distributed as dist
    return g.pg if g.pg is not None else dist.group.WORLD


def _set(tensor, value):
    """Write ``value`` into ``tensor`` in place (Paddle's in-place
    collectives); returns ``tensor``."""
    with torch.no_grad():
        _unwrap(tensor).detach().copy_(value)
    return tensor


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True):
    """Every rank's ``tensor`` becomes the reduction over the group, in
    place."""
    g = get_group(group)
    if op not in ("sum", "max", "min", "avg", "prod"):
        raise ValueError(f"unsupported reduce op {op}")
    if not _communicates(g):
        return tensor
    import torch.distributed as dist
    with torch.no_grad():
        dist.all_reduce(_unwrap(tensor).detach(), op=_torch_op(op),
                        group=_pg(g))
    return tensor


def all_reduce_replicated(value, op=ReduceOp.SUM,
                          group: Optional[Group] = None):
    """The reduction of every rank's copy of ``value`` (``nranks *
    value`` for a sum of identical copies), as a new tensor: flat fused
    gradient buffers reduce this way, without a slab view."""
    g = get_group(group)
    v = _unwrap(value)
    if not _communicates(g):
        return v
    out = v.detach().clone()
    all_reduce(out, op=op, group=g)
    return out


def all_gather(tensor_list, tensor=None, group: Optional[Group] = None,
               sync_op=True):
    """Two calling conventions (Paddle's): ``all_gather(list, tensor)``
    fills ``list`` with every rank's tensor; ``all_gather(tensor,
    group=g)`` returns the ranks' tensors concatenated on dim 0."""
    g = get_group(group)
    tiled = tensor is None or isinstance(tensor_list, (Tensor, torch.Tensor))
    src = (tensor_list if isinstance(tensor_list, (Tensor, torch.Tensor))
           else tensor) if tiled else tensor
    v = _unwrap(src).detach()
    if _communicates(g):
        import torch.distributed as dist
        parts = [torch.empty_like(v) for _ in range(g.nranks)]
        dist.all_gather(parts, v.contiguous(), group=_pg(g))
    else:
        parts = [v.clone()]
    if tiled:
        return _like(src, torch.cat(parts, 0))
    tensor_list.clear()
    tensor_list.extend(_like(src, p) for p in parts)
    return tensor_list


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op=True):
    """The reference's form (``tensor_list`` None): every rank passes the
    same-shaped ``tensor`` and gets slab ``rank`` (on dim 0) of the
    reduction, as a new tensor. Paddle's form: ``tensor_list`` holds
    this rank's inputs, one per rank, and ``tensor`` receives the
    reduction of every rank's entry ``rank``, in place."""
    g = get_group(group)
    if tensor_list is not None:
        inputs = [_unwrap(t).detach().contiguous() for t in tensor_list]
        if not _communicates(g):
            return _set(tensor, inputs[0])
        import torch.distributed as dist
        out = torch.empty_like(inputs[0])
        dist.reduce_scatter(out, inputs, op=_torch_op(op), group=_pg(g))
        return _set(tensor, out)
    v = _unwrap(tensor).detach()
    if not _communicates(g):
        return tensor if isinstance(tensor, Tensor) else v
    n = g.nranks
    if v.shape[0] % n:
        raise ValueError(f"dim 0 ({v.shape[0]}) does not split over "
                         f"{n} ranks")
    import torch.distributed as dist
    out = torch.empty((v.shape[0] // n,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    dist.reduce_scatter(out, [c.contiguous() for c in v.chunk(n, 0)],
                        op=_torch_op(op), group=_pg(g))
    return _like(tensor, out)


def broadcast(tensor, src=0, group: Optional[Group] = None, sync_op=True):
    """``tensor`` on every rank becomes rank ``src``'s (a world rank), in
    place."""
    g = get_group(group)
    if not _communicates(g):
        return tensor
    import torch.distributed as dist
    with torch.no_grad():
        dist.broadcast(_unwrap(tensor).detach(), src=int(src), group=_pg(g))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group: Optional[Group] = None,
           sync_op=True):
    """The reference's result: every rank (not only ``dst``) gets the
    reduction."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank *i* of the group receives ``tensor_list[i]`` from world rank
    ``src`` into ``tensor`` (in place); ``tensor_list`` is read on
    ``src`` only. At one rank the result is ``tensor_list[0]``."""
    g = get_group(group)
    if not _communicates(g):
        if tensor_list:
            return _set(tensor, _unwrap(tensor_list[0]))
        return tensor
    import torch.distributed as dist
    v = _unwrap(tensor).detach()
    out = torch.empty_like(v)
    inputs = None
    if _mesh.world_rank() == int(src):
        inputs = [_unwrap(t).detach().contiguous() for t in tensor_list]
    dist.scatter(out, inputs, src=int(src), group=_pg(g))
    return _set(tensor, out)


def alltoall(out_tensor_list, in_tensor_list=None, group: Optional[Group] = None,
             sync_op=True):
    """``alltoall(x)``: ``x``'s dim 0 splits into one chunk per rank;
    chunk *j* goes to rank *j*, and the chunks received come back
    concatenated in rank order (a new tensor)."""
    g = get_group(group)
    if isinstance(out_tensor_list, (Tensor, torch.Tensor)):
        v = _unwrap(out_tensor_list).detach().contiguous()
        if not _communicates(g):
            return _like(out_tensor_list, v.clone())
        import torch.distributed as dist
        out = torch.empty_like(v)
        dist.all_to_all_single(out, v, group=_pg(g))
        return _like(out_tensor_list, out)
    raise NotImplementedError("list-form alltoall: pass a stacked Tensor")


def all_to_all(*args, **kwargs):
    return alltoall(*args, **kwargs)


def send(tensor, dst=0, group=None, sync_op=True):
    from .communication.p2p import send as _send
    return _send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    from .communication.p2p import recv as _recv
    return _recv(tensor, src=src, group=group, sync_op=sync_op)


def barrier(group=None):
    g = get_group(group)
    if _communicates(g):
        import torch.distributed as dist
        dist.barrier(group=_pg(g))


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return _mesh.world_size()


def get_rank(group: Optional[Group] = None) -> int:
    """This process's rank in ``group``, its world rank without one."""
    if group is not None:
        return group.rank
    return _mesh.world_rank()


def gather(tensor, gather_list=None, dst=0, group: Optional[Group] = None,
           sync_op=True):
    """The reference's result: every rank's ``gather_list`` is filled
    with every rank's tensor (an all-gather), whatever ``dst``."""
    if gather_list is None:
        gather_list = []
    all_gather(gather_list, tensor, group=group, sync_op=sync_op)
    return gather_list


def wait(tensor, group=None, use_calc_stream=True):
    """Block until ``tensor``'s pending work on its card is done."""
    v = _unwrap(tensor)
    if isinstance(v, torch.Tensor) and v.is_cuda:
        torch.cuda.current_stream(v.device).synchronize()
    return tensor


def get_backend(group: Optional[Group] = None) -> str:
    """``"NCCL"`` or ``"GLOO"``: the process group's backend, or the one
    ``init_parallel_env`` would pick (NCCL where there is a card)."""
    dist = _mesh._dist()
    if dist is not None:
        pg = group.pg if group is not None and group.pg is not None else None
        return str(dist.get_backend(pg)).upper()
    return "NCCL" if torch.cuda.is_available() else "GLOO"


def destroy_process_group(group: Optional[Group] = None):
    """Destroying the world group (or passing none) tears down the
    process group, the global mesh and the env's init flag; a subgroup
    is only dropped (the reference keeps no state per group)."""
    if group is None or group is _WORLD[0]:
        dist = _mesh._dist()
        if dist is not None:
            dist.destroy_process_group()
        _WORLD[0] = None
        _mesh.set_global_mesh(None)
        from . import env as _env
        _env._initialized[0] = False


def _object_group(group):
    g = get_group(group)
    return (_pg(g) if _communicates(g) else None), g


def all_gather_object(object_list, obj, group: Optional[Group] = None):
    """Every rank's picklable ``obj``, in rank order."""
    pg, g = _object_group(group)
    if pg is None:
        object_list[:] = [obj]
        return object_list
    import torch.distributed as dist
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=pg)
    object_list[:] = out
    return object_list


def broadcast_object_list(object_list, src=0, group: Optional[Group] = None):
    """Rank ``src``'s list of objects on every rank, in place."""
    pg, _ = _object_group(group)
    if pg is None:
        return object_list
    import torch.distributed as dist
    dist.broadcast_object_list(object_list, src=int(src), group=pg)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group: Optional[Group] = None):
    """Each rank receives its entry of rank ``src``'s
    ``in_object_list``."""
    pg, g = _object_group(group)
    if pg is None:
        out_object_list[:] = [in_object_list[0] if in_object_list else None]
        return out_object_list
    import torch.distributed as dist
    out = [None]
    dist.scatter_object_list(
        out, in_object_list if _mesh.world_rank() == int(src) else None,
        src=int(src), group=pg)
    out_object_list[:] = out
    return out_object_list


# ---------------------------------------------------------------------------
# collectives with gradients (the reference's lax collectives inside its
# compiled hybrid step), over this rank's tensor
# ---------------------------------------------------------------------------
def axis_groups(axis) -> List[Group]:
    """The groups ``axis`` names, major to minor: a ``Group``, an axis
    name of the global mesh, or a tuple / list of either; ``None`` is
    no group."""
    if axis is None:
        return []
    if isinstance(axis, Group):
        return [axis]
    if isinstance(axis, str):
        return [_mesh.ensure_mesh().group(axis)]
    out: List[Group] = []
    for a in axis:
        out += axis_groups(a)
    return out


def _live(groups) -> List[Group]:
    """The groups that communicate: more than one rank, and a process
    group initialised."""
    return [g for g in groups if g.nranks > 1 and _communicates(g)]


def _raw_all_gather(x, g: Group, dim: int):
    import torch.distributed as dist
    xc = x.contiguous()
    parts = [torch.empty_like(xc) for _ in range(g.nranks)]
    dist.all_gather(parts, xc, group=_pg(g))
    return torch.cat(parts, dim)


def _raw_reduce_scatter(x, g: Group, dim: int):
    import torch.distributed as dist
    n = g.nranks
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split over "
                         f"{n} ranks")
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=_pg(g))
    return out


def _raw_all_reduce(x, g: Group, op: str = "sum"):
    import torch.distributed as dist
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_torch_op(op), group=_pg(g))
    return out


def _raw_all_to_all(x, g: Group, split_dim: int, concat_dim: int):
    import torch.distributed as dist
    n = g.nranks
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} ({x.shape[split_dim]}) does not "
                         f"split over {n} ranks")
    inp = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=_pg(g))
    return torch.cat(out.unbind(0), concat_dim)


def _slice_of(x, g: Group, dim: int):
    n = g.nranks
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split over "
                         f"{n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, g.rank * size, size).contiguous()


#: the tag of the next ``ppermute`` exchange: every rank calls the
#: collectives of one program in the same order, so their counters agree
_P2P_TAG = [0]


def _raw_ppermute(x, g: Group, perm):
    """Rank ``src`` of ``g`` sends ``x`` to rank ``dst`` for each pair;
    a rank nobody sends to gets zeros (``lax.ppermute``). Sends are
    posted before receives, under one tag per call."""
    import torch.distributed as dist
    me = g.rank
    tag = _P2P_TAG[0] = (_P2P_TAG[0] + 1) % (1 << 30)
    xc = x.contiguous()
    out = torch.zeros_like(xc)
    pg = g.pg
    ops = [dist.P2POp(dist.isend, xc, g.ranks[dst], pg, tag)
           for src, dst in perm if src == me]
    ops += [dist.P2POp(dist.irecv, out, g.ranks[src], pg, tag)
            for src, dst in perm if dst == me]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _raw_all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _raw_reduce_scatter(gy, ctx.g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _raw_reduce_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _raw_all_gather(gy, ctx.g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_dim, concat_dim):
        ctx.g, ctx.dims = g, (split_dim, concat_dim)
        return _raw_all_to_all(x, g, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, gy):
        split_dim, concat_dim = ctx.dims
        return (_raw_all_to_all(gy, ctx.g, concat_dim, split_dim), None,
                None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, perm):
        ctx.g, ctx.perm = g, perm
        return _raw_ppermute(x, g, perm)

    @staticmethod
    def backward(ctx, gy):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _raw_ppermute(gy, ctx.g, inverse), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _raw_all_reduce(gy, ctx.g), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, op):
        return _raw_all_reduce(x, g, op)

    @staticmethod
    def backward(ctx, gy):
        return gy, None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _slice_of(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _raw_all_gather(gy, ctx.g, ctx.dim), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _raw_all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _slice_of(gy, ctx.g, ctx.dim), None, None


def _keep(ref, value):
    """``value`` as the kind of object ``ref`` is, its gradient kept."""
    if isinstance(ref, Tensor):
        return Tensor._wrap(value, not value.requires_grad)
    return value


def _over(x, fn):
    """``fn`` on ``x``'s torch tensor, the result as the kind of object
    ``x`` is (a Tensor keeps its gradient)."""
    v = _unwrap(x)
    out = fn(v)
    return x if out is v else _keep(x, out)


def all_gather_grad(x, axis, dim: int = 0):
    """The ranks' tensors concatenated on ``dim`` in rank order (the
    reference's ``lax.all_gather(..., tiled=True)``); over a tuple of
    axes the index is major-to-minor, as a ``PartitionSpec`` entry
    lays a dim out. Backward: reduce-scatter."""
    def run(v):
        for g in reversed(_live(axis_groups(axis))):
            v = _AllGather.apply(v, g, dim)
        return v
    return _over(x, run)


def reduce_scatter_grad(x, axis, dim: int = 0):
    """Slab ``rank`` (on ``dim``) of the sum over the ranks
    (``lax.psum_scatter(..., tiled=True)``). Backward: all-gather."""
    def run(v):
        for g in _live(axis_groups(axis)):
            v = _ReduceScatter.apply(v, g, dim)
        return v
    return _over(x, run)


def all_to_all_grad(x, axis, split_dim: int, concat_dim: int):
    """``split_dim`` cut into one chunk per rank, chunk *j* sent to rank
    *j*, the received chunks concatenated on ``concat_dim`` in rank
    order (``lax.all_to_all(..., tiled=True)``). Backward: the inverse
    all-to-all."""
    def run(v):
        for g in _live(axis_groups(axis)):
            v = _AllToAll.apply(v, g, split_dim, concat_dim)
        return v
    return _over(x, run)


def copy_to_group(x, axis):
    """Identity forward, all-reduce backward: where a tensor that every
    rank of the group holds alike enters computations split over it."""
    def run(v):
        for g in _live(axis_groups(axis)):
            v = _CopyToGroup.apply(v, g)
        return v
    return _over(x, run)


def reduce_from_group(x, axis, op: str = "sum"):
    """All-reduce forward, identity backward: where partial results
    leave a split computation (Megatron's ``mp_allreduce``)."""
    def run(v):
        for g in _live(axis_groups(axis)):
            v = _ReduceFromGroup.apply(v, g, op)
        return v
    return _over(x, run)


def scatter_to_group(x, axis, dim: int = 0):
    """This rank's slice of ``dim``; backward: all-gather."""
    def run(v):
        for g in _live(axis_groups(axis)):
            v = _ScatterToGroup.apply(v, g, dim)
        return v
    return _over(x, run)


def gather_from_group(x, axis, dim: int = 0):
    """All-gather on ``dim``; backward: this rank's slice."""
    def run(v):
        for g in reversed(_live(axis_groups(axis))):
            v = _GatherFromGroup.apply(v, g, dim)
        return v
    return _over(x, run)


def psum(x, axis):
    """The sum over the ranks of ``axis`` (``lax.psum``), with
    Megatron's gradient: identity (:func:`reduce_from_group`)."""
    return reduce_from_group(x, axis)


def pmax(x, axis):
    """The elementwise maximum over the ranks of ``axis``, without a
    gradient (``lax.pmax``)."""
    def run(v):
        for g in _live(axis_groups(axis)):
            v = _raw_all_reduce(v.detach(), g, "max")
        return v
    return _over(x, run)


def ppermute(x, axis, perm):
    """``lax.ppermute``: for each ``(src, dst)`` of ``perm`` (group
    ranks), rank ``dst`` receives rank ``src``'s tensor; a rank that
    nobody sends to gets zeros. Backward: the inverse permutation."""
    groups = axis_groups(axis)
    if len(groups) != 1:
        raise ValueError("ppermute runs over one mesh axis")
    g = groups[0]
    perm = [(int(s), int(d)) for s, d in perm]
    if not _live(groups):
        # one rank: it keeps its tensor only if the permutation maps it
        # to itself
        return x if (0, 0) in perm else _over(x, torch.zeros_like)
    return _over(x, lambda v: _PPermute.apply(v, g, perm))
