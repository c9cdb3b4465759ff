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

``psum`` and ``ppermute`` run inside the reference's compiled hybrid
step; they come with the Fleet hybrid-training slice and raise.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.tensor import Tensor
from ..ops._common import not_ported
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


def psum(x, axis: str):
    raise not_ported("psum (a collective inside a compiled hybrid step)",
                     "Distributed II")


def ppermute(x, axis: str, perm):
    raise not_ported("ppermute (a collective inside a compiled hybrid step)",
                     "Distributed II")


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
