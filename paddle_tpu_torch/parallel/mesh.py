"""The process mesh — counterpart of ``paddle_tpu/parallel/mesh.py``.

The reference's mesh is one ``jax.sharding.Mesh`` over the devices of a
single controller, with the hybrid axes ``("dp", "pp", "sharding",
"sep", "mp")``. Here a rank is a process: a :class:`Mesh` lays the
world's ranks out over the same axes in the reference's order (rank
``r`` sits at ``np.unravel_index(r, shape)``, as
``CommunicateTopology`` places it), and holds one ``torch.distributed``
subgroup for every group of ranks that differ only along one axis.

``new_group`` is collective: every rank creates every subgroup, in the
same order (axis by axis in the mesh's order, each axis's groups sorted
by their first rank). A group that spans the whole world is the default
process group (at world size 1 too); any other one-rank group needs no
communicator. Without an initialised process group (one process,
``init_parallel_env`` not called) every group has one rank and the
collectives are identities.

``named_sharding(*spec)`` describes which slab of a global tensor this
rank holds under a ``PartitionSpec`` (the reference places the global
array over the devices; here each rank keeps its slab): rank ``r``'s
slab is the reference's device ``r`` shard. :func:`shard_slab` cuts a
global tensor to this rank's slab and :func:`gather_slab` puts the
ranks' slabs back together (collective).

A serving mesh is another thing: :func:`serving_mesh` gives a
:class:`ServingMesh`, the devices of ONE process on the one ``mp`` axis
(the reference's serving replica is one controller over its devices,
and so is the port's). A tensor-parallel engine over it holds every
chip's weight and pool slabs and runs each chip's share of a layer;
:func:`serving_all_reduce` sums the row-parallel partials. The chips may
share a device (logical chips, named by the caller: one card holds
them all) or each have their own card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


HYBRID_ORDER = ("dp", "pp", "sharding", "sep", "mp")

_global_mesh: List[Optional["Mesh"]] = [None]


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Ranks of the initialised process group, else the launcher's
    ``PADDLE_TRAINERS_NUM`` (1 without it)."""
    dist = _dist()
    if dist is not None:
        return dist.get_world_size()
    from ..distributed import env
    return env.get_world_size()


def world_rank() -> int:
    dist = _dist()
    if dist is not None:
        return dist.get_rank()
    from ..distributed import env
    return env.get_rank()


class Mesh:
    """Ranks on named axes. ``devices`` is the rank grid (an int array of
    ``shape``'s degrees), ``axis_names`` the axes, ``shape`` the
    ``{axis: degree}`` map, as a ``jax.sharding.Mesh`` has them
    (``axis_types`` is accepted and changes nothing). :meth:`group`
    gives this process's group along an axis. Building one is
    collective."""

    def __init__(self, devices, axis_names: Sequence[str], axis_types=None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._groups: Dict[str, object] = {}
        self._build_groups()

    def comm_lists(self, axis: str) -> List[List[int]]:
        """Every group along ``axis``: the ranks that differ only in
        this coordinate, sorted by their first rank."""
        i = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, i, -1).reshape(-1,
                                                         self.devices.shape[i])
        return sorted(sorted(int(r) for r in row) for row in moved)

    def _build_groups(self) -> None:
        from ..distributed.collective import Group
        dist = _dist()
        me = world_rank()
        world = world_size()
        for axis in self.axis_names:
            mine = None
            for ranks in self.comm_lists(axis):
                if dist is None:
                    pg = None
                elif len(ranks) == world:
                    pg = dist.group.WORLD
                elif len(ranks) == 1:
                    pg = None
                else:
                    pg = dist.new_group(ranks)   # collective, same order
                if me in ranks:
                    mine = Group(axis, self, ranks, pg=pg)
            self._groups[axis] = mine

    def group(self, axis: str):
        """This process's group along ``axis``."""
        return self._groups[axis]

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: index}`` of world rank ``rank`` (this process's by
        default) on the mesh."""
        r = world_rank() if rank is None else int(rank)
        where = np.argwhere(self.devices == r)
        if not len(where):
            raise ValueError(f"rank {r} is not on {self!r}")
        return {a: int(i) for a, i in zip(self.axis_names, where[0])}

    def degree(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(degrees: Dict[str, int], devices: Optional[Sequence] = None,
               order: Optional[Sequence[str]] = None) -> Mesh:
    """A mesh over the world's ranks (or ``devices``, a list of ranks)
    with the hybrid axis order. Missing axes get degree 1; when ``dp``
    is 1 and the degrees divide the rank count, the rest folds into
    ``dp``. ``order`` changes the placement order; the axis names stay
    the same. Collective: every rank calls it with the same arguments."""
    ranks = list(devices if devices is not None else range(world_size()))
    n = len(ranks)
    axis_order = tuple(order) if order else HYBRID_ORDER
    if set(axis_order) != set(HYBRID_ORDER):
        missing = set(HYBRID_ORDER) - set(axis_order)
        axis_order = tuple(axis_order) + tuple(sorted(missing))
    degs = {ax: int(degrees.get(ax, 1)) for ax in axis_order}
    known = int(np.prod([d for d in degs.values()]))
    if degs["dp"] == 1 and n % known == 0 and n // known > 1:
        degs["dp"] = n // known
        known = n
    if known != n:
        raise ValueError(
            f"product of parallel degrees {degs} = {known} != #devices {n}")
    shape = tuple(degs[ax] for ax in axis_order)
    return Mesh(np.asarray(ranks).reshape(shape), axis_order)


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    _global_mesh[0] = mesh


def get_global_mesh() -> Optional[Mesh]:
    return _global_mesh[0]


def ensure_mesh(degrees: Optional[Dict[str, int]] = None) -> Mesh:
    if _global_mesh[0] is None:
        set_global_mesh(build_mesh(degrees or {}))
    return _global_mesh[0]


def axis_degree(axis: str) -> int:
    m = get_global_mesh()
    if m is None or axis not in m.shape:
        return 1
    return m.shape[axis]


def current_axis_names() -> Tuple[str, ...]:
    m = get_global_mesh()
    return tuple(m.axis_names) if m is not None else ()


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dim of a
    tensor, each None (whole), a mesh axis name, or a tuple of names
    (the dim split over their product, major to minor). Missing
    trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The axes dim ``dim`` is split over, major to minor."""
        if dim >= len(self) or self[dim] is None:
            return ()
        e = self[dim]
        return tuple(e) if isinstance(e, (tuple, list)) else (e,)

    def used_axes(self) -> set:
        return {a for d in range(len(self)) for a in self.axes(d)}



class SlabSharding:
    """A ``PartitionSpec`` over a :class:`Mesh`: which slab of a global
    tensor each rank holds (the placement of the reference's
    ``jax.sharding.NamedSharding``, read rank by rank)."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*tuple(spec or ()))

    def __repr__(self):
        return f"SlabSharding({self.mesh!r}, {self.spec!r})"

    def num_parts(self, dim: int) -> int:
        return int(np.prod([self.mesh.degree(a)
                            for a in self.spec.axes(dim)] or [1]))

    def part(self, dim: int, rank: Optional[int] = None) -> int:
        """The index of ``rank``'s slab along ``dim``."""
        c = self.mesh.coords(rank)
        idx = 0
        for a in self.spec.axes(dim):
            idx = idx * self.mesh.degree(a) + c[a]
        return idx

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        out = []
        for d, n in enumerate(global_shape):
            k = self.num_parts(d)
            if n % k:
                raise ValueError(f"dim {d} ({n}) of {tuple(global_shape)} "
                                 f"does not split over {self.spec.axes(d)} "
                                 f"({k} ranks)")
            out.append(n // k)
        return tuple(out)

    def index(self, global_shape, rank: Optional[int] = None):
        """``rank``'s slab as a tuple of slices of the global shape (the
        reference's shard ``index``)."""
        local = self.shard_shape(global_shape)
        return tuple(slice(self.part(d, rank) * n, (self.part(d, rank) + 1)
                           * n) for d, n in enumerate(local))

    def replica_id(self, rank: Optional[int] = None) -> int:
        """0 for the first copy of a slab: the rank whose coordinates on
        every axis the spec does not split are 0."""
        c = self.mesh.coords(rank)
        used = self.spec.used_axes()
        rid = 0
        for a in self.mesh.axis_names:
            if a not in used:
                rid = rid * self.mesh.degree(a) + c[a]
        return rid

    def shard(self, x):
        """This rank's slab of the global tensor ``x`` (a contiguous
        copy)."""
        return x[self.index(tuple(x.shape))].contiguous().clone()

    def gather(self, local):
        """The global tensor from every rank's slab ``local``: an
        all-gather over each split axis (collective over the mesh)."""
        import torch
        from ..distributed import collective as C
        out = local
        with torch.no_grad():
            for d in range(len(self.spec)):
                axes = self.spec.axes(d)
                if axes:
                    out = C.all_gather_grad(
                        out, [self.mesh.group(a) for a in axes], d)
        return out


def named_sharding(*spec) -> Optional[SlabSharding]:
    """``SlabSharding(global mesh, PartitionSpec(*spec))``, None
    without a global mesh (the reference's contract)."""
    m = get_global_mesh()
    if m is None:
        return None
    return SlabSharding(m, PartitionSpec(*spec))


def _sharding(spec, mesh) -> SlabSharding:
    if isinstance(spec, SlabSharding):
        return spec
    m = mesh if mesh is not None else ensure_mesh()
    return SlabSharding(m, spec if isinstance(spec, PartitionSpec)
                         else PartitionSpec(*tuple(spec or ())))


def shard_slab(x, spec, mesh: Optional[Mesh] = None):
    """This rank's slab of the global tensor ``x`` under ``spec`` (a
    ``PartitionSpec``, a tuple of entries or a ``SlabSharding``)."""
    return _sharding(spec, mesh).shard(x)


def gather_slab(local, spec, mesh: Optional[Mesh] = None):
    """The global tensor whose slabs the ranks hold under ``spec``
    (collective: every rank calls it)."""
    return _sharding(spec, mesh).gather(local)


class SlabInfo:
    """Where a rank's tensor sits in its global tensor, for sharded
    checkpoints: ``global_shape``, and ``pieces``, a list of
    ``(local slices, global offset, shape)`` (one piece for a plain
    slab; one per layer block when the storage order is permuted), and
    whether this rank writes it (``replica_id == 0``)."""

    def __init__(self, global_shape, pieces, writes: bool = True,
                 axes=()):
        self.global_shape = tuple(int(n) for n in global_shape)
        self.pieces = [(tuple(sl), tuple(int(o) for o in off),
                        tuple(int(n) for n in shape))
                       for sl, off, shape in pieces]
        self.writes = bool(writes)
        self.axes = tuple(axes)

    @classmethod
    def of(cls, sharding: SlabSharding, global_shape):
        idx = sharding.index(global_shape)
        shape = tuple(s.stop - s.start for s in idx)
        whole = tuple(slice(0, n) for n in shape)
        return cls(global_shape, [(whole, tuple(s.start for s in idx),
                                   shape)], sharding.replica_id() == 0,
                   tuple(sorted(sharding.spec.used_axes())))

    def split(self, dim: int, group) -> "SlabInfo":
        """The info of this rank's slab of a one-piece slab split again
        on ``dim`` over ``group`` (a ZeRO split of an mp slab's state);
        written by the ranks at 0 on every mesh axis neither split
        uses."""
        (_, off, shape), = self.pieces
        k = shape[dim] // group.nranks
        off = list(off)
        off[dim] += group.rank * k
        shape = list(shape)
        shape[dim] = k
        axes = set(self.axes) | {group.axis}
        writes = True
        if group.mesh is not None:
            writes = all(v == 0 for a, v in group.mesh.coords().items()
                         if a not in axes)
        return SlabInfo(self.global_shape,
                        [(tuple(slice(0, n) for n in shape), off, shape)],
                        writes, tuple(sorted(axes)))

    @classmethod
    def whole(cls, shape) -> "SlabInfo":
        shape = tuple(int(n) for n in shape)
        return cls(shape, [(tuple(slice(0, n) for n in shape),
                            (0,) * len(shape), shape)])


def mark_slab(t, info: SlabInfo):
    """Tag the tensor ``t`` (this rank's slab) with ``info``; returns
    ``t``. Checkpoint save and load read the tag."""
    t._slab = info
    return t


def slab_info(t) -> Optional[SlabInfo]:
    v = getattr(t, "_value", t)
    return getattr(v, "_slab", None)


class ServingMesh:
    """A serving replica's tensor-parallel mesh: devices of this process
    on the one ``mp`` axis. ``devices`` is the device array, ``shape``
    ``{"mp": n}`` and ``axis_names`` ``("mp",)``, as a
    ``jax.sharding.Mesh`` has them. ``chips`` names each chip by its
    index in the device list the first mesh was built from, so a chip
    keeps its name after :func:`shrink_serving_mesh` drops another one
    (two logical chips on one device differ only by it)."""

    def __init__(self, devices: Sequence, chips: Optional[Sequence[int]]
                 = None, axis_name: str = "mp"):
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("a serving mesh needs a device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a serving mesh's devices are all CPU or all "
                             f"CUDA, got {devs}")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.chips = tuple(range(len(devs)) if chips is None
                           else (int(c) for c in chips))
        self.axis_names = (axis_name,)
        self.shape = {axis_name: len(devs)}

    @property
    def shared(self) -> bool:
        """Whether every chip lies on one device (logical chips)."""
        return len(set(self.devices.tolist())) == 1

    def __repr__(self):
        return f"ServingMesh({self.shape}, {self.devices.tolist()})"


def _device(d):
    """``torch.device(d)`` with a CUDA device's index made explicit (a
    tensor's ``.device`` carries it, ``torch.device("cuda")`` does
    not)."""
    import torch
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def serving_mesh(num_chips: int, devices: Optional[Sequence] = None
                 ) -> ServingMesh:
    """A serving replica's TP mesh (l.92): ``num_chips`` devices on the
    ``mp`` axis. ``devices=None`` means the visible CUDA devices (none
    raises); a list names them, and a device it repeats holds that many
    logical chips (one card standing in for a mesh). More chips than
    devices raises, as in the reference."""
    if devices is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices="
                               "[torch.device('cpu')] * n for CPU chips")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if num_chips < 1 or num_chips > len(devs):
        raise ValueError(
            f"serving mesh needs 1..{len(devs)} chips, got {num_chips}")
    return ServingMesh(devs[:num_chips])


def surviving_mp_degree(num_chips_left: int, num_kv_heads: int) -> int:
    """Largest TP degree usable after chip loss: it must divide
    ``num_kv_heads`` and fit the surviving chip count."""
    for d in range(min(max(num_chips_left, 1), num_kv_heads), 0, -1):
        if num_kv_heads % d == 0:
            return d
    return 1


def shrink_serving_mesh(mesh: ServingMesh, dead_chip: int,
                        num_kv_heads: int) -> ServingMesh:
    """The surviving serving mesh after ``dead_chip`` (an index into the
    mesh's flat device order) is lost (l.117): drop that chip and
    rebuild at the largest head-divisible degree the survivors support.
    An out-of-range index raises."""
    devs = mesh.devices.reshape(-1).tolist()
    if not 0 <= int(dead_chip) < len(devs):
        raise ValueError(
            f"dead chip index {dead_chip} outside the mesh's "
            f"{len(devs)} devices")
    keep = [i for i in range(len(devs)) if i != int(dead_chip)]
    if not keep:
        raise ValueError("mesh has no surviving devices")
    keep = keep[:surviving_mp_degree(len(keep), num_kv_heads)]
    return ServingMesh([devs[i] for i in keep],
                       [mesh.chips[i] for i in keep], mesh.axis_names[0])


def serving_all_reduce(partials: Sequence) -> List:
    """The row-parallel all-reduce of a serving mesh: ``partials`` holds
    one fp32 tensor a chip, in chip order; returns the sum as each chip
    holds it. Chips that share a device: one tensor, the partials added
    in chip order (``((p0 + p1) + p2) + ...``), given to every chip.
    Chips on distinct cards: ``torch.cuda.nccl.all_reduce`` from this
    one process, in place (NCCL's ring order). Other layouts raise."""
    devs = [p.device for p in partials]
    if len(set(devs)) == 1:
        acc = partials[0]
        for p in partials[1:]:
            acc = acc + p
        return [acc] * len(partials)
    if len(set(devs)) != len(devs) or devs[0].type != "cuda":
        raise ValueError(f"a serving mesh's chips share one device or each "
                         f"have their own card, got {devs}")
    import torch.cuda.nccl as nccl
    nccl.all_reduce(list(partials))
    return list(partials)
