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

``named_sharding``, ``serving_mesh`` and ``shrink_serving_mesh`` place
arrays on devices of one controller; they come with the later
distributed slices and raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops._common import not_ported

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


def named_sharding(*spec):
    raise not_ported("named_sharding (arrays placed over a device mesh)",
                     "Distributed II")


def serving_mesh(num_chips: int, devices: Optional[Sequence] = None):
    raise not_ported("serving_mesh (tensor-parallel serving replicas)",
                     "Distributed III")


def surviving_mp_degree(num_chips_left: int, num_kv_heads: int) -> int:
    """Largest TP degree usable after chip loss: it must divide
    ``num_kv_heads`` and fit the surviving chip count."""
    for d in range(min(max(num_chips_left, 1), num_kv_heads), 0, -1):
        if num_kv_heads % d == 0:
            return d
    return 1


def shrink_serving_mesh(mesh, dead_chip: int, num_kv_heads: int):
    raise not_ported("shrink_serving_mesh (elastic serving resize)",
                     "Distributed III")
