"""Hybrid-parallel topology — counterpart of
``paddle_tpu/distributed/topology.py``.

``CommunicateTopology`` is the reference's rank grid: rank ``r`` sits at
``np.unravel_index(r, dims)`` over the axes ``["dp", "pp", "sharding",
"sep", "mp"]``. ``HybridCommunicateGroup`` builds the process mesh of
those degrees over the world's ranks (``parallel.mesh``, one
``torch.distributed`` subgroup per axis group) and answers for THIS
process: its ranks are its own coordinate (the reference's single
controller answers 0 for every axis), its groups the subgroups it
belongs to, and it is the first/last pipeline stage only where its pp
coordinate says so.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..parallel import mesh as _mesh
from .collective import Group


class CommunicateTopology:
    def __init__(self, hybrid_group_names: List[str] = None,
                 dims: List[int] = None):
        self._parallel_names = hybrid_group_names or list(_mesh.HYBRID_ORDER)
        self._dims = dims or [1] * len(self._parallel_names)
        self._world_size = int(np.prod(self._dims))
        shape = tuple(self._dims)
        self._coord_of_rank = {}
        for rank in range(self._world_size):
            self._coord_of_rank[rank] = np.unravel_index(rank, shape)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return int(np.ravel_multi_index(coord, tuple(self._dims)))

    def get_coord(self, rank: int):
        return tuple(int(c) for c in self._coord_of_rank[rank])

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._coord_of_rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """All groups along the axis: lists of world ranks that differ only in
        this coordinate."""
        axis = self._parallel_names.index(axis_name)
        groups: Dict[tuple, List[int]] = {}
        for rank, coord in self._coord_of_rank.items():
            key = tuple(c for i, c in enumerate(coord) if i != axis)
            groups.setdefault(key, []).append(rank)
        return [sorted(v) for _, v in sorted(groups.items())]

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self.get_rank(**dict(zip(self._parallel_names, coord)))


class HybridCommunicateGroup:
    """Axis-group query API of this process (parity with the reference
    class of the same name). Building one is collective: every rank
    builds the same mesh's subgroups."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        self._dp_degree = topology.get_dim("dp")
        self._pp_degree = topology.get_dim("pp")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("mp")
        self.global_rank = _mesh.world_rank()
        degrees = {n: topology.get_dim(n) for n in names}
        want = {ax: degrees.get(ax, 1) for ax in _mesh.HYBRID_ORDER}
        mesh = _mesh.get_global_mesh()
        if mesh is None or dict(mesh.shape) != want:
            try:
                mesh = _mesh.build_mesh(degrees)
                _mesh.set_global_mesh(mesh)
            except ValueError:
                mesh = _mesh.get_global_mesh()
        self.mesh = mesh
        rank = self.global_rank
        self._coord = (dict(zip(names, topology.get_coord(rank)))
                       if rank < topology.world_size() else {})

    def _axis_rank(self, axis: str) -> int:
        return int(self._coord.get(axis, 0))

    def _group(self, axis: str) -> Group:
        if self.mesh is not None and axis in self.mesh.shape:
            g = self.mesh.group(axis)
            if g is not None:
                return g
        return Group(axis, self.mesh, [self.global_rank])

    # degrees -------------------------------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    # this process's coordinate --------------------------------------------
    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self) -> int:
        return self._axis_rank("sep")

    # groups ---------------------------------------------------------------
    def get_data_parallel_group(self) -> Group:
        return self._group("dp")

    def get_model_parallel_group(self) -> Group:
        return self._group("mp")

    def get_pipe_parallel_group(self) -> Group:
        return self._group("pp")

    def get_sharding_parallel_group(self) -> Group:
        return self._group("sharding")

    def get_sep_parallel_group(self) -> Group:
        return self._group("sep")

    def get_check_parallel_group(self, *a, **k) -> Group:
        return self._group("mp")

    def get_data_parallel_group_src_rank(self) -> int:
        return self._group("dp").ranks[0]

    def get_model_parallel_group_src_rank(self) -> int:
        return self._group("mp").ranks[0]

    # pipe helpers ---------------------------------------------------------
    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    def topology(self) -> CommunicateTopology:
        return self._topo


_hcg: List[Optional[HybridCommunicateGroup]] = [None]


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    _hcg[0] = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg[0]
