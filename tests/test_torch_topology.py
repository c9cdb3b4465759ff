"""The topology, the process mesh and the RNG tracker of
``paddle_tpu_torch.distributed`` against ``paddle_tpu.distributed`` in
one process: the rank grid and its groups, the mesh's rank layout
against the reference's device layout, the hybrid group's degrees, and
the tracker's draws bit for bit. The multi-rank behaviour (this
process's coordinate, subgroups) is in ``test_torch_collective.py``.
"""

import jax
import numpy as np
import pytest

import paddle_tpu as rpaddle
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.distributed.meta_parallel import random_state as rrs
from paddle_tpu.parallel import mesh as rmesh

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.distributed import topology as ttopo
from paddle_tpu_torch.distributed.meta_parallel import random_state as trs
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

DIMS = [[1, 1, 1, 1, 1], [2, 2, 2, 1, 1], [2, 1, 2, 1, 2], [1, 4, 1, 1, 2],
        [3, 1, 1, 2, 1]]


@pytest.fixture(autouse=True)
def reset():
    prev = tplace._current_place[0]
    tpaddle.set_device("cpu")
    for m in (rmesh, tmesh):
        m.set_global_mesh(None)
    for t in (rtopo, ttopo):
        t.set_hybrid_communicate_group(None)
    yield
    for m in (rmesh, tmesh):
        m.set_global_mesh(None)
    for t in (rtopo, ttopo):
        t.set_hybrid_communicate_group(None)
    tplace._current_place[0] = prev


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_rank_grid_bijection_and_groups(dims):
    r = rtopo.CommunicateTopology(dims=dims)
    t = ttopo.CommunicateTopology(dims=dims)
    assert t.world_size() == r.world_size()
    for rank in range(r.world_size()):
        assert t.get_coord(rank) == r.get_coord(rank)
        kw = dict(zip(r.get_hybrid_group_names(), r.get_coord(rank)))
        assert t.get_rank(**kw) == r.get_rank(**kw) == rank
        assert (t.get_rank_from_stage(rank, pp=0)
                == r.get_rank_from_stage(rank, pp=0))
    for ax in r.get_hybrid_group_names():
        assert t.get_dim(ax) == r.get_dim(ax)
        assert t.get_comm_list(ax) == r.get_comm_list(ax)
        for i in range(r.get_dim(ax)):
            assert t.get_axis_list(ax, i) == r.get_axis_list(ax, i)


@pytest.mark.parametrize("dims", DIMS[1:3], ids=str)
def test_mesh_comm_lists_are_the_topologys(dims):
    n = int(np.prod(dims))
    deg = dict(zip(tmesh.HYBRID_ORDER, dims))
    m = tmesh.build_mesh(deg, devices=list(range(n)))
    topo = ttopo.CommunicateTopology(dims=dims)
    for ax in tmesh.HYBRID_ORDER:
        assert m.comm_lists(ax) == topo.get_comm_list(ax)


@pytest.mark.parametrize("degrees,order", [
    ({"dp": 2, "mp": 4}, None), ({}, None), ({"pp": 2, "mp": 2}, None),
    ({"dp": 2, "mp": 2, "pp": 2}, ["mp", "dp", "pp", "sharding", "sep"]),
    ({"sharding": 4}, ["sharding", "dp"])], ids=str)
def test_mesh_layout_matches_the_reference(degrees, order):
    """The port lays ranks 0..7 out as the reference lays out the
    conftest's 8 CPU devices (by id)."""
    r = rmesh.build_mesh(degrees, devices=jax.devices()[:8], order=order)
    t = tmesh.build_mesh(degrees, devices=list(range(8)), order=order)
    assert t.axis_names == tuple(r.axis_names)
    assert t.shape == dict(r.shape)
    ids = np.vectorize(lambda d: d.id)(r.devices)
    np.testing.assert_array_equal(t.devices, ids)


def test_mesh_degrees_must_fit_the_world():
    for m in (rmesh, tmesh):
        devs = jax.devices()[:8] if m is rmesh else list(range(8))
        with pytest.raises(ValueError, match="#devices"):
            m.build_mesh({"dp": 3}, devices=devs)


def test_global_mesh_queries_at_one_process():
    assert tmesh.get_global_mesh() is None
    assert tmesh.axis_degree("mp") == 1 and tmesh.current_axis_names() == ()
    m = tmesh.ensure_mesh()
    assert tmesh.get_global_mesh() is m and m.shape["dp"] == 1
    assert tmesh.current_axis_names() == tmesh.HYBRID_ORDER
    g = m.group("dp")
    assert (g.ranks, g.rank, g.nranks, g.pg) == ([0], 0, 1, None)
    # named_sharding describes this rank's slab (here, the whole tensor)
    ns = tmesh.named_sharding("dp", None)
    assert tuple(ns.spec) == ("dp", None) and ns.mesh is m
    assert ns.index((4, 3)) == (slice(0, 4), slice(0, 3))
    assert ns.replica_id() == 0
    # a serving mesh is this process's devices on one mp axis, apart
    # from the rank mesh; without a card, devices=None raises
    import torch
    sm = tmesh.serving_mesh(2, [torch.device("cpu")] * 2)
    assert sm.shape == {"mp": 2} and sm.shared
    small = tmesh.shrink_serving_mesh(sm, 0, 4)
    assert small.shape == {"mp": 1} and small.chips == (1,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.serving_mesh(2)
    assert tmesh.surviving_mp_degree(3, 4) == rmesh.surviving_mp_degree(3, 4)


def test_hybrid_group_degrees_and_ranks():
    """``test_distributed.py``'s topology case through the classes: a
    2x2x2 topology over more ranks than this job has keeps the degrees
    and the bijection, and this process is rank 0 in both packages."""
    dims = [2, 2, 1, 1, 2]          # dp 2, pp 2, mp 2
    r = rtopo.HybridCommunicateGroup(rtopo.CommunicateTopology(dims=dims))
    t = ttopo.HybridCommunicateGroup(ttopo.CommunicateTopology(dims=dims))
    for q in ("get_data_parallel_world_size", "get_model_parallel_world_size",
              "get_pipe_parallel_world_size",
              "get_sharding_parallel_world_size",
              "get_sep_parallel_world_size", "get_data_parallel_rank",
              "get_model_parallel_rank", "get_stage_id",
              "get_sharding_parallel_rank", "get_sep_parallel_rank",
              "is_first_stage", "get_data_parallel_group_src_rank",
              "get_model_parallel_group_src_rank", "get_p2p_groups"):
        assert getattr(t, q)() == getattr(r, q)(), q
    topo = t.topology()
    assert topo.world_size() == 8 and topo.get_coord(0) == (0, 0, 0, 0, 0)
    groups = topo.get_comm_list("mp")
    assert len(groups) == 4 and all(len(g) == 2 for g in groups)
    # a pp degree of 2: rank 0 is the first stage, not the last (the
    # reference's one controller is both)
    assert t.is_last_stage() is False and r.is_last_stage() is True
    ttopo.set_hybrid_communicate_group(t)
    assert ttopo.get_hybrid_communicate_group() is t


def _draws(pkg, rs, script):
    """Run ``script`` (a list of state names; None is the ambient
    stream) and return the draws of each step."""
    pkg.seed(7)
    rs.model_parallel_random_seed(1234)
    tr = rs.get_rng_state_tracker()
    tr.add("local_seed", 99)
    out = []
    for name in script:
        if name is None:
            out.append(np.asarray(pkg.rand([8])._value))
            continue
        with tr.rng_state(name):
            out.append(np.asarray(pkg.rand([8])._value))
            out.append(np.asarray(pkg.randint(0, 1000, [5])._value))
    return out, tr


SCRIPT = ["model_parallel_rng", "model_parallel_rng", None, "local_seed",
          "lazily_seeded", "model_parallel_rng", None]


def test_tracker_draws_are_the_references_bit_for_bit():
    want, rtr = _draws(rpaddle, rrs, SCRIPT)
    got, ttr = _draws(tpaddle, trs, SCRIPT)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"draw {i}")
    assert ttr.get_states_tracker()[1] == rtr.get_states_tracker()[1]
    assert ttr.seeds == rtr.seeds


def test_tracker_states_round_trip_and_refuse_duplicates():
    tr = trs.RNGStatesTracker()
    tr.add("a", 1)
    with pytest.raises(ValueError, match="seed 1 already exists"):
        tr.add("b", 1)
    with pytest.raises(ValueError, match="state a already exists"):
        tr.add("a", 2)
    saved = tr.get_states_tracker()
    with tr.rng_state("a"):
        first = tpaddle.rand([4]).numpy()
    tr.set_states_tracker(saved)
    with tr.rng_state("a"):
        again = tpaddle.rand([4]).numpy()
    np.testing.assert_array_equal(first, again)
    tr.reset()
    assert tr.states == {} and tr.seeds == set()
