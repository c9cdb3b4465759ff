"""The collective API, point-to-point calls and object collectives of
``paddle_tpu_torch.distributed`` against ``paddle_tpu.distributed``.

The reference runs one controller: its collectives are programs over a
global array whose dim-0 shard *i* is device *i*'s tensor, here on the
conftest's 8-device CPU mesh cut to ``n`` devices. The port runs ``n``
gloo ranks, each a process started by the port's own ``spawn`` (one
job per world size, every scenario in it: a job costs seconds to
start), and each rank holds its slab. Under the correspondence of
``paddle_tpu_torch/distributed/collective.py`` the slabs, concatenated
or compared rank by rank, equal the reference's global results. Inputs
are integer-valued floats: every sum is exact in any order.
"""

import os
import pickle

import jax
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import distributed as rdist
from paddle_tpu.parallel import mesh as rmesh

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn

WORLDS = (2, 4)


def _run_job(n, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"world{n}")
    ctx = spawn(W.collective_scenarios, args=(str(out),), nprocs=n,
                join=False, env={"OMP_NUM_THREADS": "1"})
    try:
        assert ctx.join(timeout=120), f"the {n}-rank job did not finish"
    finally:
        ctx.terminate()
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    return {n: _run_job(n, tmp_path_factory) for n in WORLDS}


@pytest.fixture(autouse=True)
def reset_reference_mesh():
    rmesh.set_global_mesh(None)
    yield
    rmesh.set_global_mesh(None)


def _ref_group(n, degrees=None):
    m = rmesh.build_mesh(degrees or {"dp": n}, devices=jax.devices()[:n])
    rmesh.set_global_mesh(m)
    return rdist.new_group(axis="dp")


def _t(a):
    return paddle.to_tensor(np.asarray(a, np.float32))


def _glob(n, k=2, base=1):
    return np.arange(n * k, dtype=np.float32) + base


def _cat(job, key):
    return np.concatenate([r[key] for r in job])


@pytest.mark.parametrize("n", WORLDS)
def test_job_ranks_and_environment(jobs, n):
    job = jobs[n]
    assert [r["rank"] for r in job] == list(range(n))
    for r in job:
        assert r["world"] == n and r["backend"] == "GLOO"
        assert r["parallel_env"] == (r["rank"], n)
        assert r["coordinator"] == job[0]["coordinator"]
        assert r["after_destroy"] == (False, False)


@pytest.mark.parametrize("n", WORLDS)
def test_spawned_workers_import_neither_jax_nor_the_reference(jobs, n):
    assert all(r["imports"] == [] for r in jobs[n])


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
@pytest.mark.parametrize("n", WORLDS)
def test_all_reduce(jobs, n, op):
    g = _ref_group(n)
    x = _t(_glob(n))
    rdist.all_reduce(x, op=op, group=g)
    got = np.concatenate([r[f"all_reduce_{op}"][0] for r in jobs[n]])
    np.testing.assert_array_equal(got, np.asarray(x.numpy()))
    assert all(r[f"all_reduce_{op}"][1] for r in jobs[n])    # in place


@pytest.mark.parametrize("n", WORLDS)
def test_all_reduce_prod_and_torch_tensors(jobs, n):
    want = np.tile(np.prod(_glob(n).reshape(n, 2), axis=0), n)
    np.testing.assert_array_equal(
        np.concatenate([r["all_reduce_prod"][0] for r in jobs[n]]), want)
    g = _ref_group(n)
    x = _t(_glob(n))
    rdist.all_reduce(x, group=g)
    np.testing.assert_array_equal(_cat(jobs[n], "all_reduce_torch"),
                                  np.asarray(x.numpy()))


@pytest.mark.parametrize("n", WORLDS)
def test_all_gather_tiled_is_the_global_array(jobs, n):
    g = _ref_group(n)
    want = np.asarray(rdist.all_gather(_t(_glob(n)), group=g).numpy())
    for r in jobs[n]:
        np.testing.assert_array_equal(r["all_gather_tiled"], want)


@pytest.mark.parametrize("n", WORLDS)
def test_all_gather_list_form(jobs, n):
    g = _ref_group(n)
    ref = []
    rdist.all_gather(ref, _t(_glob(n)), group=g)
    want = [np.asarray(v.numpy()) for v in ref]
    for r in jobs[n]:
        # each rank's tensor, in rank order: together the global array,
        # which the reference's list holds at every rank
        np.testing.assert_array_equal(np.concatenate(r["all_gather_list"]),
                                      want[r["rank"]])


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter_of_a_replicated_input(jobs, n):
    g = _ref_group(n)
    want = np.asarray(rdist.reduce_scatter(_t(_glob(n)), group=g).numpy())
    np.testing.assert_array_equal(_cat(jobs[n], "reduce_scatter"), want)


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter_list_form(jobs, n):
    mult = sum(range(1, n + 1))
    for r in jobs[n]:
        np.testing.assert_array_equal(r["reduce_scatter_list"],
                                      W.slab(r["rank"]) * mult)


@pytest.mark.parametrize("n", WORLDS)
def test_alltoall(jobs, n):
    g = _ref_group(n)
    x = _t(_glob(n, k=2 * n))
    want = np.asarray(rdist.alltoall(x, group=g).numpy())
    np.testing.assert_array_equal(_cat(jobs[n], "alltoall"), want)
    np.testing.assert_array_equal(_cat(jobs[n], "alltoall_twice"),
                                  np.asarray(x.numpy()))


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast(jobs, n):
    g = _ref_group(n)
    x = _t(_glob(n))
    want = np.asarray(rdist.broadcast(x, src=0, group=g).numpy())
    for r in jobs[n]:
        np.testing.assert_array_equal(r["broadcast_replicated"], want)
        # the port's is a real broadcast: rank n-1's own slab everywhere
        np.testing.assert_array_equal(r["broadcast_from_last"],
                                      W.slab(n - 1))


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_gives_every_rank_the_reduction(jobs, n):
    g = _ref_group(n)
    x = _t(_glob(n))
    rdist.reduce(x, dst=0, group=g)
    np.testing.assert_array_equal(_cat(jobs[n], "reduce"),
                                  np.asarray(x.numpy()))


@pytest.mark.parametrize("n", WORLDS)
def test_gather_fills_every_ranks_list(jobs, n):
    g = _ref_group(n)
    ref = rdist.gather(_t(_glob(n)), dst=0, group=g)
    want = [np.asarray(v.numpy()) for v in ref]
    for r in jobs[n]:
        assert len(r["gather_replicated"]) == len(want) == n
        for a, b in zip(r["gather_replicated"], want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.concatenate(r["gather"]), want[0])


@pytest.mark.parametrize("n", WORLDS)
def test_scatter(jobs, n):
    parts = [_t(W.slab(j, base=100)) for j in range(n)]
    want = np.asarray(rdist.scatter(_t(np.zeros(2)), parts).numpy())
    np.testing.assert_array_equal(_cat(jobs[n], "scatter"), want)


@pytest.mark.parametrize("n", WORLDS)
def test_all_reduce_replicated(jobs, n):
    g = _ref_group(n)
    want = np.asarray(rdist.collective.all_reduce_replicated(
        _t(_glob(n)), group=g))
    np.testing.assert_array_equal(want, n * _glob(n))
    for r in jobs[n]:
        np.testing.assert_array_equal(r["all_reduce_replicated"], want)


@pytest.mark.parametrize("n", WORLDS)
def test_object_collectives(jobs, n):
    want = [{"rank": j, "tag": "x" * j} for j in range(n)]
    for r in jobs[n]:
        assert r["all_gather_object"] == want
        assert r["broadcast_object_list"] == [n - 1, f"from-{n - 1}"]
        assert r["scatter_object_list"] == [{"to": r["rank"]}]


def test_object_collectives_at_one_process_match_the_reference():
    from paddle_tpu_torch import distributed as tdist
    for D in (rdist, tdist):
        objs = []
        D.all_gather_object(objs, {"a": 1})
        assert objs == [{"a": 1}]
        assert D.broadcast_object_list([1, 2]) == [1, 2]
        out = []
        D.scatter_object_list(out, [{"k": 0}])
        assert out == [{"k": 0}]


@pytest.mark.parametrize("n", WORLDS)
def test_new_group_by_ranks(jobs, n):
    for r in jobs[n]:
        x, nranks, grank = r["new_group_ranks"]
        assert nranks == 2
        if r["rank"] < 2:
            assert grank == r["rank"]
            np.testing.assert_array_equal(x, W.slab(0) + W.slab(1))
        else:
            assert grank == -1
            np.testing.assert_array_equal(x, W.slab(r["rank"]))


@pytest.mark.parametrize("n", WORLDS)
def test_new_group_by_mesh_axis(jobs, n):
    """A (dp, mp=2) mesh: the reference reduces the mp shards of a global
    array; each port rank holds the shard of its mp coordinate."""
    _ref_group(n, {"dp": n // 2, "mp": 2})
    g = rdist.new_group(axis="mp")
    x = _t(_glob(2))
    rdist.all_reduce(x, group=g)
    want = np.asarray(x.numpy()).reshape(2, 2)
    topo = rdist.CommunicateTopology(dims=[n // 2, 1, 1, 1, 2])
    for r in jobs[n]:
        got, ranks, grank = r["new_group_axis_mp"]
        coord = topo.get_coord(r["rank"])
        np.testing.assert_array_equal(got, want[coord[-1]])
        assert ranks in topo.get_comm_list("mp") and grank == coord[-1]
        dp_ranks, dp_rank = r["new_group_axis_dp"]
        assert dp_ranks in topo.get_comm_list("dp") and dp_rank == coord[0]


@pytest.mark.parametrize("n", WORLDS)
def test_hybrid_group_is_this_processs_coordinate(jobs, n):
    topo = rdist.CommunicateTopology(dims=[n // 2, 1, 1, 1, 2])
    for r in jobs[n]:
        h = r["hcg"]
        assert h["coord"] == topo.get_coord(r["rank"])
        assert h["mp_group"] in topo.get_comm_list("mp")
        assert h["dp_group"] in topo.get_comm_list("dp")
        assert r["rank"] in h["mp_group"] and r["rank"] in h["dp_group"]
        np.testing.assert_array_equal(
            h["mp_sum"], np.full(2, float(sum(x + 1 for x in h["mp_group"]))))
        assert h["first_last"] == (True, True)
        assert h["dp_src"] == h["dp_group"][0]


@pytest.mark.parametrize("n", WORLDS)
def test_tracker_folds_in_the_mp_coordinate(jobs, n):
    masks = {}
    for r in jobs[n]:
        masks.setdefault(r["hcg"]["coord"][-1], []).append(
            r["tracker_manual_mp"])
    assert len(masks) == 2
    for same in masks.values():          # equal across dp ranks
        for m in same[1:]:
            np.testing.assert_array_equal(m, same[0])
    assert not np.array_equal(masks[0][0], masks[1][0])


@pytest.mark.parametrize("n", WORLDS)
def test_local_sgd_averages_the_ranks_parameters(jobs, n):
    # rank r steps w = r + 1 by -0.5; the mean over ranks is n / 2
    for r in jobs[n]:
        np.testing.assert_array_equal(r["localsgd"], np.full(3, n / 2))


@pytest.mark.parametrize("n", WORLDS)
def test_stream_namespace_delegates(jobs, n):
    g = _ref_group(n)
    x = _t(_glob(n))
    from paddle_tpu.distributed.communication import stream as rstream
    y = rstream.all_reduce(x, group=g, use_calc_stream=True)
    np.testing.assert_array_equal(
        np.concatenate([r["stream_all_reduce"][0] for r in jobs[n]]),
        np.asarray(y.numpy()))
    assert all(r["stream_all_reduce"][1] for r in jobs[n])


@pytest.mark.parametrize("n", WORLDS)
def test_send_recv_between_processes(jobs, n):
    for r in jobs[n]:
        left = (r["rank"] - 1) % n
        np.testing.assert_array_equal(r["send_recv_ring"], W.slab(left))
        got, same, done = r["isend_irecv"]
        np.testing.assert_array_equal(got, W.slab(left) * 3)
        assert same and done


@pytest.mark.parametrize("n", WORLDS)
def test_batch_isend_irecv_receive_listed_first(jobs, n):
    """Each rank lists a receive before its matching send, as the
    reference's ordering test does: the batch completes and delivers."""
    for r in jobs[n]:
        count, waited, ra, rb = r["batch_isend_irecv"]
        left, right = (r["rank"] - 1) % n, (r["rank"] + 1) % n
        assert count == 4 and waited
        np.testing.assert_array_equal(ra, np.full(2, 5.0 + left))
        np.testing.assert_array_equal(rb, np.full(2, 7.0 + right))


@pytest.fixture
def cpu():
    import paddle_tpu_torch as TP
    from paddle_tpu_torch.core import place as tplace
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def test_p2pop_validates_op(cpu):
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.core.tensor import Tensor
    t = Tensor(np.zeros((1,), np.float32))
    with pytest.raises(ValueError):
        tdist.P2POp(tdist.all_reduce, t, peer=0)
    assert isinstance(tdist.P2POp(tdist.isend, t, peer=1).tensor, Tensor)


def test_p2p_without_a_process_group_says_so(cpu):
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.core.tensor import Tensor
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tdist.send(Tensor(np.zeros((1,), np.float32)), dst=0)


def test_spawn_terminates_siblings_of_a_dead_rank(tmp_path):
    ctx = spawn(W.fail_rank_one, args=(str(tmp_path),), nprocs=2,
                join=False)
    try:
        with pytest.raises(RuntimeError, match="exit codes"):
            ctx.join(timeout=60)
        assert not any(p.is_alive() for p in ctx.processes)
    finally:
        ctx.terminate()


def test_in_program_helpers_wait_for_the_hybrid_engine():
    """The in-program collectives run now (their multi-rank forms are
    held by tests/test_torch_pipeline.py and _hybrid_step.py): over a
    one-rank axis each is its input itself (no copy), and a permutation
    that does not map the rank to itself gives zeros, as ``lax``'s."""
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.communication import p2p
    from paddle_tpu_torch.parallel import mesh as tmesh
    tmesh.set_global_mesh(None)
    x = torch.arange(4.0, requires_grad=True)
    assert C.psum(x, "mp") is x
    assert C.ppermute(x, "pp", [(0, 0)]) is x
    assert p2p.ppermute_exchange(x, "pp", [(0, 0)]) is x
    assert C.all_gather_grad(x, ("dp", "sharding")) is x
    assert torch.equal(C.ppermute(x, "pp", []), torch.zeros(4))
    tmesh.set_global_mesh(None)


def test_coordinator_address_follows_the_references_order(monkeypatch):
    from paddle_tpu.distributed import env as renv
    from paddle_tpu_torch.distributed import env as tenv
    for v in ("PADDLE_MASTER", "PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    cases = [{}, {"MASTER_ADDR": "10.0.0.9", "MASTER_PORT": "1234"},
             {"PADDLE_TRAINER_ENDPOINTS": "1.2.3.4:5,6.7.8.9:10",
              "MASTER_ADDR": "10.0.0.9"},
             {"PADDLE_MASTER": "9.9.9.9:99",
              "PADDLE_TRAINER_ENDPOINTS": "1.2.3.4:5"}]
    for env in cases:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tenv.coordinator_address() == renv.coordinator_address()
        for k in env:
            monkeypatch.delenv(k)


def test_one_process_without_a_coordinator_starts_no_group(monkeypatch):
    from paddle_tpu_torch.distributed import env as tenv
    for v in ("PADDLE_MASTER", "PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR",
              "MASTER_PORT", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(tenv, "_initialized", [False])
    penv = tenv.init_parallel_env()
    assert tenv.is_initialized() and not tenv.distributed_is_initialized()
    assert (penv.rank, penv.world_size, penv.local_rank) == (0, 1, 0)


def test_bring_up_failure_names_the_coordinator(monkeypatch):
    from paddle_tpu_torch.distributed import env as tenv
    from paddle_tpu_torch.distributed.launch.context import free_port
    master = f"127.0.0.1:{free_port()}"      # nobody serves it
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_MASTER", master)
    monkeypatch.setattr(tenv, "_initialized", [False])
    with pytest.raises(RuntimeError, match=master.replace(".", r"\.")):
        tenv.init_parallel_env(timeout_s=2, device="cpu")
    assert not tenv.is_initialized()


def test_the_default_backend_is_the_card(monkeypatch):
    import torch
    from paddle_tpu_torch.distributed import env as tenv
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setattr(tenv, "_initialized", [False])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenv.init_parallel_env()
