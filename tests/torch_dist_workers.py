"""Worker functions of the port's multi-process tests.

``paddle_tpu_torch.distributed.spawn`` starts each rank as a fresh
process that imports this module by name, so it imports numpy, torch
and the port only: never JAX, the JAX package or the test conftest
(whose XLA flags are for the JAX side). Each worker joins a gloo
process group, runs every scenario of its job, and pickles its
results to ``<out_dir>/rank<r>.pkl``; the test process compares them
with the reference's global results.

Inputs are integer-valued floats, so every reduction is exact whatever
the order of its sums.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np


def slab(rank: int, k: int = 2, base: int = 1) -> np.ndarray:
    """Rank ``rank``'s dim-0 slab of the global ``arange(n * k) + base``."""
    return (np.arange(k, dtype=np.float32) + rank * k + base)


def _np(x):
    v = x._value if hasattr(x, "_value") else x
    return v.detach().cpu().numpy().copy()


def collective_scenarios(out_dir: str) -> None:
    """Every collective, p2p call and object collective of the port at
    this job's world size."""
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.distributed.communication import stream
    from paddle_tpu_torch.parallel import mesh as pmesh

    paddle_tpu_torch.set_device("cpu")
    D.init_parallel_env(device="cpu")
    r, n = D.get_rank(), D.get_world_size()
    out = {"rank": r, "world": n, "backend": D.get_backend(),
           "coordinator": D.env.coordinator_address(),
           "parallel_env": (D.ParallelEnv().rank, D.ParallelEnv().nranks)}
    t = lambda a: Tensor(np.asarray(a, np.float32))  # noqa: E731

    # all_reduce, every op, on this rank's slab of arange(2n) + 1
    for op in ("sum", "max", "min", "avg", "prod"):
        x = t(slab(r))
        y = D.all_reduce(x, op=op)
        out[f"all_reduce_{op}"] = (_np(x), y is x)
    # all_gather: tiled and list forms
    out["all_gather_tiled"] = _np(D.all_gather(t(slab(r))))
    lst = []
    D.all_gather(lst, t(slab(r)))
    out["all_gather_list"] = [_np(v) for v in lst]
    # reduce_scatter of a replicated input, then Paddle's list form
    rep = np.arange(2 * n, dtype=np.float32) + 1
    out["reduce_scatter"] = _np(D.reduce_scatter(t(rep)))
    dst = t(np.zeros(2, np.float32))
    D.reduce_scatter(dst, [t(slab(j) * (r + 1)) for j in range(n)])
    out["reduce_scatter_list"] = _np(dst)
    # alltoall on this rank's slab (n chunks of 2)
    a2a = t(slab(r, k=2 * n))
    out["alltoall"] = _np(D.alltoall(a2a))
    out["alltoall_twice"] = _np(D.alltoall(D.alltoall(a2a)))
    # broadcast: replicated input (the reference's case), then a real one
    rep_t = t(rep)
    D.broadcast(rep_t, src=0)
    out["broadcast_replicated"] = _np(rep_t)
    own = t(slab(r))
    D.broadcast(own, src=n - 1)
    out["broadcast_from_last"] = _np(own)
    # reduce / gather keep the reference's every-rank result
    red = t(slab(r))
    D.reduce(red, dst=0)
    out["reduce"] = _np(red)
    out["gather"] = [_np(v) for v in D.gather(t(slab(r)), dst=0)]
    out["gather_replicated"] = [_np(v) for v in D.gather(t(rep), dst=0)]
    # scatter: rank i gets tensor_list[i] from src 0
    sc = t(np.zeros(2, np.float32))
    D.scatter(sc, [t(slab(j, base=100)) for j in range(n)] if r == 0
              else None, src=0)
    out["scatter"] = _np(sc)
    # raw torch tensors work too
    raw = torch.from_numpy(slab(r))
    D.all_reduce(raw)
    out["all_reduce_torch"] = raw.numpy().copy()
    out["all_reduce_replicated"] = _np(D.collective.all_reduce_replicated(
        t(rep)))
    # object collectives
    objs = []
    D.all_gather_object(objs, {"rank": r, "tag": "x" * r})
    out["all_gather_object"] = objs
    bl = [r, f"from-{r}"]
    D.broadcast_object_list(bl, src=n - 1)
    out["broadcast_object_list"] = bl
    so = []
    D.scatter_object_list(so, [{"to": j} for j in range(n)] if r == 0
                          else None, src=0)
    out["scatter_object_list"] = so
    # new_group: the ranks form and the axis form over a (dp, mp) mesh
    g01 = D.new_group(ranks=[0, 1])
    x = t(slab(r))
    if g01.rank >= 0:
        D.all_reduce(x, group=g01)
    out["new_group_ranks"] = (_np(x), g01.nranks, g01.rank)
    mp = 2
    pmesh.set_global_mesh(pmesh.build_mesh({"mp": mp}))
    gmp = D.new_group(axis="mp")
    x = t(slab(r % mp))       # shard b of the global arange, by mp coord
    D.all_reduce(x, group=gmp)
    out["new_group_axis_mp"] = (_np(x), gmp.ranks, gmp.rank)
    gdp = D.new_group(axis="dp")
    out["new_group_axis_dp"] = (gdp.ranks, gdp.rank)
    # the hybrid topology's groups and this process's coordinate
    topo = D.CommunicateTopology(["dp", "pp", "sharding", "sep", "mp"],
                                 [n // 2, 1, 1, 1, 2])
    hcg = D.HybridCommunicateGroup(topo)
    D.set_hybrid_communicate_group(hcg)
    y = t(np.full(2, float(r + 1), np.float32))
    D.all_reduce(y, group=hcg.get_model_parallel_group())
    out["hcg"] = {
        "coord": (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                  hcg.get_sharding_parallel_rank(),
                  hcg.get_sep_parallel_rank(),
                  hcg.get_model_parallel_rank()),
        "mp_group": hcg.get_model_parallel_group().ranks,
        "dp_group": hcg.get_data_parallel_group().ranks,
        "mp_sum": _np(y),
        "first_last": (hcg.is_first_stage(), hcg.is_last_stage()),
        "dp_src": hcg.get_data_parallel_group_src_rank()}
    # the RNG tracker: dropout masks differ across mp ranks in manual
    # mode, and agree across dp ranks
    from paddle_tpu_torch import random as R
    from paddle_tpu_torch.distributed.meta_parallel import random_state
    from paddle_tpu_torch.parallel import pcontext
    random_state.model_parallel_random_seed(1234)
    with pcontext.manual_parallel({"mp": "mp"}):
        with random_state.get_rng_state_tracker().rng_state():
            mask = R.uniform_draw(R.next_key(), (16,)).numpy()
    out["tracker_manual_mp"] = mask
    # local SGD averages every rank's parameters
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as M
    pmesh.set_global_mesh(None)
    w = torch.nn.Parameter(torch.full((3,), float(r + 1)))
    opt = M.LocalSGDOptimizer(optimizer.SGD(learning_rate=0.5,
                                            parameters=[w]), k_steps=1)
    w.grad = torch.ones(3)
    opt.step()
    out["localsgd"] = w.detach().numpy().copy()
    # the stream namespace
    z = t(slab(r))
    out["stream_all_reduce"] = (_np(stream.all_reduce(z,
                                                      use_calc_stream=True)),
                                stream.all_reduce(z) is z)
    # point-to-point: a ring of blocking calls, tagged non-blocking ones,
    # and a batch listing each receive before its send
    right, left = (r + 1) % n, (r - 1) % n
    got = t(np.zeros(2, np.float32))
    if r % 2 == 0:
        D.send(t(slab(r)), dst=right)
        D.recv(got, src=left)
    else:
        D.recv(got, src=left)
        D.send(t(slab(r)), dst=right)
    out["send_recv_ring"] = _np(got)
    got2 = t(np.zeros(2, np.float32))
    st = D.isend(t(slab(r) * 3), dst=right, tag=1)
    rt = D.irecv(got2, src=left, tag=1)
    out["isend_irecv"] = (_np(got2) if rt.wait() and st.wait() else None,
                          rt.tensor is got2, rt.is_completed())
    ra, rb = t(np.zeros(2, np.float32)), t(np.zeros(2, np.float32))
    ops = [D.P2POp(D.irecv, ra, peer=left, tag=10),
           D.P2POp(D.isend, t(np.full(2, 5.0 + r)), peer=right, tag=10),
           D.P2POp(D.irecv, rb, peer=right, tag=11),
           D.P2POp(D.isend, t(np.full(2, 7.0 + r)), peer=left, tag=11)]
    tasks = D.batch_isend_irecv(ops)
    out["batch_isend_irecv"] = (len(tasks), all(tk.wait() for tk in tasks),
                                _np(ra), _np(rb))
    D.barrier()
    D.destroy_process_group()
    out["after_destroy"] = (D.is_initialized(),
                            D.env.distributed_is_initialized())
    out["imports"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "paddle_tpu"
                            or m.startswith("paddle_tpu."))
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(out, f)


def fail_rank_one(out_dir: str) -> None:
    """Rank 1 exits with an error at once; rank 0 would wait a minute."""
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        raise SystemExit(3)
    time.sleep(60)
