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


# ---------------------------------------------------------------------------
# Fleet hybrid training (the hybrid step, the pipelines, sharding, Fleet)
# ---------------------------------------------------------------------------

def _init_gloo():
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch
    import paddle_tpu_torch.distributed as D
    paddle_tpu_torch.set_device("cpu")
    D.init_parallel_env(device="cpu")
    return D


def _finish(D, out, out_dir, r):
    import torch.distributed as dist
    dist.barrier()
    D.destroy_process_group()
    out["imports"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "paddle_tpu"
                            or m.startswith("paddle_tpu."))
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(out, f)


def hybrid_batch(cfg_vocab: int, M: int, B: int, S: int, seed: int):
    """The (M, B, S) ids and next-token labels both sides train on."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg_vocab, (M, B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=-1).astype(np.int32)


def hybrid_step_scenarios(out_dir: str, plans) -> None:
    """``build_hybrid_train_step`` on every plan of ``plans``:
    ``(name, degrees, options)``, options holding ``layers``, ``M``,
    ``B``, ``S``, ``seed`` and the step's keywords. Each rank records
    its loss; rank 0 also the gathered params and AdamW moments (model
    layer order)."""
    import torch
    D = _init_gloo()
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.parallel import mesh as pmesh
    r = D.get_rank()
    out = {"rank": r}
    for name, degrees, o in plans:
        o = dict(o)
        layers, M, B, S = o.pop("layers"), o.pop("M"), o.pop("B"), o.pop("S")
        seed = o.pop("seed")
        sep_mode = o.pop("sep_mode", "ulysses")
        steps = o.pop("steps", 1)
        save = o.pop("save", False)
        mesh = pmesh.build_mesh(degrees)
        pmesh.set_global_mesh(mesh)
        cfg = L.llama_tiny(num_hidden_layers=layers, sep_mode=sep_mode)
        step, init = L.build_hybrid_train_step(
            cfg, mesh, learning_rate=1e-3, remat=True, device="cpu", **o)
        params, opt = init(seed=0)
        ids, labels = hybrid_batch(cfg.vocab_size, M, B, S, seed)
        k = o.get("k_steps", 1)
        if k > 1:
            ids = np.stack([ids] * k)
            labels = np.stack([labels] * k)
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            loss, params, opt = step(params, opt, torch.from_numpy(ids),
                                     torch.from_numpy(labels))
            losses.append(float(loss))
        res = {"losses": losses, "seconds": time.perf_counter() - t0}
        gathered = {"params": step.gather(params),
                    "m": step.gather(opt["m"]), "v": step.gather(opt["v"])}
        if r == 0:
            res.update({kind: {k2: v.numpy().copy() for k2, v in t.items()}
                        for kind, t in gathered.items()})
        if save:
            res["reload_equal"] = _save_and_reload(
                D, L, os.path.join(out_dir, f"ckpt_{name}"), params, opt)
        out[name] = res
        pmesh.set_global_mesh(None)
    _finish(D, out, out_dir, r)


def _save_and_reload(D, L, path, params, opt):
    """Save this rank's slabs (params and AdamW state) as one sharded
    checkpoint, load it back into zeroed slabs with the same tags, and
    say whether every slab came back bitwise."""
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.parallel.mesh import mark_slab, slab_info
    state = {"params": params, "m": opt["m"], "v": opt["v"]}
    save_state_dict(state, path)
    torch.distributed.barrier()          # the whole world, not a mesh group
    fresh = {kind: {k: mark_slab(torch.zeros_like(v), slab_info(v))
                    for k, v in tree.items()} for kind, tree in state.items()}
    load_state_dict(fresh, path)
    return all(torch.equal(fresh[kind][k], state[kind][k])
               for kind in state for k in state[kind])


def pipeline_setups():
    """The reference tests' pipeline inputs (numpy, seeded):
    ``test_pipeline_interleave.py`` (S 4, V 2, H 8, M 8),
    ``test_pipeline_1f1b.py`` (S 4, H 16, MB 4, M 8) and
    ``test_distributed.py:263`` (4 stages, M 4, h 8)."""
    rng = np.random.RandomState(0)
    S, V, H, M = 4, 2, 8, 8
    inter = dict(w=rng.randn(S * V, H, H).astype(np.float32) * 0.5,
                 b=rng.randn(S * V, H).astype(np.float32) * 0.1,
                 x=rng.randn(M, 2, H).astype(np.float32))
    rng = np.random.RandomState(0)
    H1, MB = 16, 4
    f1b = dict(w=(rng.randn(S, H1, H1) * (1.0 / np.sqrt(H1))).astype(
        np.float32), b=np.zeros((S, H1), np.float32))
    f1b["x"] = rng.randn(M, MB, H1).astype(np.float32)
    f1b["lab"] = rng.randn(M, MB, H1).astype(np.float32)
    rng = np.random.RandomState(2)
    fd = dict(x=rng.randn(4, 2, 8).astype(np.float32))
    fd["w"] = (rng.randn(4, 8, 8) * 0.1).astype(np.float32)
    return inter, f1b, fd


def pipeline_scenarios(out_dir: str) -> None:
    """The schedules of ``parallel.pipeline`` over a 4-stage pp group:
    outputs and this stage's gradients (rank = stage)."""
    import torch
    D = _init_gloo()
    from paddle_tpu_torch.parallel import mesh as pmesh
    from paddle_tpu_torch.parallel import pipeline as pp
    r = D.get_rank()
    pmesh.set_global_mesh(pmesh.build_mesh({"pp": 4}))
    inter, f1b, fd = pipeline_setups()
    t = torch.from_numpy
    out = {"rank": r, "stage": pp.stage_slice_info("pp")}
    order = pp.interleave_chunk_order(4, 2)

    # interleaved virtual pipeline: outputs, and gradients of the sum of
    # squares of the broadcast outputs
    w = t(inter["w"][order][2 * r:2 * r + 2]).requires_grad_(True)
    b = t(inter["b"][order][2 * r:2 * r + 2]).requires_grad_(True)
    chunk = lambda p, x: torch.nn.functional.gelu(  # noqa: E731
        x @ p["w"] + p["b"], approximate="tanh")
    y = pp.last_stage_broadcast(pp.pipeline_spmd_interleaved(
        chunk, {"w": w, "b": b}, t(inter["x"]), 2, axis_name="pp"), "pp")
    (y ** 2).sum().backward()
    out["interleave"] = (y.detach().numpy(), w.grad.numpy(), b.grad.numpy())
    for bad in (dict(x=inter["x"][:7], w=w), dict(x=inter["x"], w=w[:1])):
        try:
            pp.pipeline_spmd_interleaved(chunk, {"w": bad["w"], "b": b[:len(
                bad["w"])]}, t(bad["x"]), 2, axis_name="pp")
            out.setdefault("errors", []).append(None)
        except ValueError as e:
            out.setdefault("errors", []).append(str(e))

    # fill-drain: outputs and gradients of the sum of squares
    wf = t(fd["w"][r:r + 1]).requires_grad_(True)
    y = pp.last_stage_broadcast(pp.pipeline_spmd(
        lambda p, a: torch.tanh(a @ p[0]), wf, t(fd["x"]), axis_name="pp"),
        "pp")
    (y ** 2).sum().backward()
    out["fill_drain"] = (y.detach().numpy(), wf.grad.numpy())
    # fill-drain with M not a multiple of the stages (v = 1)
    y7 = pp.last_stage_broadcast(pp.pipeline_spmd(
        lambda p, a: chunk({"w": p["w"][0], "b": p["b"][0]}, a),
        {"w": t(inter["w"][r:r + 1]), "b": t(inter["b"][r:r + 1])},
        t(inter["x"][:7]), axis_name="pp"), "pp")
    out["fill_drain_m7"] = y7.numpy()

    # 1F1B: loss and this stage's gradients
    loss, grads = pp.pipeline_1f1b(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        {"w": t(f1b["w"][r:r + 1]), "b": t(f1b["b"][r:r + 1])}, t(f1b["x"]),
        t(f1b["lab"]), lambda y, lab: ((y - lab) ** 2).mean(),
        axis_name="pp")
    out["1f1b"] = (float(pp.last_stage_broadcast(loss, "pp")),
                   grads["w"].numpy(), grads["b"].numpy())
    # the ring exchange of the compiled pipeline, with its gradient
    from paddle_tpu_torch.distributed.communication import p2p
    v = t(np.full(3, float(r + 1), np.float32)).requires_grad_(True)
    ring = p2p.ppermute_exchange(v, "pp", [(i, (i + 1) % 4)
                                           for i in range(4)])
    (ring * (r + 1)).sum().backward()
    out["ppermute"] = (ring.detach().numpy(), v.grad.numpy())
    pmesh.set_global_mesh(None)
    _finish(D, out, out_dir, r)


def _load_global(net, state, mesh=None):
    """Every parameter of ``net`` set from the global numpy ``state``
    (by name): an mp-split one takes this rank's slab of it."""
    import torch
    from paddle_tpu_torch.parallel import mesh as pmesh
    m = mesh or pmesh.get_global_mesh()
    with torch.no_grad():
        for name, p in net.named_parameters():
            full = torch.from_numpy(np.ascontiguousarray(state[name]))
            spec = getattr(p, "_sharding_spec", None)
            if spec is not None and "mp" in pmesh.PartitionSpec(*spec).used_axes() \
                    and m is not None and m.degree("mp") > 1:
                full = pmesh.shard_slab(full, spec, m)
            p.copy_(full.to(p.dtype))


def _global_params(net, mesh=None):
    """The global numpy value of every parameter (mp slabs gathered)."""
    from paddle_tpu_torch.parallel import mesh as pmesh
    m = mesh or pmesh.get_global_mesh()
    out = {}
    for name, p in net.named_parameters():
        v = p.detach()
        spec = getattr(p, "_sharding_spec", None)
        if spec is not None and "mp" in pmesh.PartitionSpec(*spec).used_axes() \
                and m is not None and m.degree("mp") > 1:
            v = pmesh.gather_slab(v, spec, m)
        out[name] = v.numpy().copy()
    return out


def fleet_batch(vocab: int, b: int, s: int, seed: int):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=-1).astype(np.int64)


def fleet_scenarios(out_dir: str, llama_state, mlp_state, pipe_state) -> None:
    """``fleet.init`` / ``distributed_model`` / ``distributed_optimizer``
    over 4 gloo ranks: the compiled hybrid step at dp2 x mp2 and at
    sharding2 x mp2 stages 1-3 (with a global-norm clip), the eager
    ``HybridParallelOptimizer``, ``TrainStep(in_shardings=)`` at dp4,
    ``PipelineParallel`` at pp2 x dp2, and the worker queries."""
    import torch
    D = _init_gloo()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.parallel import mesh as pmesh
    r = D.get_rank()
    out = {"rank": r, "out_dir": out_dir,
           "queries": (fleet.worker_index(), fleet.worker_num(),
                                  fleet.is_first_worker())}
    fleet.barrier_worker()
    cfg = L.llama_tiny(num_hidden_layers=2)
    ids, labels = fleet_batch(cfg.vocab_size, 8, 16, 0)

    def init(hybrid, stage=None):
        set_hybrid_communicate_group(None)
        pmesh.set_global_mesh(None)
        s = fleet.DistributedStrategy()
        s.hybrid_configs = hybrid
        if stage is not None:
            s.sharding = True
            s.sharding_configs = {"stage": stage}
        fleet.init(is_collective=True, strategy=s, device="cpu")
        return s

    loss_fn = lambda m, i, l: m.compute_loss(i, l)  # noqa: E731
    runs = {"dp2_mp2": ({"dp_degree": 2, "mp_degree": 2}, None, None),
            "sh2_mp2_stage1": ({"sharding_degree": 2, "mp_degree": 2}, 1,
                               0.5),
            "sh2_mp2_stage2": ({"sharding_degree": 2, "mp_degree": 2}, 2,
                               0.5),
            "sh2_mp2_stage3": ({"sharding_degree": 2, "mp_degree": 2}, 3,
                               None)}
    for name, (hybrid, stage, clip) in runs.items():
        init(hybrid, stage)
        net = L.LlamaForCausalLM(cfg, device="cpu")
        _load_global(net, llama_state)
        kw = {}
        if clip is not None:
            from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm
            kw["grad_clip"] = ClipGradByGlobalNorm(clip)
        opt = optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                              **kw)
        dm = fleet.distributed_model(net)
        dopt = fleet.distributed_optimizer(opt)
        step = dm.compile_train_step(loss_fn, dopt)
        losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
                  for _ in range(3)]
        if stage == 3:
            # stage 3 keeps slabs between steps: gather for the check
            for p in step._params:
                if id(p) in step._zero3:
                    p.data = D.collective._raw_all_gather(
                        p.detach(), step._sharding, 0)
        out[name] = dict(losses=losses, params=_global_params(net),
                         split=[tuple(s.shape) for s in
                                opt.state[opt._names[0]].values()])
        if name in ("dp2_mp2", "sh2_mp2_stage2"):
            out[name]["ckpt"] = _save_train_state(D, net, opt, os.path.join(
                out_dir, f"ts_{name}"), step)

    # the eager path: every dp rank its half of the batch, the optimizer
    # averages the gradients over dp
    init({"dp_degree": 2, "mp_degree": 2})
    net = L.LlamaForCausalLM(cfg, device="cpu")
    _load_global(net, llama_state)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-3, parameters=net.parameters()))
    hcg = fleet.get_hybrid_communicate_group()
    half = slice(hcg.get_data_parallel_rank() * 4,
                 hcg.get_data_parallel_rank() * 4 + 4)
    losses = []
    for _ in range(3):
        loss = net.compute_loss(paddle.to_tensor(ids[half]),
                                paddle.to_tensor(labels[half]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    out["eager_dp2_mp2"] = dict(losses=losses, params=_global_params(net))

    # TrainStep(in_shardings=) over dp4: a plain model, the batch split
    init({"dp_degree": 4})
    from paddle_tpu_torch import jit, nn
    mlp = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    _load_global(mlp, mlp_state)
    xs = np.random.RandomState(5).randn(16, 16).astype(np.float32)
    ys = np.random.RandomState(6).randint(0, 4, (16,)).astype(np.int64)
    ce = nn.CrossEntropyLoss()
    ts = jit.TrainStep(mlp, lambda m, x, y: ce(m(x), y),
                       optimizer.AdamW(learning_rate=0.01,
                                       parameters=mlp.parameters()),
                       in_shardings=pmesh.named_sharding("dp"))
    losses = [float(ts(paddle.to_tensor(xs), paddle.to_tensor(ys)))
              for _ in range(3)]
    out["train_step_in_shardings"] = dict(losses=losses,
                                          params=_global_params(mlp))

    # PipelineParallel at pp2 x dp2, two microbatches
    s = init({"dp_degree": 2, "pp_degree": 2})
    s.hybrid_configs = {"dp_degree": 2, "pp_degree": 2,
                        "accumulate_steps": 2, "micro_batch_size": 2}
    from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                            PipelineLayer)
    pipe = PipelineLayer([LayerDesc(nn.Linear, 16, 32), LayerDesc(nn.ReLU),
                          LayerDesc(nn.Linear, 32, 32), LayerDesc(nn.ReLU),
                          LayerDesc(nn.Linear, 32, 4)],
                         loss_fn=lambda o, y: ce(o, y))
    _load_global(pipe, pipe_state)
    pp_model = fleet.distributed_model(pipe)
    popt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=0.01, parameters=pipe.parameters()))
    hcg = fleet.get_hybrid_communicate_group()
    half = slice(hcg.get_data_parallel_rank() * 8,
                 hcg.get_data_parallel_rank() * 8 + 8)
    losses = [float(pp_model.train_batch(
        (paddle.to_tensor(xs[half]), paddle.to_tensor(ys[half])), popt))
        for _ in range(3)]
    eval_loss = float(pp_model.eval_batch(
        (paddle.to_tensor(xs[half]), paddle.to_tensor(ys[half]))))
    got = {}
    for name, p in pipe.named_parameters():
        # each stage holds its own layers' current values; the others'
        # copies are stale: take each value from its stage
        v = p.detach().clone()
        owner = 0 if int(name.split(".")[1]) < 3 else 1
        D.broadcast(v, src=_pp_rank(hcg, owner),
                    group=hcg.get_pipe_parallel_group())
        got[name] = v.numpy().copy()
    out["pipeline_pp2_dp2"] = dict(losses=losses, params=got,
                                   stage=hcg.get_stage_id(),
                                   eval_loss=eval_loss)
    set_hybrid_communicate_group(None)
    pmesh.set_global_mesh(None)
    _finish(D, out, out_dir, r)


def _pp_rank(hcg, stage: int) -> int:
    """The world rank of ``stage`` in this rank's pp group."""
    return hcg.get_pipe_parallel_group().ranks[stage]


def sharding_data(n: int = 5, seed: int = 1):
    """``tests/test_sharding.py``'s batches."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 16).astype(np.float32),
             rng.randint(0, 4, (8,)).astype(np.int64)) for _ in range(n)]


def sharding_scenarios(out_dir: str, mlp_state, sp_inputs, tp_inputs) -> None:
    """ZeRO's group-sharded levels over a 4-rank sharding group (each
    rank its quarter of every batch), the stage-1 sharding optimizer
    under Fleet, the fused gradient buffers and parameter broadcasts,
    sequence parallelism and the tensor-parallel layers over a 4-rank
    mp group."""
    import torch
    D = _init_gloo()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.parallel import mesh as pmesh
    r = D.get_rank()
    out = {"rank": r}
    batches = sharding_data()
    quarter = slice(2 * r, 2 * r + 2)

    def mlp():
        net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 16),
                            nn.ReLU(), nn.Linear(16, 4))
        _load_global(net, mlp_state)
        return net

    def train(model, opt, rows):
        ce, losses = nn.CrossEntropyLoss(), []
        for x, y in batches:
            loss = ce(model(paddle.to_tensor(x[rows])),
                      paddle.to_tensor(y[rows]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses

    pmesh.set_global_mesh(pmesh.build_mesh({"sharding": 4}))
    for level in ("os", "os_g", "p_g_os"):
        net = mlp()
        opt = optimizer.AdamW(learning_rate=0.1, parameters=net.parameters())
        model, sopt, _ = group_sharded_parallel(net, opt, level)
        losses = train(model, sopt, quarter)
        shapes = sorted(tuple(v.shape) for s in opt.state.values()
                        for v in s.values())
        spec = [getattr(p, "_sharding_spec", None) for p in net.parameters()]
        if level == "p_g_os":
            out["p_g_os_param_shapes"] = [tuple(p.shape)
                                          for p in net.parameters()]
            save_group_sharded_model(model, os.path.join(out_dir, "gsm"),
                                     optimizer=sopt)
            spec_after = [getattr(p, "_sharding_spec", None)
                          for p in net.parameters()]
        out[level] = dict(losses=losses, state_shapes=shapes, spec=spec,
                          params={k: v.detach().numpy().copy() for k, v in
                                  net.named_parameters()})
    out["p_g_os"]["spec_after_gather"] = spec_after
    pmesh.set_global_mesh(None)

    # stage-1 sharding by parameter under Fleet (dp2 x sharding2: four
    # data slabs)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    net = mlp()
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=0.1, parameters=net.parameters()))
    from paddle_tpu_torch.distributed.fleet.dygraph_sharding_optimizer \
        import DygraphShardingOptimizer
    hcg = fleet.get_hybrid_communicate_group()
    k = hcg.get_data_parallel_rank() * 2 + hcg.get_sharding_parallel_rank()
    out["dygraph_sharding"] = dict(
        is_sharding=isinstance(opt.inner_opt, DygraphShardingOptimizer),
        rank2params=opt.inner_opt._rank2params,
        losses=train(net, opt, slice(2 * k, 2 * k + 2)),
        owned=sorted(opt.inner_opt._optim.state),
        params={n: v.detach().numpy().copy()
                for n, v in net.named_parameters()})
    set_hybrid_communicate_group(None)
    pmesh.set_global_mesh(None)

    # fused buffers and broadcasts over the world (dp 4)
    from paddle_tpu_torch.distributed.fleet.utils import (
        hybrid_parallel_util as hpu, tensor_fusion_helper as tfh)
    pmesh.set_global_mesh(pmesh.build_mesh({"dp": 4}))
    g = pmesh.get_global_mesh().group("dp")
    net = nn.Sequential(*[nn.Linear(64, 64) for _ in range(4)])
    for i, p in enumerate(net.parameters()):
        p.grad = torch.full_like(p, float(r + 1) * (i + 1))
    bufs = tfh.fused_parameters(list(net.parameters()), group_size=20 * 1024,
                                comm_group=g)
    hpu.fused_allreduce_gradients(list(net.parameters()), group=g)
    out["fused"] = (len(bufs), [float(p.grad.mean())
                                for p in net.parameters()])
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(float(r))
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 4}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    hpu.broadcast_dp_parameters(net, fleet.get_hybrid_communicate_group())
    out["broadcast_dp"] = [float(p.mean()) for p in net.parameters()]
    set_hybrid_communicate_group(None)

    # sequence parallelism and the tensor-parallel layers over mp 4
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as spu
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers as mpl
    mesh = pmesh.build_mesh({"mp": 4})
    pmesh.set_global_mesh(mesh)
    g = mesh.group("mp")
    t = torch.from_numpy
    x = sp_inputs["x"]
    shard = spu.scatter_array(t(x), "mp")
    out["sp_roundtrip"] = (tuple(shard.shape),
                           spu.gather_array(shard, "mp").numpy())
    n_xs = sp_inputs["xs"].shape[0] // 4
    xs = t(sp_inputs["xs"][r * n_xs:(r + 1) * n_xs]).requires_grad_(True)
    (spu.all_gather_array(xs, "mp") * t(sp_inputs["w"])).sum().backward()
    xf = t(sp_inputs["xs"]).requires_grad_(True)
    (spu.reduce_scatter_array(xf, "mp") * spu.scatter_array(
        t(sp_inputs["w"]), "mp")).sum().backward()
    out["sp_grads"] = (xs.grad.numpy(), xf.grad.numpy())
    col = spu.ColumnSequenceParallelLinear(8, 32, has_bias=False,
                                           device="cpu")
    row = spu.RowSequenceParallelLinear(32, 8, has_bias=False, device="cpu")
    with torch.no_grad():
        col.weight.copy_(pmesh.shard_slab(t(sp_inputs["w1"]),
                                          col.weight._sharding_spec))
        row.weight.copy_(pmesh.shard_slab(t(sp_inputs["w2"]),
                                          row.weight._sharding_spec))
    n_seq = x.shape[0] // 4
    xl = t(x[r * n_seq:(r + 1) * n_seq]).requires_grad_(True)
    y = row(torch.nn.functional.gelu(col(xl), approximate="tanh"))
    loss = (y ** 2).sum()
    loss.backward()
    out["sp_mlp"] = (float(loss), xl.grad.numpy(), tuple(y.shape))
    # a sequence-parallel parameter's gradient (from this rank's slice)
    # summed over the mp group
    norm = nn.LayerNorm(8)
    spu.mark_as_sequence_parallel_parameter(norm.weight)
    marked = spu.register_sequence_parallel_allreduce_hooks(norm)
    norm.weight.grad = torch.full((8,), float(r + 1))
    spu.sequence_parallel_sync_gradients(norm)
    out["sp_sync"] = (len(marked), norm.weight.grad.numpy())
    # ops are identities at mp degree 1
    pmesh.set_global_mesh(None)
    one = t(x)
    out["sp_identity"] = all(op.apply(one) is one for op in (
        spu.ScatterOp, spu.GatherOp, spu.AllGatherOp, spu.ReduceScatterOp))
    pmesh.set_global_mesh(mesh)
    # the tensor-parallel layers against one-device math
    emb = mpl.VocabParallelEmbedding(64, 16, device="cpu")
    c1 = mpl.ColumnParallelLinear(16, 32, has_bias=True, gather_output=True,
                                  device="cpu")
    c2 = mpl.ColumnParallelLinear(32, 24, has_bias=False,
                                  gather_output=False, device="cpu")
    r2 = mpl.RowParallelLinear(24, 64, has_bias=True, input_is_parallel=True,
                               device="cpu")
    pce = mpl.ParallelCrossEntropy()
    with torch.no_grad():
        for layer, key in ((emb, "emb"), (c1, "c1"), (c2, "c2"), (r2, "r2")):
            layer.weight.copy_(pmesh.shard_slab(t(tp_inputs[key]),
                                                layer.weight._sharding_spec))
            if getattr(layer, "bias", None) is not None:
                b = t(tp_inputs[key + "_b"])
                layer.bias.copy_(pmesh.shard_slab(
                    b, layer.bias._sharding_spec) if layer.bias._sharding_spec
                    else b)
    ids = t(tp_inputs["ids"])
    b = c2(torch.tanh(c1(emb(ids))))                  # this rank's 6 of 24
    c = r2(torch.relu(b))
    per_tok = pce(C.scatter_to_group(c, g, dim=2), t(tp_inputs["lab"]))
    loss = per_tok.mean()
    loss.backward()
    grads = {}
    for k, layer in (("emb", emb), ("c1", c1), ("c2", c2), ("r2", r2)):
        grads[k] = pmesh.gather_slab(layer.weight.grad,
                                     layer.weight._sharding_spec).numpy()
    grads["c1_b"] = pmesh.gather_slab(c1.bias.grad, c1.bias._sharding_spec
                                      ).numpy()
    grads["r2_b"] = r2.bias.grad.numpy()
    out["tp"] = dict(loss=float(loss), per_tok=per_tok.detach().numpy(),
                     grads=grads,
                     gathered=mpl.mp_all_gather_last_dim(b.detach()).numpy(),
                     summed=mpl.mp_all_reduce(
                         torch.full((2,), float(r + 1))).numpy())
    from paddle_tpu_torch.nn.layer import ParamAttr
    from paddle_tpu_torch.nn import initializer as I
    attr = mpl.ColumnParallelLinear(8, 8, weight_attr=ParamAttr(
        initializer=I.Constant(0.5), learning_rate=2.0), device="cpu")
    out["param_attr"] = (tuple(attr.weight.shape),
                         float(attr.weight.min()), float(attr.weight.max()),
                         attr.weight.optimize_attr["learning_rate"])
    pmesh.set_global_mesh(None)
    _finish(D, out, out_dir, r)


#: the parameter whose AdamW moment the TrainState checks gather
_Q = "llama.layers.0.self_attn.q_proj.weight"


def _save_train_state(D, net, opt, path, step):
    """Save ``TrainState(net, opt)`` from every rank (each its slabs:
    the mp layers' and the ZeRO-split moments') and return ``_Q``'s
    optimizer key and global first moment, gathered here."""
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (TrainState,
                                                         save_state_dict)
    from paddle_tpu_torch.parallel import mesh as pmesh
    save_state_dict(TrainState(net, opt).state_dict(), path)
    torch.distributed.barrier()
    idx = [n for n, _ in net.named_parameters()].index(_Q)
    key, p = opt._names[idx], opt._parameter_list[idx]
    m = opt.state[key]["moment1"]
    if tuple(m.shape) != tuple(p.shape):          # a ZeRO slab on dim 0
        m = D.collective._raw_all_gather(m, step._sharding, 0)
    return key, pmesh.gather_slab(m, p._sharding_spec).numpy().copy()


# ---------------------------------------------------------------------------
# Distributed III: ring attention, expert parallelism, GPT-MoE
# ---------------------------------------------------------------------------

def _np_grad(t):
    return None if t.grad is None else t.grad.detach().numpy().copy()


def ring_scenarios(out_dir: str, cases, flash_cases) -> None:
    """Ring attention over a sep group of every rank. ``cases``: name ->
    ``(q, k, v, g, causal)`` global (B, S, H, D) arrays; each rank runs
    ``ring_attention_array`` on its chunk and backpropagates its chunk
    of the cotangent ``g``, recording its chunk of out, dq, dk and dv.
    ``flash_cases``: the same through ``ring_flash_attention`` with the
    global arrays on every rank (every rank records the global result
    and gradients)."""
    import torch
    D = _init_gloo()
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.parallel import mesh as pmesh
    r, n = D.get_rank(), D.get_world_size()
    pmesh.set_global_mesh(pmesh.build_mesh({"sep": n}))
    out = {"rank": r}
    for name, (q, k, v, g, causal) in cases.items():
        s = q.shape[1] // n
        rows = slice(r * s, (r + 1) * s)
        tq, tk, tv = (torch.tensor(a[:, rows], requires_grad=True)
                      for a in (q, k, v))
        o = ra.ring_attention_array(tq, tk, tv, "sep", causal=causal)
        o.backward(torch.from_numpy(g[:, rows].copy()))
        out[name] = dict(out=o.detach().numpy().copy(), dq=_np_grad(tq),
                         dk=_np_grad(tk), dv=_np_grad(tv))
    for name, (q, k, v, g, causal) in flash_cases.items():
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = ra.ring_flash_attention(tq, tk, tv, causal=causal)
        o.backward(torch.from_numpy(g))
        out[name] = dict(out=o.detach().numpy().copy(), dq=_np_grad(tq),
                         dk=_np_grad(tk), dv=_np_grad(tv))
    pmesh.set_global_mesh(None)
    _finish(D, out, out_dir, r)


def moe_expert(kind: str, nn, d: int):
    """An expert of the MoE scenarios: ``"ffn"`` (Linear → GELU → Linear,
    the expert-parallel path's shape) or ``"single"`` (one Linear in a
    Layer of its own, which keeps the gather path)."""
    if kind == "ffn":
        return nn.Sequential(nn.Linear(d, 2 * d), nn.GELU(),
                             nn.Linear(2 * d, d))

    class Single(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(d, d)

        def forward(self, x):
            return self.fc(x)
    return Single()


def moe_scenarios(out_dir: str, layers, ffn_cases) -> None:
    """``MoELayer`` over a moe group of every rank. ``layers``: name ->
    options (``d``, ``E``, ``expert``, ``gate``, ``topk``, ``cap``,
    ``rr``, ``training``, ``state`` (the reference's weights), the
    global ``x`` and cotangent ``g``, ``coef``, ``seed``, ``clip``).
    Each rank feeds its rows of ``x`` and backpropagates ``sum(y·g) +
    coef·l_aux``; it records its rows of the output and of dx, its
    ``l_aux`` and its parameter gradients, and with ``clip`` the
    gradients through ``ClipGradForMOEByGlobalNorm`` after the
    replicated ones are summed over the group. ``ffn_cases``: name ->
    ``(x, logits, w1, w2, capacity, topk)`` global arrays through
    ``expert_parallel_ffn`` (rows and experts split over the ranks)."""
    import torch
    D = _init_gloo()
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, MoELayer)
    from paddle_tpu_torch.ops import moe_ops
    from paddle_tpu_torch.parallel import mesh as pmesh
    r, n = D.get_rank(), D.get_world_size()
    mesh = pmesh.build_mesh({"dp": n})
    pmesh.set_global_mesh(mesh)
    group = C.Group("dp", mesh)
    out = {"rank": r}
    for name, o in layers.items():
        d, E = o["d"], o["E"]
        layer = MoELayer(d, [moe_expert(o["expert"], nn, d)
                             for _ in range(E)],
                         gate=o["gate"], topk=o.get("topk"),
                         capacity_factor=o["cap"], moe_group=group,
                         random_routing=o.get("rr", True))
        layer.set_state_dict(o["state"])
        if not o["training"]:
            layer.eval()
        t = o["x"].shape[0] // n
        rows = slice(r * t, (r + 1) * t)
        x = torch.tensor(o["x"][rows], requires_grad=True)
        TP.seed(o["seed"])
        y = layer(x)
        loss = (y * torch.from_numpy(o["g"][rows].copy())).sum() \
            + o["coef"] * layer.l_aux
        loss.backward()
        named = list(layer.named_parameters())
        res = dict(out=y.detach().numpy().copy(), dx=_np_grad(x),
                   aux=float(layer.l_aux), ep=layer._ep_parts is not None,
                   grads={k: _np_grad(p) for k, p in named})
        if o.get("clip"):
            pairs = [(p, p.grad if getattr(p, "expert", False)
                      else C._raw_all_reduce(p.grad, group)) for _, p in named]
            clip = ClipGradForMOEByGlobalNorm(o["clip"], moe_group=group)
            res["clipped"] = {k: g2.numpy().copy() for (k, _), (_, g2)
                              in zip(named, clip(pairs))}
        out[name] = res
    for name, (x, logits, w1, w2, cap, topk) in ffn_cases.items():
        t, e = x.shape[0] // n, w1.shape[0] // n
        rows, mine = slice(r * t, (r + 1) * t), slice(r * e, (r + 1) * e)
        y = moe_ops.expert_parallel_ffn(
            torch.from_numpy(x[rows]), torch.from_numpy(logits[rows]),
            torch.from_numpy(w1[mine]), torch.from_numpy(w2[mine]), group,
            num_experts=w1.shape[0], capacity=cap, topk=topk)
        out[name] = y.numpy().copy()
    pmesh.set_global_mesh(None)
    _finish(D, out, out_dir, r)


def gpt_moe_scenarios(out_dir: str, runs) -> None:
    """GPT-MoE trained through the Fleet path as
    ``__graft_entry__._dryrun_expert`` does: ``fleet.init`` with
    ``dp_degree`` the world size, the ``"dp"`` group as ``moe_group``,
    ``fleet.distributed_model(net).compile_train_step``. ``runs``: name
    -> (config keywords, the reference's weights, global ids, labels,
    steps, seed). Every rank passes the global batch; it records the
    losses, its final weights and whether the expert-parallel path
    engaged."""
    import torch
    D = _init_gloo()
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import topology as topo
    from paddle_tpu_torch.models.gpt_moe import (GPTMoEForCausalLM,
                                                 gpt_moe_tiny)
    from paddle_tpu_torch.parallel import mesh as pmesh
    r, n = D.get_rank(), D.get_world_size()
    out = {"rank": r}
    for name, (cfg_kw, state, ids, labels, steps, seed) in runs.items():
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": n}
        fleet.init(is_collective=True, strategy=strategy)
        group = C.Group("dp", pmesh.get_global_mesh())
        cfg = gpt_moe_tiny(**cfg_kw)
        net = GPTMoEForCausalLM(cfg, moe_group=group, device="cpu")
        net.set_state_dict(state)
        opt = optimizer.AdamW(learning_rate=1e-3,
                              parameters=net.parameters())
        dm = fleet.distributed_model(net)
        dopt = fleet.distributed_optimizer(opt)
        step = dm.compile_train_step(
            lambda m, i, l: m.compute_loss(i, l), dopt)
        TP.seed(seed)
        losses = [float(step(TP.to_tensor(ids), TP.to_tensor(labels)))
                  for _ in range(steps)]
        out[name] = dict(
            losses=losses,
            ep=any(getattr(b.mlp, "_ep_parts", None) is not None
                   for b in net.blocks),
            params={k: p.detach().numpy().copy()
                    for k, p in net.named_parameters()})
        pmesh.set_global_mesh(None)
        topo.set_hybrid_communicate_group(None)
    _finish(D, out, out_dir, r)


# ---------------------------------------------------------------------------
# auto_parallel: shard_tensor and reshard over the job's ranks
# ---------------------------------------------------------------------------

def auto_parallel_scenarios(out_dir: str, x: np.ndarray) -> None:
    """``shard_tensor`` and ``reshard`` of the global ``x`` (4, 6) over a
    2-rank mesh, each rank's slab out: Shard(0) over a flat mesh,
    Shard→Replicate (an all-gather), Replicate→Shard(1) (a cut), and
    [Replicate, Shard(1)] over a (1, 2) mesh."""
    D = _init_gloo()
    import torch
    r = D.get_rank()
    out = {}
    flat = D.ProcessMesh([0, 1], dim_names=["x"])
    grid = D.ProcessMesh([[0, 1]], dim_names=["a", "b"])
    s0 = D.shard_tensor(x, flat, [D.Shard(0)])
    out["shard0"] = (_np(s0), tuple(s0._sharding_spec), s0.is_distributed,
                     s0._value._slab.pieces)
    rep = D.reshard(s0, flat, [D.Replicate()])
    out["to_replicate"] = (_np(rep), tuple(rep._sharding_spec))
    s1 = D.reshard(rep, flat, [D.Shard(1)])
    out["to_shard1"] = _np(s1)
    s01 = D.reshard(s0, flat, [D.Shard(1)])
    out["shard0_to_shard1"] = _np(s01)
    g = D.shard_tensor(torch.from_numpy(x), grid,
                       [D.Replicate(), D.Shard(1)])
    out["grid"] = (_np(g), tuple(g._sharding_spec))
    out["dtensor_from_fn"] = _np(D.dtensor_from_fn(
        np.arange, flat, [D.Shard(0)], 8, dtype=np.float32))
    _finish(D, out, out_dir, r)
