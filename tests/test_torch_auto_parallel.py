"""``distributed.auto_parallel``: the port's ``ProcessMesh``,
``shard_tensor``, ``reshard``, ``shard_layer``, ``Strategy`` and
``Engine`` against the JAX package's (``test_dist_longtail.py``,
``test_static_engine.py``, ``test_distributed.py::test_shard_tensor_api``).

A rank is a process here: a distributed tensor is this rank's slab of
the global tensor, and rank r's slab must equal the reference's shard on
device r (the conftest's 8 CPU devices). One process is rank 0 of any
mesh; ``shard_tensor``/``reshard`` across ranks run as a 2-rank gloo job
(one spawned job, its worker in ``tests/torch_dist_workers.py``)."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed.auto_parallel import Engine as REngine
from paddle_tpu.distributed.auto_parallel import shard_layer as rshard_layer

import paddle_tpu_torch as tp
import paddle_tpu_torch.distributed as dist
import torch_dist_workers as W
from paddle_tpu_torch.distributed.auto_parallel import Engine, shard_layer
from paddle_tpu_torch.parallel.mesh import PartitionSpec as P
from paddle_tpu_torch.parallel.mesh import slab_info
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def _cpu_place():
    from paddle_tpu_torch.core import place
    prev = place._current_place[0]
    tp.set_device("cpu")
    yield
    place._current_place[0] = prev


def _shard_on(arr, c):
    dev = jax.devices()[c]
    shard, = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def test_strategy_shape():
    cfg = {"sharding": {"enable": True, "degree": 4, "stage": 2},
           "pipeline": {"enable": True, "accumulate_steps": 8}}
    s, r = dist.Strategy(cfg), rdist.Strategy(cfg)
    assert s.sharding.enable and s.sharding.degree == 4
    assert s.pipeline.accumulate_steps == 8
    assert s.amp.enable is False
    assert repr(s) == repr(r)


def test_shard_tensor_api():
    """A (2, 4) mesh on one process: rank 0's slab of [Shard(0),
    Replicate()] is the reference's shard on device 0, tagged for the
    sharded checkpoint."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["x", "y"])
    t = dist.shard_tensor(x, mesh, [dist.Shard(0), dist.Replicate()])
    assert t.is_distributed
    assert t._sharding_spec == P("x", None)
    rmesh = rdist.ProcessMesh(np.arange(8).reshape(2, 4),
                              dim_names=["x", "y"])
    r = rdist.shard_tensor(x, rmesh, [rdist.Shard(0), rdist.Replicate()])
    assert tuple(t._sharding_spec) == tuple(r._sharding_spec)
    np.testing.assert_array_equal(t._value.numpy(), _shard_on(r._value, 0))
    info = slab_info(t)
    assert info.global_shape == (8, 4) and info.writes
    assert info.pieces[0][1] == (0, 0)
    assert mesh.mesh == rmesh.mesh and mesh.shape == rmesh.shape
    # a gather over ranks this job lacks raises, a cut does not
    with pytest.raises(ValueError, match="needs all its ranks"):
        dist.reshard(t, mesh, [dist.Replicate(), dist.Replicate()])
    cut = dist.reshard(tp.to_tensor(x), mesh,
                       [dist.Replicate(), dist.Shard(1)])
    np.testing.assert_array_equal(cut._value.numpy(), x[:, :1])


def test_reshard_exported():
    x = np.ones((4, 4), np.float32)
    y = dist.reshard(tp.to_tensor(x), dist.ProcessMesh([0]),
                     [dist.Replicate()])
    r = rdist.reshard(paddle.to_tensor(x), rdist.ProcessMesh([0]),
                      [rdist.Replicate()])
    np.testing.assert_array_equal(y._value.numpy(), np.asarray(r._value))


def _nets():
    """The reference's and the port's nets with the reference's weights."""
    paddle.seed(11)
    rnet = paddle.nn.Sequential(paddle.nn.Linear(6, 24), paddle.nn.Tanh(),
                                paddle.nn.Linear(24, 2))
    net = tp.nn.Sequential(tp.nn.Linear(6, 24), tp.nn.Tanh(),
                           tp.nn.Linear(24, 2))
    with torch.no_grad():
        for (n, p), (rn, rp) in zip(net.named_parameters(),
                                    rnet.named_parameters()):
            assert n == rn
            p.copy_(torch.from_numpy(np.array(rp._value)))
    return rnet, net


def test_shard_layer_replicates():
    _, net = _nets()
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    dist.shard_layer(net, dist.ProcessMesh([0]))
    for n, p in net.named_parameters():
        assert torch.equal(p, before[n])
        assert p._sharding_spec == P(*([None] * p.ndim))


def test_shard_layer_custom_fn_and_hooks():
    calls, seen = [], {}
    rcalls = []

    def input_fn(inputs, mesh):
        seen["in"] = True
        return inputs

    net = tp.nn.Linear(4, 2)
    dist.shard_layer(net, dist.ProcessMesh([0]),
                     lambda name, sub, mesh: calls.append(name),
                     input_fn=input_fn)
    rdist.shard_layer(paddle.nn.Linear(4, 2), rdist.ProcessMesh([0]),
                      lambda name, sub, mesh: rcalls.append(name))
    assert calls == rcalls and calls
    net(tp.to_tensor(np.ones((1, 4), np.float32)))
    assert seen.get("in")


def test_shard_layer_type_checked():
    with pytest.raises(TypeError, match="Layer"):
        dist.shard_layer(object(), dist.ProcessMesh([0]))


def test_shard_layer_places_params():
    """``auto_parallel.shard_layer`` with per-parameter placements on a
    (2, 4) mesh: rank 0 holds the reference's device-0 shard of the
    first weight (out-features over y), the rest whole."""
    rnet, net = _nets()
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["x", "y"])
    rmesh = rdist.ProcessMesh(np.arange(8).reshape(2, 4),
                              dim_names=["x", "y"])

    def shard_fn(name, layer, pmesh):
        if "weight" in name and "0" in name:
            return [("R", None), ("S", 1)]
        return None

    def as_(mod):
        def fn(name, layer, pmesh):
            pl = shard_fn(name, layer, pmesh)
            return pl and [mod.Replicate() if k == "R" else mod.Shard(d)
                           for k, d in pl]
        return fn

    shard_layer(net, mesh, as_(dist))
    rshard_layer(rnet, rmesh, as_(rdist))
    w = net[0].weight
    assert w._sharding_spec == P(None, "y") and tuple(w.shape) == (6, 6)
    np.testing.assert_array_equal(w.detach().numpy(),
                                  _shard_on(rnet[0].weight._value, 0))
    assert slab_info(w).global_shape == (6, 24)
    assert tuple(net[2].weight.shape) == (24, 2)


def test_engine_fit_evaluate_predict():
    """``Engine`` over ``jit.TrainStep``: fit, evaluate and predict of the
    reference's net and data, from the reference's weights, against the
    reference's Engine (losses to fp32 rounding over 24 AdamW steps)."""
    rng = np.random.RandomState(1)
    X = rng.randn(32, 6).astype(np.float32)
    Wt = rng.randn(6, 2).astype(np.float32)
    Y = (X @ Wt).astype(np.float32)
    rnet, net = _nets()

    def mse(pred, label):
        return ((pred - label) ** 2).mean()

    from paddle_tpu.io import TensorDataset as RTD
    from paddle_tpu_torch.io import TensorDataset
    reng = REngine(rnet, loss=mse, optimizer=paddle.optimizer.AdamW(
        learning_rate=2e-2, parameters=rnet.parameters()))
    eng = Engine(net, loss=mse, optimizer=tp.optimizer.AdamW(
        learning_rate=2e-2, parameters=net.parameters()))
    want = reng.fit(RTD([X, Y]), epochs=6, batch_size=8)
    hist = eng.fit(TensorDataset([X, Y]), epochs=6, batch_size=8)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.5, hist
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in want], rtol=1e-4)
    ev = eng.evaluate(TensorDataset([X, Y]), batch_size=8)
    assert ev["loss"] == pytest.approx(
        reng.evaluate(RTD([X, Y]), batch_size=8)["loss"], rel=1e-4)
    preds = eng.predict(TensorDataset([X, Y]), batch_size=8)
    rpreds = reng.predict(RTD([X, Y]), batch_size=8)
    assert len(preds) == 4 and preds[0].shape == (8, 2)
    for a, b in zip(preds, rpreds):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# across two ranks
# ---------------------------------------------------------------------------

X2 = np.arange(24, dtype=np.float32).reshape(4, 6)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("auto_parallel")
    from paddle_tpu_torch.distributed import spawn
    ctx = spawn(W.auto_parallel_scenarios, args=(str(out), X2), nprocs=2,
                join=False, env={"OMP_NUM_THREADS": "1"})
    try:
        assert ctx.join(timeout=180), "the 2-rank job did not finish"
    finally:
        ctx.terminate()
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def test_shard_tensor_and_reshard_across_two_ranks(job):
    """Rank r's slabs equal the reference's shards on device r; Shard ->
    Replicate all-gathers the global tensor; Replicate -> Shard cuts."""
    flat = rdist.ProcessMesh([0, 1], dim_names=["x"])
    grid = rdist.ProcessMesh([[0, 1]], dim_names=["a", "b"])
    want0 = rdist.shard_tensor(X2, flat, [rdist.Shard(0)])
    want1 = rdist.reshard(want0, flat, [rdist.Shard(1)])
    wantg = rdist.shard_tensor(X2, grid, [rdist.Replicate(), rdist.Shard(1)])
    wantf = rdist.dtensor_from_fn(np.arange, flat, [rdist.Shard(0)], 8,
                                  dtype=np.float32)
    for r, out in enumerate(job):
        assert out["imports"] == []
        s0, spec, is_dist, pieces = out["shard0"]
        np.testing.assert_array_equal(s0, _shard_on(want0._value, r))
        assert spec == tuple(want0._sharding_spec) and is_dist
        assert pieces[0][1] == (2 * r, 0)
        np.testing.assert_array_equal(out["to_replicate"][0], X2)
        assert out["to_replicate"][1] == (None, None)
        np.testing.assert_array_equal(out["to_shard1"],
                                      _shard_on(want1._value, r))
        np.testing.assert_array_equal(out["shard0_to_shard1"],
                                      _shard_on(want1._value, r))
        np.testing.assert_array_equal(out["grid"][0],
                                      _shard_on(wantg._value, r))
        assert out["grid"][1] == tuple(wantg._sharding_spec)
        np.testing.assert_array_equal(out["dtensor_from_fn"],
                                      _shard_on(wantf._value, r))
