"""ZeRO sharding, sequence parallelism, the tensor-parallel layers over
an mp group and the Fleet gradient utilities of ``paddle_tpu_torch``
against the reference (``tests/test_sharding.py``,
``test_sequence_parallel.py``, ``test_fleet_utils.py`` and the
one-device math of ``mp_layers``).

The reference runs one controller over the conftest's CPU devices (its
sharded training equals unsharded training); the port runs 4 gloo ranks
(one spawned job, workers in ``tests/torch_dist_workers.py``), each
rank with its quarter of every batch and its slabs. Weights and inputs
come from numpy seeds (the reference model's state carried across).
Tolerances are the reference tests' own: group-sharded losses and
weights rtol 2e-4, atol 2e-5 (``test_sharding.py:81``); sequence
parallelism rtol 1e-4 / 1e-3, atol 1e-4 (``test_sequence_parallel.py:
106``).
"""

import os
import pickle

import jax.numpy as jnp
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as nn
from paddle_tpu.distributed.meta_parallel import mp_layers as rmpl
from paddle_tpu.distributed.sharding import shard_spec_for as rspec
from paddle_tpu.parallel import mesh as rmesh

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.sharding import shard_spec_for
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()
N = 4


def _mlp(seed=0):
    paddle.seed(seed)
    return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 16),
                         nn.ReLU(), nn.Linear(16, 4))


@pytest.fixture(scope="module")
def inputs():
    rmesh.set_global_mesh(None)
    mlp_state = {k: np.asarray(v._value).copy()
                 for k, v in _mlp().named_parameters()}
    rng = np.random.RandomState(2)
    sp = dict(x=rng.randn(16, 2, 8).astype(np.float32),
              xs=rng.randn(16, 4).astype(np.float32),
              w=rng.randn(16, 4).astype(np.float32),
              w1=rng.randn(8, 32).astype(np.float32) * 0.3,
              w2=rng.randn(32, 8).astype(np.float32) * 0.3)
    rng = np.random.RandomState(3)
    tp = dict(emb=rng.randn(64, 16).astype(np.float32) * 0.3,
              c1=rng.randn(16, 32).astype(np.float32) * 0.3,
              c1_b=rng.randn(32).astype(np.float32) * 0.1,
              c2=rng.randn(32, 24).astype(np.float32) * 0.3,
              r2=rng.randn(24, 64).astype(np.float32) * 0.3,
              r2_b=rng.randn(64).astype(np.float32) * 0.1,
              ids=rng.randint(0, 64, (2, 5)).astype(np.int64),
              lab=rng.randint(0, 64, (2, 5)).astype(np.int64))
    return mlp_state, sp, tp


@pytest.fixture(scope="module")
def job(tmp_path_factory, inputs):
    out = tmp_path_factory.mktemp("sharding")
    ctx = spawn(W.sharding_scenarios, args=(str(out),) + inputs, nprocs=N,
                join=False, env={"OMP_NUM_THREADS": "1"})
    try:
        assert ctx.join(timeout=180), "the 4-rank job did not finish"
    finally:
        ctx.terminate()
    ranks = []
    for r in range(N):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, out


@pytest.fixture(scope="module")
def baseline():
    """The reference's unsharded training (test_sharding.py:_baseline)."""
    rmesh.set_global_mesh(None)
    model = _mlp()
    opt = paddle.optimizer.AdamW(learning_rate=0.1,
                                 parameters=model.parameters())
    ce, losses = nn.CrossEntropyLoss(), []
    for x, y in W.sharding_data():
        loss = ce(model(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {k: np.asarray(v._value)
                    for k, v in model.named_parameters()}


def test_shard_spec_for_matches():
    for shape, deg in (((8, 3), 2), ((3, 8), 2), ((3, 5), 2), ((4,), 4)):
        assert tuple(shard_spec_for(shape, "sharding", deg)) == \
            tuple(rspec(shape, "sharding", deg))


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_parity(job, baseline, level):
    ranks, _ = job
    want_losses, want_params = baseline
    got = np.mean([r[level]["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, want_losses, rtol=2e-4, atol=2e-5)
    for r in ranks:
        for k, v in want_params.items():
            np.testing.assert_allclose(r[level]["params"][k], v, rtol=2e-4,
                                       atol=2e-5, err_msg=f"{level} {k}")


def test_state_and_parameters_are_split(job):
    ranks, _ = job
    for r in ranks:
        # the moments of the (16, 32), (32, 16), (16, 4) weights and of
        # the 32- and 16-wide biases split on their first dim; the 4-wide
        # bias too (4 / 4)
        assert r["os"]["state_shapes"] == sorted(
            [(4, 32)] * 2 + [(8, 16)] * 2 + [(4, 4)] * 2 + [(8,)] * 2
            + [(4,)] * 2 + [(1,)] * 2)
        assert r["os_g"]["state_shapes"] == r["os"]["state_shapes"]
        assert r["p_g_os_param_shapes"] == [(4, 32), (8,), (8, 16), (4,),
                                            (4, 4), (1,)]
        assert all(s is not None for s in r["p_g_os"]["spec"])
        assert all(s is None for s in r["p_g_os"]["spec_after_gather"])


def test_save_group_sharded_model(job):
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.core import place as tplace
    ranks, out = job
    prev = tplace._current_place[0]
    tp.set_device("cpu")
    try:
        state = tp.load(os.path.join(out, "gsm", "model.pdmodel"))
    finally:
        tplace._current_place[0] = prev
    for k, v in ranks[0]["p_g_os"]["params"].items():
        np.testing.assert_array_equal(np.asarray(state[k]), v, err_msg=k)
    assert os.path.exists(os.path.join(out, "gsm", "opt.pdopt"))


def test_fleet_wraps_the_sharding_optimizer(job, baseline):
    ranks, _ = job
    want_losses, want_params = baseline
    runs = [r["dygraph_sharding"] for r in ranks]
    assert all(r["is_sharding"] for r in runs)
    names = sorted(n for ps in runs[0]["rank2params"].values() for n in ps)
    assert len(names) == 6 and len(set(names)) == 6
    # each sharding rank holds the state of its own parameters only
    for r in runs:
        assert len(r["owned"]) < 6
    np.testing.assert_allclose(np.mean([r["losses"] for r in runs], axis=0),
                               want_losses, rtol=2e-4, atol=2e-5)
    for r in runs:
        for i, (k, v) in enumerate(want_params.items()):
            np.testing.assert_allclose(list(r["params"].values())[i], v,
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def test_fused_allreduce_and_broadcast(job):
    ranks, _ = job
    for r in ranks:
        n_bufs, means = r["fused"]
        assert n_bufs > 1
        # every rank's gradient (r + 1)(i + 1) averaged over 4 ranks
        assert means == [2.5 * (i + 1) for i in range(8)]
        assert r["broadcast_dp"] == [0.0] * 8


def test_sequence_parallel_ops(job, inputs):
    ranks, _ = job
    _, sp, _ = inputs
    for r in ranks:
        shape, back = r["sp_roundtrip"]
        assert shape == (4, 2, 8)
        np.testing.assert_array_equal(back, sp["x"])
        assert r["sp_identity"]
    # the reference's expectations (test_sequence_parallel.py:38-67):
    # bwd(all_gather) sums every rank's cotangent, bwd(reduce_scatter)
    # all-gathers the slices
    gx = np.concatenate([r["sp_grads"][0] for r in ranks])
    np.testing.assert_allclose(gx, N * sp["w"], rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["sp_grads"][1], sp["w"], rtol=1e-5)


def test_sequence_parallel_parameter_sync(job):
    for r in job[0]:
        n, grad = r["sp_sync"]
        assert n == 1
        np.testing.assert_array_equal(grad, np.full(8, 10.0))


def test_sequence_parallel_mlp_matches_dense(job, inputs):
    ranks, _ = job
    _, sp, _ = inputs

    def dense(xf, w1f, w2f):
        h = jax.nn.gelu(xf @ w1f)
        return jnp.sum((h @ w2f) ** 2)

    ref_loss, ref_gx = jax.value_and_grad(dense)(sp["x"], sp["w1"], sp["w2"])
    loss = sum(r["sp_mlp"][0] for r in ranks)
    gx = np.concatenate([r["sp_mlp"][1] for r in ranks])
    assert all(r["sp_mlp"][2] == (4, 2, 8) for r in ranks)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(gx, np.asarray(ref_gx), rtol=1e-3, atol=1e-4)


def test_tensor_parallel_layers_match_one_device(job, inputs):
    """Embedding -> column (gathered) -> column (split) -> row ->
    vocab-parallel CE over mp 4, against the reference's layers with the
    same global weights (its one-device math)."""
    ranks, _ = job
    _, _, tp = inputs
    rmesh.set_global_mesh(None)
    emb = rmpl.VocabParallelEmbedding(64, 16)
    c1 = rmpl.ColumnParallelLinear(16, 32, has_bias=True, gather_output=True)
    c2 = rmpl.ColumnParallelLinear(32, 24, has_bias=False,
                                   gather_output=False)
    r2 = rmpl.RowParallelLinear(24, 64, has_bias=True, input_is_parallel=True)
    for layer, k in ((emb, "emb"), (c1, "c1"), (c2, "c2"), (r2, "r2")):
        layer.weight.set_value(paddle.to_tensor(tp[k]))
        if getattr(layer, "bias", None) is not None:
            layer.bias.set_value(paddle.to_tensor(tp[k + "_b"]))
    b = c2(paddle.tanh(c1(emb(paddle.to_tensor(tp["ids"])))))
    c = r2(nn.functional.relu(b))
    per_tok = rmpl.ParallelCrossEntropy()(c, paddle.to_tensor(tp["lab"]))
    loss = per_tok.mean()
    loss.backward()
    for r in ranks:
        got = r["tp"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["per_tok"], np.asarray(per_tok._value),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["gathered"], np.asarray(b._value),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["summed"], [10.0, 10.0])
        for k, layer in (("emb", emb), ("c1", c1), ("c2", c2), ("r2", r2)):
            np.testing.assert_allclose(got["grads"][k],
                                       np.asarray(layer.weight.grad._value),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["grads"]["c1_b"],
                                   np.asarray(c1.bias.grad._value),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["grads"]["r2_b"],
                                   np.asarray(r2.bias.grad._value),
                                   rtol=1e-4, atol=1e-6)


def test_param_attr_on_a_split_layer(job):
    for r in job[0]:
        assert r["param_attr"] == ((8, 2), 0.5, 0.5, 2.0)


def test_workers_import_neither_jax_nor_the_reference(job):
    assert all(r["imports"] == [] for r in job[0])
