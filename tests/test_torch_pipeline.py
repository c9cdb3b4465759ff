"""The pipeline schedules of ``paddle_tpu_torch.parallel.pipeline``
against ``paddle_tpu/parallel/pipeline.py``: fill-drain, the
interleaved virtual pipeline and 1F1B, outputs and gradients, on the
inputs of the reference's own tests (``test_pipeline_interleave.py``,
``test_pipeline_1f1b.py``, ``test_distributed.py:241-299``).

The reference runs each schedule as one ``shard_map`` program over 4
of the conftest's 8 CPU devices; the port runs 4 gloo ranks (one
spawned job, workers in ``tests/torch_dist_workers.py``), rank = stage.
The port's gradients are the loss's (Megatron: the loss that every
stage computes from ``last_stage_broadcast`` is one objective), where
the reference's ``shard_map`` transposes sum the stages' copies: its
tests divide by the stage count, and so do these comparisons with the
reference's pipelines. Tolerances are the reference tests' own.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from paddle_tpu.core.compat import shard_map
from paddle_tpu.parallel import mesh as rmesh
from paddle_tpu.parallel import pipeline as rpp

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.parallel import pipeline as tpp

S = 4


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    ctx = spawn(W.pipeline_scenarios, args=(str(out),), nprocs=S,
                join=False, env={"OMP_NUM_THREADS": "1"})
    try:
        assert ctx.join(timeout=180), "the 4-rank job did not finish"
    finally:
        ctx.terminate()
    ranks = []
    for r in range(S):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def setups():
    return W.pipeline_setups()


def _mesh():
    m = rmesh.build_mesh({"pp": S}, devices=jax.devices()[:S])
    rmesh.set_global_mesh(m)
    return m


def _chunk(p, x):
    return jax.nn.gelu(x @ p["w"] + p["b"])


def test_stage_info_and_order(job):
    assert [r["stage"] for r in job] == [(r, S) for r in range(S)]
    assert tpp.interleave_chunk_order(4, 2) == \
        rpp.interleave_chunk_order(4, 2) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert all(r["imports"] == [] for r in job)


def test_interleaved_outputs_and_gradients(job, setups):
    inter = setups[0]
    order = rpp.interleave_chunk_order(S, 2)
    mesh = _mesh()

    def loss(wl, bl, mb):
        out = rpp.pipeline_spmd_interleaved(_chunk, {"w": wl, "b": bl}, mb,
                                            2, axis_name="pp")
        out = rpp.last_stage_broadcast(out, "pp")
        return jnp.sum(out ** 2) / S, out

    f = jax.jit(shard_map(jax.grad(loss, argnums=(0, 1), has_aux=True),
                          mesh=mesh, in_specs=(P("pp"), P("pp"), P()),
                          out_specs=((P("pp"), P("pp")), P()),
                          check_vma=False))
    (gw, gb), out = f(inter["w"][order], inter["b"][order], inter["x"])
    rmesh.set_global_mesh(None)
    for r in job:
        np.testing.assert_allclose(r["interleave"][0], np.asarray(out),
                                   rtol=2e-4, atol=2e-5)
    got_w = np.concatenate([r["interleave"][1] for r in job])
    got_b = np.concatenate([r["interleave"][2] for r in job])
    np.testing.assert_allclose(got_w, np.asarray(gw), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got_b, np.asarray(gb), rtol=2e-3, atol=1e-4)


def test_interleaved_validation_errors(job):
    for r in job:
        a, b = r["errors"]
        assert a is not None and "must divide" in a
        assert b is not None and "leading dim" in b


def test_fill_drain_outputs_and_gradients(job, setups):
    fd = setups[2]
    mesh = _mesh()

    def loss(w, x):
        out = rpp.pipeline_spmd(lambda wp, a: jnp.tanh(a @ wp[0]), w, x,
                                axis_name="pp")
        out = rpp.last_stage_broadcast(out, "pp")
        return jnp.sum(out ** 2), out

    f = jax.jit(shard_map(jax.grad(loss, has_aux=True), mesh=mesh,
                          in_specs=(P("pp"), P()), out_specs=(P("pp"), P()),
                          check_vma=False))
    g, out = f(fd["w"], fd["x"])
    rmesh.set_global_mesh(None)
    # the reference's test_pipeline_spmd_gradients takes jax.grad of the
    # shard_map outside it: the serial gradient (its l.295)
    def serial(w, x):
        for s in range(S):
            x = jnp.tanh(x @ w[s])
        return jnp.sum(x ** 2)
    g_ref = jax.grad(serial)(fd["w"], fd["x"])
    for r in job:
        np.testing.assert_allclose(r["fill_drain"][0], np.asarray(out),
                                   rtol=1e-4, atol=1e-4)
    got = np.concatenate([r["fill_drain"][1] for r in job])
    np.testing.assert_allclose(got, np.asarray(g_ref), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(g) / S, rtol=1e-3, atol=1e-4)


def test_fill_drain_is_the_one_chunk_case(job, setups):
    inter = setups[0]
    mesh = _mesh()

    def fn(wl, bl, mb):
        out = rpp.pipeline_spmd(
            lambda p, xx: _chunk({"w": p["w"][0], "b": p["b"][0]}, xx),
            {"w": wl, "b": bl}, mb, axis_name="pp")
        return rpp.last_stage_broadcast(out, "pp")

    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("pp"), P("pp"), P()),
                          out_specs=P(), check_vma=False))
    want = np.asarray(f(inter["w"][:S], inter["b"][:S], inter["x"][:7]))
    rmesh.set_global_mesh(None)
    for r in job:
        np.testing.assert_allclose(r["fill_drain_m7"], want, rtol=2e-4,
                                   atol=2e-5)


def test_1f1b_loss_and_gradients(job, setups):
    f1b = setups[1]
    mesh = _mesh()

    def prog(params, x, lab):
        loss, grads = rpp.pipeline_1f1b(
            lambda p, xx: jnp.tanh(xx @ p["w"] + p["b"]), params, x, lab,
            lambda y, lb: jnp.mean((y - lb) ** 2), axis_name="pp")
        return rpp.last_stage_broadcast(loss, "pp"), grads

    f = jax.jit(shard_map(prog, mesh=mesh,
                          in_specs=({"w": P("pp"), "b": P("pp")}, P(), P()),
                          out_specs=(P(), {"w": P("pp"), "b": P("pp")}),
                          check_vma=False))
    loss, grads = f({"w": f1b["w"], "b": f1b["b"]}, f1b["x"], f1b["lab"])
    rmesh.set_global_mesh(None)
    for r in job:
        np.testing.assert_allclose(r["1f1b"][0], float(loss), rtol=1e-5)
    for i, k in ((1, "w"), (2, "b")):
        got = np.concatenate([r["1f1b"][i] for r in job])
        np.testing.assert_allclose(got, np.asarray(grads[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_ppermute_exchange_and_its_gradient(job):
    """Stage r sends to r + 1: it receives r's value (from r - 1) and
    its input's gradient is what r + 1 weighted it with."""
    for r in job:
        s = r["rank"]
        np.testing.assert_array_equal(r["ppermute"][0],
                                      np.full(3, float((s - 1) % S + 1)))
        np.testing.assert_array_equal(r["ppermute"][1],
                                      np.full(3, float((s + 1) % S + 1)))
