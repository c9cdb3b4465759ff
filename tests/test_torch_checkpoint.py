"""Checkpoints of the PyTorch port (``paddle_tpu_torch.distributed.checkpoint``
and ``paddle_tpu_torch.framework``) against the JAX package's on the CPU:
the scenarios of tests/test_dist_checkpoint.py that need no mesh and of
tests/test_async_checkpoint.py; checkpoints the reference wrote sharded
(an mp 4 and an mp 8 mesh, bfloat16 included) loading array-equal; a
port-written checkpoint in the reference's layout (file names, array
names and bytes, the dtypes map, the metadata); a JAX-written GPT train
state restoring every moment on the parameter of the same name;
``save``/``load`` both ways; and no unstaged write under the port's
checkpoint package."""

import ast
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu_torch as TP
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import resilience as JR
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu.framework import io_save as JIO
from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import mesh as pmesh
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as TR
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.core.tensor import Tensor as TTensor
from paddle_tpu_torch.distributed import checkpoint as TC
from paddle_tpu_torch.distributed.checkpoint import async_save as TA
from paddle_tpu_torch.framework import io_save as TIO
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    pmesh.set_global_mesh(None)
    yield
    pmesh.set_global_mesh(None)
    tplace._current_place[0] = prev


def _sharded(arr, mesh, spec):
    return JTensor(jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec)))


def _bits(t):
    """A tensor's raw bits (a bfloat16 one as int16), for exact
    comparison."""
    t = t._value if isinstance(t, TTensor) else t
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _ref_bits(a):
    a = np.asarray(a._value if hasattr(a, "_value") else a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


# ---------------------------------------------------------------------------
# tests/test_dist_checkpoint.py without a mesh
# ---------------------------------------------------------------------------

def test_flatten_roundtrip():
    nested = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}
    flat, mapping = TC.flatten_state_dict(nested)
    assert (flat, mapping) == JC.flatten_state_dict(nested)
    assert flat == {"a": 1, "b.c": 2, "b.d.e": 3}
    assert TC.unflatten_state_dict(flat, mapping) == nested


def test_missing_key_and_shape_mismatch(tmp_path):
    TC.save_state_dict({"w": TTensor(np.zeros((4, 4), np.float32))},
                       str(tmp_path / "ck"))
    with pytest.raises(KeyError):
        TC.load_state_dict({"nope": TTensor(np.zeros((4, 4), np.float32))},
                           str(tmp_path / "ck"))
    with pytest.raises(ValueError):
        TC.load_state_dict({"w": torch.zeros(2, 4)}, str(tmp_path / "ck"))


# ---------------------------------------------------------------------------
# checkpoints the reference wrote sharded
# ---------------------------------------------------------------------------

def _ref_sharded(case):
    """(reference state dict on a mesh, the global numpy arrays)."""
    if case == "mp4":           # test_reshard_on_load_different_topology
        mesh = pmesh.build_mesh({"mp": 4})
        w = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
        return {"layer": {"w": _sharded(w, mesh, P("mp", None))}}, \
            {"layer.w": w}
    if case == "dp2_mp4":       # test_save_load_same_topology
        mesh = pmesh.build_mesh({"dp": 2, "mp": 4})
        w = np.random.RandomState(0).randn(16, 8).astype(np.float32)
        b = np.random.RandomState(1).randn(8).astype(np.float32)
        return {"w": _sharded(w, mesh, P("mp", None)),
                "b": _sharded(b, mesh, P())}, {"w": w, "b": b}
    mesh = pmesh.build_mesh({"mp": 8})  # test_bf16_roundtrip
    w = np.random.RandomState(0).randn(8, 4).astype(jnp.bfloat16)
    m = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    return {"w": _sharded(w, mesh, P("mp")),
            "opt": {"m": _sharded(m, mesh, P(None, "mp"))}}, \
        {"w": w, "opt.m": m}


@pytest.mark.parametrize("case", ["mp4", "dp2_mp4", "mp8_bf16"])
def test_reference_sharded_checkpoint_loads_array_equal(tmp_path, case):
    sd, want = _ref_sharded(case)
    JC.save_state_dict(sd, str(tmp_path / "ck"))
    meta = TC.read_metadata(str(tmp_path / "ck"))
    assert isinstance(meta, TC.Metadata)
    assert max(len(s) for s in meta.state_dict_metadata.values()) > 1
    target, _ = TC.flatten_state_dict(sd)
    target = {k: torch.zeros(
        v.shape, dtype=torch.bfloat16 if v.dtype == jnp.bfloat16
        else torch.float32) for k, v in want.items()}
    nested = TC.unflatten_state_dict(target, {k: tuple(k.split("."))
                                              for k in target})
    TC.load_state_dict(nested, str(tmp_path / "ck"))
    for k, w in want.items():
        np.testing.assert_array_equal(_bits(target[k]), _ref_bits(w),
                                      err_msg=k)


def test_reference_pickles_map_to_the_port_without_the_jax_package(tmp_path):
    """A fresh process reads the reference's checkpoint and ``save`` file
    through the port without importing ``jax`` or ``paddle_tpu``; a
    pickle naming another class of the JAX package is refused."""
    sd, _ = _ref_sharded("mp8_bf16")
    JC.save_state_dict(sd, str(tmp_path / "ck"))
    JIO.save({"x": paddle.to_tensor(np.arange(3, dtype=np.float32))},
             str(tmp_path / "obj.pdparams"))
    code = (
        "import sys, torch\n"
        "import paddle_tpu_torch as TP\n"
        "from paddle_tpu_torch.distributed import checkpoint as C\n"
        "TP.set_device('cpu')\n"
        f"ck = {str(tmp_path / 'ck')!r}\n"
        "t = {'w': torch.zeros(8, 4, dtype=torch.bfloat16),"
        " 'opt': {'m': torch.zeros(16, 8)}}\n"
        "C.load_state_dict(t, ck)\n"
        f"o = TP.load({str(tmp_path / 'obj.pdparams')!r})\n"
        "assert o['x'].numpy().tolist() == [0.0, 1.0, 2.0]\n"
        "bad = [m for m in ('jax', 'paddle_tpu') if m in sys.modules]\n"
        "assert not bad and float(t['opt']['m'].abs().sum()) > 0, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]

    evil = tmp_path / "evil"
    evil.mkdir()
    with open(evil / "0_0.metadata", "wb") as f:
        pickle.dump(JTensor(np.zeros(2, np.float32)), f)
    with pytest.raises(TC.CheckpointCorruptError,
                       match="paddle_tpu.core.tensor.Tensor"):
        TC.read_metadata(str(evil))


def test_reference_refuses_a_port_checkpoint(tmp_path):
    """The stated difference: the reference checks its own ``Metadata``
    class, so a checkpoint the port wrote does not load there."""
    TC.save_state_dict({"w": torch.ones(2)}, str(tmp_path / "ck"))
    with pytest.raises(JC.CheckpointCorruptError,
                       match="does not contain checkpoint Metadata"):
        JC.load_state_dict({"w": JTensor(np.zeros(2, np.float32))},
                           str(tmp_path / "ck"))


# ---------------------------------------------------------------------------
# a port-written checkpoint is in the reference's layout
# ---------------------------------------------------------------------------

def _meta_fields(m):
    return dict(
        sdm={k: [dataclasses.astuple(s) for s in v]
             for k, v in m.state_dict_metadata.items()},
        storage={dataclasses.astuple(i): r
                 for i, r in m.storage_metadata.items()},
        mapping=m.flat_mapping, aux=m.aux, checksums=sorted(m.checksums))


def test_port_checkpoint_has_the_reference_layout(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(3, 5).astype(np.float32)
    h = rng.randn(4).astype(jnp.bfloat16)
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    ref_sd = {"model": {"w": JTensor(w), "h": JTensor(jnp.asarray(h))},
              "ids": JTensor(ids), "scalar": JTensor(np.float32(2.5)),
              "step": 7, "name": "run"}
    port_sd = {"model": {"w": torch.from_numpy(w),
                         "h": torch.from_numpy(np.asarray(h, np.float32)).to(
                             torch.bfloat16)},
               "ids": TTensor(ids), "scalar": torch.tensor(2.5),
               "step": 7, "name": "run"}
    JC.save_state_dict(ref_sd, str(tmp_path / "ref"))
    TC.save_state_dict(port_sd, str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "ref"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "0_0.distcp.dtypes", "0_0.distcp.npz", "0_0.metadata"]
    with np.load(tmp_path / "ref" / "0_0.distcp.npz") as r, \
            np.load(tmp_path / "port" / "0_0.distcp.npz") as t:
        assert r.files == t.files == ["model.w|0_0", "model.h|0",
                                      "ids|0_0", "scalar|scalar"]
        for k in r.files:
            assert r[k].dtype == t[k].dtype and r[k].tobytes() == \
                t[k].tobytes(), k
    with open(tmp_path / "ref" / "0_0.distcp.dtypes", "rb") as f:
        ref_dt = pickle.load(f)
    with open(tmp_path / "port" / "0_0.distcp.dtypes", "rb") as f:
        port_dt = pickle.load(f)
    assert ref_dt == port_dt == {"model.w|0_0": "float32",
                                 "model.h|0": "bfloat16",
                                 "ids|0_0": "int32", "scalar|scalar": "float32"}
    ref_m = _meta_fields(JC.read_metadata(str(tmp_path / "ref")))
    port_m = _meta_fields(TC.read_metadata(str(tmp_path / "port")))
    assert port_m == ref_m
    assert port_m["aux"] == {"step": 7, "name": "run"}


# ---------------------------------------------------------------------------
# Queue C 7: a JAX-written GPT train state restores by name in the port
# ---------------------------------------------------------------------------

def test_jax_written_gpt_train_state_restores_every_moment_by_name(
        tmp_path):
    """A tiny GPT trained two AdamW steps by the reference and saved as a
    ``TrainState`` (optimizer keys ``generated_tensor_<n>.<slot>``)
    restores in a fresh port process state: every weight bitwise, and
    each moment on the parameter of the same name. The saved names are
    not the port's, so they bind by position: the fused stack's order
    must be the reference's."""
    paddle.seed(0)
    jm = JG.GPTForCausalLM(JG.gpt_tiny())
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters())
    rng = np.random.RandomState(1)
    for _ in range(2):
        ids = rng.randint(0, 128, (2, 8)).astype(np.int32)
        loss = jm.compute_loss(paddle.to_tensor(ids),
                               paddle.to_tensor(np.roll(ids, -1, 1)))
        loss.backward()
        jo.step()
        jo.clear_grad()
    jts = JC.TrainState(jm, jo)
    jts.step(2)
    root = str(tmp_path / "ckpts")
    JR.save_checkpoint(jts.state_dict(), root, step=2)
    saved = sorted({k.rpartition(".")[0] for k in jo.state_dict()
                    if k != "@step"})
    assert all(n.startswith("generated_tensor_") for n in saved)

    tm = TG.GPTForCausalLM(TG.gpt_tiny(), device="cpu")
    to = topt.AdamW(learning_rate=1e-2,
                    parameters=list(tm.named_parameters()))
    tts = TC.TrainState(tm, to)
    assert TR.restore_train_state(tts, root) == 2
    assert to.step_count == 2
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        jp = jparams[name]
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jp._value), err_msg=name)
        for slot in ("moment1", "moment2"):
            np.testing.assert_array_equal(
                to.state[name][slot].numpy(),
                np.asarray(jo._accumulators[id(jp)][slot]),
                err_msg=f"{name}.{slot}")


# ---------------------------------------------------------------------------
# tests/test_async_checkpoint.py
# ---------------------------------------------------------------------------

def _net(seed=21):
    """The port's (3, 8, 2) net with the reference's weights at
    ``seed``, and that reference net."""
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(3, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tnet = tnn.Sequential(tnn.Linear(3, 8), tnn.ReLU(), tnn.Linear(8, 2))
    tnet.set_state_dict({k: np.asarray(v._value)
                         for k, v in jnet.state_dict().items()})
    return tnet, jnet


def test_async_save_then_load(tmp_path):
    net, _ = _net()
    fut = TC.async_save_state_dict(net.state_dict(), str(tmp_path / "ck"))
    path = fut.result(timeout=60)
    assert fut.done()
    net2, _ = _net(5)
    net2.set_state_dict({k: np.zeros(v.shape, np.float32)
                         for k, v in net2.state_dict().items()})
    target = net2.state_dict()
    TC.load_state_dict(target, path)
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_async_save_snapshot_isolated_from_mutation(tmp_path):
    """The snapshot is complete when ``async_save_state_dict`` returns:
    the in-place update that follows does not reach the checkpoint."""
    net, _ = _net()
    w0 = net[0].weight.detach().clone()
    fut = TC.async_save_state_dict(net.state_dict(), str(tmp_path / "ck2"))
    with torch.no_grad():
        net[0].weight.fill_(7.0)
    path = fut.result(60)
    target = _net()[0].state_dict()
    TC.load_state_dict(target, path)
    assert torch.equal(target["0.weight"], w0)


def test_train_state_roundtrip(tmp_path):
    """The reference's scenario through both stacks: the restored
    progress equals the reference's, the weights agree within fp32."""
    out = {}
    for pkg in ("ref", "port"):
        tnet, jnet = _net()
        net = jnet if pkg == "ref" else tnet
        O, C = (jopt, JC) if pkg == "ref" else (topt, TC)
        opt = O.AdamW(learning_rate=1e-2, parameters=net.parameters())
        sched = O.lr.StepDecay(learning_rate=0.1, step_size=2)
        ts = C.TrainState(net, opt, sched)
        x = (paddle if pkg == "ref" else TP).to_tensor(
            np.ones((4, 3), np.float32))
        for _ in range(3):
            (net(x) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
            ts.step()
            sched.step()
        ts.next_epoch()
        ts.step(2)
        fut = C.async_save_state_dict(ts.state_dict(), str(tmp_path / pkg))
        fut.result(60)

        tnet2, jnet2 = _net(7)
        net2 = jnet2 if pkg == "ref" else tnet2
        opt2 = O.AdamW(learning_rate=1e-2, parameters=net2.parameters())
        sched2 = O.lr.StepDecay(learning_rate=0.1, step_size=2)
        ts2 = C.TrainState(net2, opt2, sched2)
        target = ts2.state_dict()
        C.load_state_dict(target, str(tmp_path / pkg))
        ts2.set_state_dict(target)
        assert (ts2.global_step, ts2.epoch, ts2.batch_in_epoch) == (5, 1, 2)
        assert sched2.last_epoch == sched.last_epoch
        out[pkg] = [np.asarray(p._value) if pkg == "ref"
                    else p.detach().numpy() for p in net2.parameters()]
        want = [np.asarray(p._value) if pkg == "ref"
                else p.detach().numpy() for p in net.parameters()]
        for a, b in zip(out[pkg], want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_learning_rate_restores_bit_for_bit(tmp_path):
    """A Python float of the train state (the scheduler's ``last_lr``)
    is kept in float64, so the learning rate a resumed step uses is the
    saved one; the reference's x64-off arrays round it to float32."""
    net, _ = _net()
    sched = topt.lr.CosineAnnealingDecay(0.1, 7)
    opt = topt.AdamW(learning_rate=sched, parameters=net.parameters())
    for _ in range(3):
        sched.step()
    ts = TC.TrainState(net, opt, sched)
    TC.save_state_dict(ts.state_dict(), str(tmp_path / "ck"))
    sched2 = topt.lr.CosineAnnealingDecay(0.1, 7)
    ts2 = TC.TrainState(None, None, sched2)
    target = {"progress": ts2.state_dict()["progress"],
              "lr_scheduler": TA._wrap_leaves(sched2.state_dict())}
    TC.load_state_dict(target, str(tmp_path / "ck"))
    ts2.set_state_dict(target)
    assert sched2.last_lr == sched.last_lr and sched2() == opt.get_lr()


def test_failed_async_save_does_not_wedge(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = TA.save_state_dict

    def flaky(sd, path, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise IOError("disk full")
        return real(sd, path, **kw)

    monkeypatch.setattr(TA, "save_state_dict", flaky)
    net, _ = _net()
    f1 = TA.async_save_state_dict(net.state_dict(), str(tmp_path / "a"))
    with pytest.raises(IOError):
        f1.result(30)
    f2 = TA.async_save_state_dict(net.state_dict(), str(tmp_path / "b"))
    assert f2.result(30)


def test_async_saves_stay_in_order(tmp_path, monkeypatch):
    """An async save starts its write only after the one in flight has
    ended (resume needs the order kept)."""
    gate, order = threading.Event(), []
    real = TA.save_state_dict

    def first(sd, path, **kw):
        assert gate.wait(30)
        order.append(os.path.basename(path))
        return real(sd, path, **kw)

    monkeypatch.setattr(TA, "save_state_dict", first)
    net, _ = _net()
    f1 = TA.async_save_state_dict(net.state_dict(), str(tmp_path / "a"))
    threading.Timer(0.2, gate.set).start()
    f2 = TA.async_save_state_dict(net.state_dict(), str(tmp_path / "b"))
    f2.result(30)
    f1.result(30)
    assert order == ["a", "b"]


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _objects(P, T):
    rng = np.random.RandomState(3)
    return {"w": P.to_tensor(rng.randn(2, 3).astype(np.float32)),
            "h": P.to_tensor(rng.randn(4).astype(np.float32)).astype(
                "bfloat16"),
            "ids": [P.to_tensor(np.arange(3, dtype=np.int32))],
            "meta": {"epoch": 3, "arr": np.arange(2.0)}}


def test_save_and_load_both_ways(tmp_path):
    # the reference's file, read by the port
    ref = _objects(paddle, JTensor)
    JIO.save(ref, str(tmp_path / "ref.pdparams"))
    got = TP.load(str(tmp_path / "ref.pdparams"))
    assert isinstance(got["w"], TTensor) and got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), _ref_bits(ref["w"]))
    np.testing.assert_array_equal(_bits(got["h"]), _ref_bits(ref["h"]))
    np.testing.assert_array_equal(got["ids"][0].numpy(), [0, 1, 2])
    assert got["meta"]["epoch"] == 3
    np.testing.assert_array_equal(got["meta"]["arr"], [0.0, 1.0])

    # the port's file: its own round trip, and the reference's payloads
    port = _objects(TP, TTensor)
    TP.save(port, str(tmp_path / "port.pdparams"))
    back = TP.load(str(tmp_path / "port.pdparams"))
    for k in ("w", "h"):
        np.testing.assert_array_equal(_bits(back[k]), _bits(port[k]))
    with open(tmp_path / "port.pdparams", "rb") as f:
        raw = pickle.load(f)
    for k in ("w", "h"):
        want = JIO._TensorPayload(ref[k]._value)
        assert (raw[k].dtype, raw[k].shape, raw[k].data) == (
            want.dtype, want.shape, want.data), k
        np.testing.assert_array_equal(
            _ref_bits(JIO._TensorPayload.to_numpy(raw[k])),
            _ref_bits(ref[k]))


# ---------------------------------------------------------------------------
# every write under the checkpoint package goes through atomic_write
# ---------------------------------------------------------------------------

def _write_opens(tree):
    """Lines of ``open(...)`` calls whose mode writes (positional or
    ``mode=``), outside the function ``atomic_write``."""
    bad = []

    def visit(node, inside):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside = inside or node.name == "atomic_write"
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "open" and not inside:
            mode = node.args[1] if len(node.args) > 1 else next(
                (k.value for k in node.keywords if k.arg == "mode"), None)
            if mode is None or not isinstance(mode, ast.Constant) or any(
                    c in str(mode.value) for c in "wax+"):
                bad.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    return bad


def test_no_unstaged_writes_in_checkpoint_package():
    pkg = REPO / "paddle_tpu_torch" / "distributed" / "checkpoint"
    files = sorted(pkg.glob("*.py"))
    assert len(files) == 6
    bad = {str(f.relative_to(REPO)): lines for f in files
           for lines in [_write_opens(ast.parse(f.read_text()))] if lines}
    assert not bad, f"write-mode open() outside atomic_write: {bad}"


def test_the_scan_catches_planted_writes():
    planted = ast.parse(
        "def atomic_write(p):\n    open(p, 'wb')\n"
        "def save(p):\n    open(p, 'wb')\n"
        "def append(p):\n    open(p,\n         mode='a')\n"
        "def read(p):\n    open(p, 'rb')\n")
    assert _write_opens(planted) == [4, 6]
