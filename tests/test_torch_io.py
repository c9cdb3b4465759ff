"""The data pipeline of the PyTorch port (``paddle_tpu_torch.io``) against
the JAX package's ``paddle_tpu.io``: the multiprocess loader's scenarios
of tests/test_dataloader_workers.py (ordering and parity with
``num_workers=0`` and with the reference's loader, shuffled epochs,
worker errors, ``worker_init_fn`` and ``get_worker_info``), spawned
workers that load neither JAX nor the JAX package nor torch, and
``TrainState.skip_batches`` after a shuffled resume giving the
reference's batches. The worker datasets live in
tests/torch_io_datasets.py, which imports numpy and the port's ``io``
only."""

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as TP
from paddle_tpu import io as jio
from paddle_tpu.distributed.checkpoint import TrainState as JTrainState
from paddle_tpu_torch import io
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.distributed.checkpoint import TrainState
from paddle_tpu_torch.testing import one_cpu_thread
from torch_io_datasets import (WATCHED, BoomDataset, ModulesDataset,
                               SquareDataset, init_fn)

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(b):
    b = b[0] if isinstance(b, (list, tuple)) else b
    return np.asarray(b._value) if isinstance(b, paddle.Tensor) \
        else b.numpy()


def test_multiprocess_matches_serial_and_the_reference():
    ds = SquareDataset(23)
    ref = [_np(b) for b in jio.DataLoader(ds, batch_size=4, num_workers=0)]
    serial = [_np(b) for b in io.DataLoader(ds, batch_size=4, num_workers=0)]
    loader = io.DataLoader(ds, batch_size=4, num_workers=3)
    parallel = list(loader)
    assert isinstance(parallel[0], TP.Tensor)
    assert len(ref) == len(serial) == len(parallel) == 6
    for a, b, c in zip(ref, serial, parallel):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _np(c))


def test_multiprocess_shuffle_epoch_is_the_references():
    ds = SquareDataset(16)
    loader = io.DataLoader(ds, batch_size=4, num_workers=2, shuffle=True)
    loader.batch_sampler.set_epoch(2)
    vals = np.concatenate([_np(b).ravel() for b in loader])
    assert sorted(vals.tolist()) == [float(i * i) for i in range(16)]
    ref = jio.DataLoader(ds, batch_size=4, shuffle=True)
    ref.batch_sampler.set_epoch(2)
    np.testing.assert_array_equal(
        vals, np.concatenate([_np(b).ravel() for b in ref]))


def test_worker_error_propagates():
    loader = io.DataLoader(BoomDataset(), batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(loader)


def test_worker_init_fn_and_info():
    ds = SquareDataset(8)
    out = list(io.DataLoader(ds, batch_size=2, num_workers=2,
                             worker_init_fn=init_fn))
    assert len(out) == 4
    assert io.get_worker_info() is None        # not in a worker here


def test_spawned_workers_load_no_jax_nor_the_jax_package_nor_torch():
    batches = list(io.DataLoader(ModulesDataset(), batch_size=2,
                                 num_workers=2))
    rows = np.concatenate([_np(b) for b in batches])
    assert rows[:, 0].tolist() == [0, 1, 2, 3]
    loaded = {m: bool(rows[:, 1 + k].any()) for k, m in enumerate(WATCHED)}
    assert loaded == {m: False for m in WATCHED}


def _loaders(ds, **kw):
    return jio.DataLoader(ds, **kw), io.DataLoader(ds, **kw)


def test_skip_batches():
    ds_np = [np.arange(12, dtype=np.float32).reshape(12, 1)]
    for T, mod in ((JTrainState, jio), (TrainState, io)):
        loader = mod.DataLoader(mod.TensorDataset(ds_np), batch_size=2)
        ts = T()
        ts.batch_in_epoch = 2
        np.testing.assert_array_equal(_np(next(ts.skip_batches(loader)))
                                      .ravel(), [4, 5])


def test_skip_batches_after_a_shuffled_resume_gives_the_references():
    """Mid-epoch resume under shuffle replays the permutation: a fresh
    loader pinned to the captured epoch continues after the batches
    already seen, in both packages, with the same batches."""
    ds_np = [np.arange(16, dtype=np.float32).reshape(16, 1)]
    out = {}
    for name, T, mod in (("ref", JTrainState, jio), ("port", TrainState, io)):
        ds = mod.TensorDataset(ds_np)

        def loader():
            return mod.DataLoader(ds, batch_size=4, shuffle=True)

        first = loader()
        first.batch_sampler.set_epoch(3)
        seen = [_np(b).ravel().tolist() for b in first][:2]
        ts = T()
        ts.epoch, ts.batch_in_epoch = 3, 2
        rest = [_np(b).ravel().tolist() for b in ts.skip_batches(loader())]
        full = loader()
        full.batch_sampler.set_epoch(3)
        assert [_np(b).ravel().tolist() for b in full] == seen + rest
        out[name] = seen + rest
    assert out["port"] == out["ref"]


def test_distributed_batch_sampler_is_the_references():
    ds = SquareDataset(10)
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=True)
        jb, tb = (jio.DistributedBatchSampler(ds, **kw),
                  io.DistributedBatchSampler(ds, **kw))
        jb.set_epoch(1)
        tb.set_epoch(1)
        assert list(tb) == list(jb) and len(tb) == len(jb)
    one = io.DistributedBatchSampler(ds, batch_size=4)
    assert (one.nranks, one.local_rank) == (1, 0)
