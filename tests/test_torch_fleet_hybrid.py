"""The Fleet hybrid-training facade of ``paddle_tpu_torch`` against the
reference's: ``fleet.init`` / ``distributed_model`` /
``distributed_optimizer`` ending in the compiled ``HybridTrainStep``
(ZeRO stages 1-3 over sharding, tensor parallelism over mp, data
parallelism, ``HybridParallelClipGrad``), the eager
``HybridParallelOptimizer``, ``jit.TrainStep(in_shardings=)`` and
``PipelineParallel``.

The reference runs one controller over the conftest's 8 CPU devices,
its GSPMD step computing the global batch's math; the port runs 4 gloo
ranks (one spawned job, workers in ``tests/torch_dist_workers.py``),
each with its slab of the batch and of the weights. Weights come from
the reference's seeded model (numpy state dicts carried across, each
rank taking its slab); inputs from numpy seeds. Tolerances are the
reference tests' (``test_fleet_strategy.py:74``: rtol 2e-4, atol
1e-5 for losses); the trained weights by
``testing.trained_weights_close`` (AdamW's sign noise).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn, optimizer
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed import topology as topo
from paddle_tpu.models import llama as RL
from paddle_tpu.parallel import mesh as rmesh

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close

one_cpu_thread()
N = 4


@pytest.fixture(autouse=True)
def _clean_mesh():
    yield
    rmesh.set_global_mesh(None)
    topo.set_hybrid_communicate_group(None)


def _np_state(net):
    return {k: np.asarray(v._value).copy()
            for k, v in net.named_parameters()}


@pytest.fixture(scope="module")
def models():
    cfg = RL.llama_tiny(num_hidden_layers=2)
    paddle.seed(11)
    llama = RL.LlamaForCausalLM(cfg)
    paddle.seed(21)
    mlp = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    paddle.seed(31)
    from paddle_tpu.distributed.meta_parallel import LayerDesc, PipelineLayer
    pipe = PipelineLayer([LayerDesc(nn.Linear, 16, 32), LayerDesc(nn.ReLU),
                          LayerDesc(nn.Linear, 32, 32), LayerDesc(nn.ReLU),
                          LayerDesc(nn.Linear, 32, 4)], num_stages=1,
                         loss_fn=lambda o, y: nn.functional.cross_entropy(
                             o, y))
    rmesh.set_global_mesh(None)
    return cfg, _np_state(llama), _np_state(mlp), _np_state(pipe)


@pytest.fixture(scope="module")
def job(tmp_path_factory, models):
    _, llama, mlp, pipe = models
    out = tmp_path_factory.mktemp("fleet")
    ctx = spawn(W.fleet_scenarios, args=(str(out), llama, mlp, pipe),
                nprocs=N, join=False, env={"OMP_NUM_THREADS": "1"})
    try:
        assert ctx.join(timeout=180), "the 4-rank job did not finish"
    finally:
        ctx.terminate()
    ranks = []
    for r in range(N):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _fleet(hybrid, stage=None):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = hybrid
    if stage is not None:
        s.sharding = True
        s.sharding_configs = {"stage": stage}
    fleet.init(is_collective=True, strategy=s)
    return s


def _ref_llama(models, hybrid, stage=None, clip=None, eager=False):
    cfg, state, _, _ = models
    _fleet(hybrid, stage)
    net = RL.LlamaForCausalLM(cfg)
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    kw = {"grad_clip": optimizer.ClipGradByGlobalNorm(clip)} if clip else {}
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                          **kw)
    ids, labels = W.fleet_batch(cfg.vocab_size, 8, 16, 0)
    ids, labels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    dopt = fleet.distributed_optimizer(opt)
    if eager:
        losses = []
        for _ in range(3):
            loss = net.compute_loss(ids, labels)
            loss.backward()
            dopt.step()
            dopt.clear_grad()
            losses.append(float(loss))
    else:
        dm = fleet.distributed_model(net)
        step = dm.compile_train_step(lambda m, i, l: m.compute_loss(i, l),
                                     dopt)
        losses = [float(step(ids, labels)) for _ in range(3)]
    return losses, _np_state(net)


def _check(got, want_losses, want_params, steps=3):
    for r in got:
        np.testing.assert_allclose(r[0], want_losses, rtol=2e-4, atol=1e-5)
    trained_weights_close({k: torch.from_numpy(v) for k, v in
                           got[0][1].items()},
                          {k: torch.from_numpy(v) for k, v in
                           want_params.items()}, 1e-3, steps)


REF_LLAMA = {
    "dp2_mp2": ({"dp_degree": 4, "mp_degree": 2}, None, None),
    "sh2_mp2_stage1": ({"dp_degree": 2, "mp_degree": 2,
                        "sharding_degree": 2}, 1, 0.5),
    "sh2_mp2_stage2": ({"mp_degree": 2, "sharding_degree": 4}, 2, 0.5),
    "sh2_mp2_stage3": ({"mp_degree": 2, "sharding_degree": 4}, 3, None),
}


@pytest.mark.parametrize("name", list(REF_LLAMA))
def test_compiled_hybrid_step_matches_the_reference(job, models, name):
    """The port's ranks (dp2 x mp2, or sharding2 x mp2 at a ZeRO stage)
    against the reference's fleet step on 8 devices (its GSPMD program
    is the global batch's math whatever the degrees)."""
    hybrid, stage, clip = REF_LLAMA[name]
    losses, params = _ref_llama(models, hybrid, stage, clip)
    _check([(r[name]["losses"], r[name]["params"]) for r in job], losses,
           params)


def test_zero_stages_split_the_optimizer_state(job, models):
    """At sharding 2 the AdamW moments of the embedding (vocab 256 / mp
    2 = 128 rows) are 64-row slabs at every stage; at dp2 x mp2 they are
    whole."""
    for r in job:
        assert r["dp2_mp2"]["split"] == [(128, 64), (128, 64)]
        for st in (1, 2, 3):
            assert r[f"sh2_mp2_stage{st}"]["split"] == [(64, 64), (64, 64)]


def test_eager_hybrid_optimizer_matches_the_reference(job, models):
    losses, params = _ref_llama(models, {"dp_degree": 4, "mp_degree": 2},
                                eager=True)
    # each dp rank's loss is its half of the batch: their mean is the
    # reference's global loss
    got = [(np.mean([job[0]["eager_dp2_mp2"]["losses"],
                     job[2]["eager_dp2_mp2"]["losses"]], axis=0),
            job[0]["eager_dp2_mp2"]["params"])]
    _check(got, losses, params)


def test_train_step_in_shardings_matches_the_global_batch(job, models):
    _, _, mlp_state, _ = models
    paddle.seed(0)
    mlp = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    mlp.set_state_dict({k: paddle.to_tensor(v) for k, v in mlp_state.items()})
    xs = np.random.RandomState(5).randn(16, 16).astype(np.float32)
    ys = np.random.RandomState(6).randint(0, 4, (16,)).astype(np.int64)
    ce = nn.CrossEntropyLoss()
    step = paddle.jit.TrainStep(mlp, lambda m, x, y: ce(m(x), y),
                                optimizer.AdamW(learning_rate=0.01,
                                                parameters=mlp.parameters()))
    losses = [float(step(paddle.to_tensor(xs), paddle.to_tensor(ys)))
              for _ in range(3)]
    got = [(np.mean([r["train_step_in_shardings"]["losses"] for r in job],
                    axis=0), job[0]["train_step_in_shardings"]["params"])]
    for r in job:                         # every rank the same weights
        for k, v in r["train_step_in_shardings"]["params"].items():
            np.testing.assert_array_equal(v, got[0][1][k])
    _check(got, losses, _np_state(mlp))


def test_pipeline_parallel_matches_the_reference(job, models):
    """Two stages over two dp replicas, two microbatches each, against
    the reference's one-process PipelineParallel on the whole batch."""
    _, _, _, pipe_state = models
    s = _fleet({"pp_degree": 2, "dp_degree": 4})
    s.hybrid_configs = {"pp_degree": 2, "dp_degree": 4,
                        "accumulate_steps": 4, "micro_batch_size": 4}
    from paddle_tpu.distributed.meta_parallel import LayerDesc, PipelineLayer
    pipe = PipelineLayer([LayerDesc(nn.Linear, 16, 32), LayerDesc(nn.ReLU),
                          LayerDesc(nn.Linear, 32, 32), LayerDesc(nn.ReLU),
                          LayerDesc(nn.Linear, 32, 4)],
                         loss_fn=lambda o, y: nn.functional.cross_entropy(
                             o, y))
    pipe.set_state_dict({k: paddle.to_tensor(v)
                         for k, v in pipe_state.items()})
    from paddle_tpu.distributed.meta_parallel import PipelineParallel
    model = PipelineParallel(pipe, fleet.get_hybrid_communicate_group(), s)
    opt = optimizer.AdamW(learning_rate=0.01, parameters=pipe.parameters())
    xs = np.random.RandomState(5).randn(16, 16).astype(np.float32)
    ys = np.random.RandomState(6).randint(0, 4, (16,)).astype(np.int64)
    losses = [float(model.train_batch((paddle.to_tensor(xs),
                                       paddle.to_tensor(ys)), opt))
              for _ in range(3)]
    eval_loss = float(model.eval_batch((paddle.to_tensor(xs),
                                        paddle.to_tensor(ys))))
    runs = [r["pipeline_pp2_dp2"] for r in job]
    np.testing.assert_allclose(np.mean([runs[0]["eval_loss"],
                                        runs[2]["eval_loss"]]), eval_loss,
                               rtol=2e-4, atol=1e-5)
    assert runs[0]["eval_loss"] == runs[1]["eval_loss"]    # every stage
    assert [r["stage"] for r in runs] == [0, 1, 0, 1]
    got = [(np.mean([runs[0]["losses"], runs[2]["losses"]], axis=0),
            runs[0]["params"])]
    for r in runs:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, got[0][1][k])
    _check(got, losses, _np_state(pipe))


@pytest.mark.parametrize("name", ["dp2_mp2", "sh2_mp2_stage2"])
def test_sharded_train_state_loads_in_one_process(job, tmp_path_factory,
                                                  name):
    """``TrainState(model, optimizer)`` saved by 4 ranks (mp-split
    weights; at sharding 2 the moments split on dim 0 too) loads in one
    process as the global tensors."""
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         read_metadata)
    out = job[0]["out_dir"]
    path = os.path.join(out, f"ts_{name}")
    meta = read_metadata(path)
    got = job[0][name]
    key, moment = got["ckpt"]
    state = {"model": {k: torch.zeros(v.shape) for k, v in
                       got["params"].items()},
             "optimizer": {f"{key}.moment1": torch.zeros(moment.shape)}}
    load_state_dict(state, path)
    for k, v in state["model"].items():
        np.testing.assert_array_equal(v.numpy(), got["params"][k],
                                      err_msg=k)
    np.testing.assert_array_equal(state["optimizer"][f"{key}.moment1"]
                                  .numpy(), moment)
    # q_proj's moment: 2 mp slabs, each cut in 2 at sharding 2
    assert len(meta.state_dict_metadata[f"optimizer.{key}.moment1"]) == \
        (4 if name.startswith("sh2") else 2)


def test_worker_queries(job):
    assert [r["queries"] for r in job] == [(r, N, r == 0) for r in range(N)]
    assert all(r["imports"] == [] for r in job)
