"""``models/gpt_moe.py`` of ``paddle_tpu_torch`` against the reference's
(``paddle_tpu/models/gpt_moe.py``): the counterpart of
``tests/test_gpt_moe.py`` at tiny widths.

One process: the model's loss, its ``l_aux`` and every gradient (GShard
gate with random routing, so the draws must be the reference's), then
``jit.TrainStep`` over three steps, against the reference with its own
seeded weights carried across by name. Over gloo ranks: the
``__graft_entry__._dryrun_expert`` path (``fleet.init`` with the world
as ``dp``, the ``"dp"`` group as ``moe_group``, the expert-parallel
``MoELayer``, ``compile_train_step``) on 2 ranks with the dryrun's
naive gate and 2 experts, and on 4 ranks with GShard and 8 experts,
against the reference's Fleet step whose moe group has the same degree
(the reference's ``fleet.init`` needs all 8 CPU devices, so its other 8/n
go to an ``mp`` axis, which the model does not use). Workers are in
``tests/torch_dist_workers.py``.

Tolerances: the loss at rtol 2e-4, atol 1e-5 (``test_fleet_strategy.py:74``),
gradients at rtol 2e-4, atol 2e-5 (``test_moe.py:99``), trained weights by
``testing.trained_weights_close`` (AdamW's sign noise; the key bias,
whose true gradient is 0, to its 2·lr·steps bound only, as ERNIE's and
GPT's are).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu import optimizer as JO
from paddle_tpu.distributed import collective as RC
from paddle_tpu.distributed import fleet as RF
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.models import gpt_moe as RG
from paddle_tpu.parallel import mesh as rmesh
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.models import gpt_moe as TG

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close

one_cpu_thread()

LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
LR = 1e-3


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev
    rmesh.set_global_mesh(None)
    rtopo.set_hybrid_communicate_group(None)


def _np(t):
    if t is None:
        return None
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _state(net):
    return {k: _np(v).copy() for k, v in net.named_parameters()}


def _batch(cfg, b=8, s=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=-1).astype(np.int64)


def _pair(cfg, seed=7):
    J.seed(seed)
    ref = RG.GPTMoEForCausalLM(cfg)
    port = TG.GPTMoEForCausalLM(cfg, device="cpu")
    port.set_state_dict(_state(ref))
    return ref, port


def test_parameter_names_and_shapes_are_the_references():
    ref, port = _pair(RG.gpt_moe_tiny())
    assert [(k, tuple(v.shape)) for k, v in port.named_parameters()] == \
        [(k, tuple(v.shape)) for k, v in ref.named_parameters()]
    assert all(getattr(p, "expert", False) for k, p in
               port.named_parameters() if ".experts." in k)


def test_seeded_model_draws_the_references_weights():
    """The same seed draws the same weights in both packages (the key
    stream, embeddings included: N(0, 0.02) to an ulp of XLA's erfinv),
    so every rank of a job builds the same model."""
    cfg = RG.gpt_moe_tiny()
    J.seed(7)
    ref = RG.GPTMoEForCausalLM(cfg)
    TP.seed(7)
    port = TG.GPTMoEForCausalLM(cfg, device="cpu")
    want = _state(ref)
    for k, v in _state(port).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert TP.get_rng_state()[0] == J.get_rng_state()[0]


@pytest.mark.parametrize("gate", ["gshard", "switch", "naive"])
def test_loss_and_gradients_match_the_reference(gate):
    cfg = RG.gpt_moe_tiny(moe_gate=gate)
    ref, port = _pair(cfg)
    ids, labels = _batch(cfg)
    got = []
    for pkg, net in ((J, ref), (TP, port)):
        pkg.seed(3)
        loss = net.compute_loss(pkg.to_tensor(ids), pkg.to_tensor(labels))
        loss.backward()
        got.append((float(loss), float(net.aux_loss()) if gate != "naive"
                    else 0.0, {k: _np(p.grad) for k, p in
                               net.named_parameters()}))
    (rl, ra, rg), (tl, ta, tg) = got
    np.testing.assert_allclose(tl, rl, **LOSS_TOL)
    np.testing.assert_allclose(ta, ra, rtol=1e-5, atol=1e-7)
    for k, v in rg.items():
        assert (v is None) == (tg[k] is None), k
        if v is not None:
            np.testing.assert_allclose(tg[k], v, err_msg=k, **GRAD_TOL)


def test_train_step_matches_the_reference():
    """``jit.TrainStep`` with AdamW, three steps from the same weights
    and key stream: losses and trained weights."""
    cfg = RG.gpt_moe_tiny(moe_gate="gshard")
    ref, port = _pair(cfg, seed=1)
    ids, labels = _batch(cfg, b=8, seed=2)
    losses = []
    for pkg, opt_mod, net in ((J, JO, ref), (TP, TP.optimizer, port)):
        opt = opt_mod.AdamW(learning_rate=LR, parameters=net.parameters())
        step = pkg.jit.TrainStep(net, lambda m, i, l: m.compute_loss(i, l),
                                 opt)
        pkg.seed(11)
        losses.append([float(step(pkg.to_tensor(ids), pkg.to_tensor(labels)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], **LOSS_TOL)
    assert losses[1][-1] < losses[1][0]
    trained_weights_close({k: torch.from_numpy(v) for k, v in
                           _state(port).items()},
                          {k: torch.from_numpy(v) for k, v in
                           _state(ref).items()}, LR, 3, hidden=cfg.hidden_size)


#: world size -> (name, config keywords, steps)
RUNS = {2: ("dryrun_naive", dict(num_experts=2, moe_gate="naive"), 3),
        4: ("gshard_e8", dict(num_experts=8, moe_gate="gshard"), 3)}


def _ref_fleet(n, cfg_kw, steps):
    s = RF.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": n, "mp_degree": 8 // n}
    RF.init(is_collective=True, strategy=s)
    group = RC.Group("dp", rmesh.get_global_mesh())
    cfg = RG.gpt_moe_tiny(**cfg_kw)
    J.seed(0)
    net = RG.GPTMoEForCausalLM(cfg, moe_group=group)
    assert any(getattr(b.mlp, "_ep_parts", None) is not None
               for b in net.blocks)
    state = _state(net)
    opt = JO.AdamW(learning_rate=LR, parameters=net.parameters())
    dm = RF.distributed_model(net)
    dopt = RF.distributed_optimizer(opt)
    step = dm.compile_train_step(lambda m, i, l: m.compute_loss(i, l), dopt)
    ids, labels = _batch(cfg, b=2 * n, s=16, seed=2)
    J.seed(5)
    losses = [float(step(J.to_tensor(ids), J.to_tensor(labels)))
              for _ in range(steps)]
    return state, ids, labels, losses, _state(net)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    res = {}
    try:
        for n, (name, cfg_kw, steps) in RUNS.items():
            state, ids, labels, losses, params = _ref_fleet(n, cfg_kw, steps)
            rmesh.set_global_mesh(None)
            rtopo.set_hybrid_communicate_group(None)
            out = tmp_path_factory.mktemp(f"gpt_moe{n}")
            runs = {name: (cfg_kw, state, ids, labels, steps, 5)}
            ctx = spawn(W.gpt_moe_scenarios, args=(str(out), runs),
                        nprocs=n, join=False, env={"OMP_NUM_THREADS": "1"})
            try:
                assert ctx.join(timeout=180), f"the {n}-rank job failed"
            finally:
                ctx.terminate()
            ranks = []
            for r in range(n):
                with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
            res[n] = (ranks, losses, params)
    finally:
        rmesh.set_global_mesh(None)
        rtopo.set_hybrid_communicate_group(None)
    return res


@pytest.mark.parametrize("n", sorted(RUNS))
def test_fleet_expert_parallel_step_matches_the_reference(jobs, n):
    """Every rank reports the reference's global losses, holds the same
    weights as every other rank, and those are the reference's trained
    weights (expert weights included: an expert's gradient lives on its
    owner and the data-parallel mean gives the global loss's)."""
    name, _, steps = RUNS[n]
    ranks, losses, params = jobs[n]
    for r in ranks:
        assert r[name]["ep"]
        np.testing.assert_allclose(r[name]["losses"], losses, **LOSS_TOL)
        for k, v in r[name]["params"].items():
            np.testing.assert_array_equal(v, ranks[0][name]["params"][k])
    assert losses[-1] < losses[0]
    trained_weights_close(
        {k: torch.from_numpy(v) for k, v in ranks[0][name]["params"].items()},
        {k: torch.from_numpy(v) for k, v in params.items()}, LR, steps,
        hidden=32, msg=name)


def test_workers_import_neither_jax_nor_the_reference(jobs):
    for n, (ranks, _, _) in jobs.items():
        assert all(r["imports"] == [] for r in ranks), n
