"""The strategy and the meta-optimizers of
``paddle_tpu_torch.distributed.fleet`` against ``paddle_tpu``'s, on the
same weights and batches: each wrapper drives a linear model for three
steps in both packages and the weights must agree; the AMP scaler's
configuration, Lamb's swap, gradient merge through the legacy
``clear_gradients`` and the strategy's checks are compared directly.
"""

import jax  # noqa: F401  (the conftest's CPU backend)
import numpy as np
import pytest

import paddle_tpu as rpaddle
from paddle_tpu.distributed import fleet as rfleet
from paddle_tpu.distributed.fleet import meta_optimizers as RM

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import meta_optimizers as TM
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# three fp32 steps of a 4x3 linear model: XLA and PyTorch round the
# products and the optimizers' square roots alike up to an ulp or two
WEIGHTS = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    tpaddle.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(4, 3).astype(np.float32),
            rng.randn(3).astype(np.float32),
            [rng.randn(5, 4).astype(np.float32) for _ in range(3)])


WRAPPERS = {
    "amp_o1": lambda M, o: M.AMPOptimizer(o, {"level": "O1"}),
    "amp_o2": lambda M, o: M.AMPOptimizer(o, {"level": "O2",
                                              "dtype": "bfloat16"}),
    "recompute": lambda M, o: M.RecomputeOptimizer(
        o, {"checkpoints": ["layer"]}),
    "sharding": lambda M, o: M.ShardingOptimizer(o),
    "pipeline": lambda M, o: M.PipelineOptimizer(o),
    "gradient_merge": lambda M, o: M.GradientMergeOptimizer(o, k_steps=2),
    "lamb": lambda M, o: M.LambOptimizer(
        o, {"lamb_weight_decay": 0.05, "exclude_from_weight_decay": ["b"]}),
    "localsgd": lambda M, o: M.LocalSGDOptimizer(o, k_steps=2),
    "dgc": lambda M, o: M.DGCOptimizer(o),
}


def _train(pkg, M, wrap, clear="clear_grad"):
    w0, b0, xs = _data()
    w = pkg.Parameter(w0.copy(), name="w")
    b = pkg.Parameter(b0.copy(), name="b")
    inner = pkg.optimizer.AdamW(learning_rate=0.01, parameters=[w, b],
                                weight_decay=0.1)
    opt = WRAPPERS[wrap](M, inner)
    for x in xs:
        y = pkg.matmul(pkg.to_tensor(x), w) + b
        (y * y).mean().backward()
        opt.step()
        getattr(opt, clear)()
    return opt, np.asarray(w.numpy()), np.asarray(b.numpy())


@pytest.mark.parametrize("wrap", sorted(WRAPPERS))
def test_wrapper_trains_as_the_reference(wrap):
    _, rw, rb = _train(rpaddle, RM, wrap)
    opt, tw, tb = _train(tpaddle, TM, wrap)
    np.testing.assert_allclose(tw, rw, **WEIGHTS)
    np.testing.assert_allclose(tb, rb, **WEIGHTS)
    assert TM.unwrap_optimizer(opt) is opt.inner_opt


@pytest.mark.parametrize("wrap", ["gradient_merge", "amp_o1"])
def test_clear_gradients_dispatches_to_clear_grad(wrap):
    """The legacy name reaches the subclass's ``clear_grad``: gradient
    merge keeps its gradients between accumulation steps through it."""
    _, rw, rb = _train(rpaddle, RM, wrap, clear="clear_gradients")
    _, tw, tb = _train(tpaddle, TM, wrap, clear="clear_gradients")
    np.testing.assert_allclose(tw, rw, **WEIGHTS)
    np.testing.assert_allclose(tb, rb, **WEIGHTS)


def test_state_dict_delegates_to_the_inner_optimizer():
    opt, _, _ = _train(tpaddle, TM, "amp_o1")
    sd = opt.state_dict()
    assert sd.keys() == opt.inner_opt.state_dict().keys()
    fresh, _, _ = _train(tpaddle, TM, "dgc")
    fresh.set_state_dict(sd)
    for k, v in fresh.inner_opt.state_dict().items():
        if hasattr(v, "shape"):
            np.testing.assert_array_equal(np.asarray(v), np.asarray(sd[k]))


@pytest.mark.parametrize("configs", [
    {}, {"dtype": "float16"}, {"dtype": "float16", "level": "O2",
                               "init_loss_scaling": 1024.0,
                               "incr_every_n_steps": 7},
    {"dtype": "float16", "use_dynamic_loss_scaling": False},
    {"dtype": "bfloat16", "decr_ratio": 0.25}], ids=str)
def test_amp_scaler_configuration(configs):
    """Dynamic loss scaling only for float16; the scaler's state is the
    reference's for every configuration."""
    ws = []
    scalers = []
    for pkg, M in ((rpaddle, RM), (tpaddle, TM)):
        w = pkg.Parameter(np.ones((2,), np.float32), name="w")
        opt = M.AMPOptimizer(pkg.optimizer.SGD(learning_rate=0.1,
                                               parameters=[w]), configs)
        assert opt.get_loss_scaler() is opt.scaler
        scalers.append(vars(opt.scaler))
        ws.append((opt.amp_level, opt.amp_dtype,
                   M.unwrap_optimizer(opt)._multi_precision))
    r, t = scalers
    for k in ("_enable", "_scale", "_incr_ratio", "_decr_ratio",
              "_incr_every", "_decr_every", "_dynamic", "_good", "_bad"):
        assert t[k] == r[k], k
    assert t["_enable"] == (configs.get("dtype") == "float16"
                            and configs.get("use_dynamic_loss_scaling", True))
    assert ws[0] == ws[1]


def test_lamb_swap_keeps_lr_parameters_clip_and_exclusions():
    clip = tpaddle.optimizer.ClipGradByGlobalNorm(1.0)
    w = tpaddle.Parameter(np.ones((2,), np.float32), name="w")
    b = tpaddle.Parameter(np.ones((2,), np.float32), name="bias")
    opt = TM.LambOptimizer(
        tpaddle.optimizer.AdamW(learning_rate=0.03, parameters=[w, b],
                                grad_clip=clip),
        {"exclude_from_weight_decay": ["bias"]})
    base = TM.unwrap_optimizer(opt)
    assert isinstance(base, tpaddle.optimizer.Lamb)
    assert base.get_lr() == 0.03 and base._grad_clip is clip
    assert base._names == ["w", "bias"]
    assert base._decay_enabled("bias", b._value) is False
    assert base._decay_enabled("w", w._value) is True


def test_strategy_defaults_match_the_reference():
    r, t = rfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    for k in ("hybrid_configs", "amp_configs", "recompute_configs",
              "sharding_configs", "tensor_parallel_configs",
              "gradient_merge_configs", "lamb_configs", "localsgd_configs",
              "amp", "recompute", "sharding", "gradient_merge", "lamb",
              "localsgd"):
        assert getattr(t, k) == getattr(r, k), k
    for s in (r, t):
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 4, "pp_degree": 1}
        s.amp = True
        s.amp_configs = {"level": "O2"}
    assert t.degrees() == r.degrees() == {"dp": 2, "pp": 1, "sharding": 1,
                                          "sep": 1, "mp": 4}
    assert t.amp_configs == r.amp_configs and repr(t) == repr(r)
    for s in (r, t):
        with pytest.raises(ValueError, match="unknown hybrid config key"):
            s.hybrid_configs = {"tp_degree": 2}


def test_pp_configs_schedule_knob():
    """``test_fleet_strategy.py``'s pp_configs case through the port."""
    s = tfleet.DistributedStrategy()
    assert s.pipeline_schedule() == "fill_drain"
    s.hybrid_configs = {"pp_degree": 2, "pp_configs": {"schedule": "1f1b"}}
    assert s.pipeline_schedule() == "1f1b"
    assert s.virtual_pp_degree() == 1
    with pytest.raises(ValueError, match="schedule"):
        s.hybrid_configs = {"pp_configs": {"schedule": "zb-h1"}}
    with pytest.raises(ValueError, match="unknown pp_configs"):
        s.hybrid_configs = {"pp_configs": {"chunks": 2}}
    # defaults must not be mutated across instances
    assert tfleet.DistributedStrategy().pipeline_schedule() == "fill_drain"


def test_fleet_engine_names_wait_for_the_hybrid_slice():
    """The hybrid-training facade is ported (its parity is
    tests/test_torch_fleet_hybrid.py): the names are fleet_base's and
    hybrid_optimizer's, as the reference's package exports them."""
    from paddle_tpu_torch.distributed.fleet import (fleet_base,
                                                    hybrid_optimizer)
    for name in ("init", "distributed_model", "distributed_optimizer",
                 "worker_index", "worker_num", "is_first_worker",
                 "barrier_worker"):
        assert getattr(tfleet, name) is getattr(fleet_base, name)
    assert tfleet.HybridParallelOptimizer is \
        hybrid_optimizer.HybridParallelOptimizer
    assert tfleet.recompute is tfleet.utils.recompute
