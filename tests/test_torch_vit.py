"""The Vision Transformer (``paddle_tpu_torch.vision.models.vit``)
against the JAX package's on the CPU: the module (weights carried by
``set_state_dict``), the stacked functional path against the module and
against the reference's, and two steps of ``build_vit_train_step`` (the
loss and every updated array). fp32 throughout; bound ``OUT`` (the
flash path and the matmuls sum in other orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as _place
from paddle_tpu.vision.models import vit as JV
from paddle_tpu_torch.vision.models import vit as TV
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close

one_cpu_thread()


@pytest.fixture(autouse=True)
def _cpu_place():
    """The CPU is this file's place; the next file's is left as found."""
    prev = _place._current_place[0]
    tp.set_device("cpu")
    yield
    _place._current_place[0] = prev

OUT = dict(rtol=1e-4, atol=1e-5)


def _np(a):
    v = getattr(a, "_value", a)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _pair(seed=0, **kw):
    jp.seed(seed)
    jm = JV.vit_tiny_test(**kw)
    tm = TV.vit_tiny_test(**kw)
    missing, unexpected = tm.set_state_dict(
        {k: _np(v) for k, v in jm.state_dict().items()})
    assert not missing and not unexpected
    return jm, tm


def _x(b=2, seed=0):
    return np.random.RandomState(seed).randn(b, 3, 16, 16).astype(np.float32)


@pytest.mark.parametrize("class_num", [10, 0])
def test_module_forward_and_features_match_jax(class_num):
    jm, tm = _pair(class_num=class_num)
    x = _x()
    got = tm(tp.to_tensor(x))
    assert tuple(got.shape) == ((2, 10) if class_num else (2, 32))
    np.testing.assert_allclose(_np(got), _np(jm(jp.to_tensor(x))), **OUT)
    feats = tm.forward_features(tp.to_tensor(x))
    assert tuple(feats.shape) == (2, 17, 32)      # cls + 4×4 patches
    np.testing.assert_allclose(
        _np(feats), _np(jm.forward_features(jp.to_tensor(x))), **OUT)
    # a torch tensor in, a torch tensor out
    assert isinstance(tm(torch.from_numpy(x)), torch.Tensor)


def test_module_training_matches_jax():
    """The reference test's eager loop (AdamW, six steps, depth 1): the
    same losses."""
    jm, tm = _pair(seed=2, depth=1)
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3, 16, 16).astype(np.float32)
    y = np.array([0, 1, 2, 3], np.int64)
    runs = []
    for pkg, m in ((jp, jm), (tp, tm)):
        opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=m.parameters())
        losses = []
        for _ in range(6):
            loss = pkg.nn.functional.cross_entropy(m(pkg.to_tensor(x)),
                                                   pkg.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(_np(loss)))
        runs.append(losses)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-4)
    assert runs[1][-1] < runs[1][0]


def test_stacked_params_and_forward_match_module_and_jax():
    jm, tm = _pair()
    jparams = JV.stacked_params_from_module(jm)
    params = TV.stacked_params_from_module(tm)
    assert set(params) == set(jparams)
    for k in jparams:
        np.testing.assert_array_equal(_np(params[k]), _np(jparams[k]), k)
    # copies: the step updates them in place, the module stays
    assert params["qkv_w"].data_ptr() != tm.blocks[0].attn.qkv_weight.data_ptr()
    x = _x()
    for remat in ("dots", "off"):
        got = TV.vit_forward_stacked(params, torch.from_numpy(x), 4, patch=4,
                                     remat=remat)
        np.testing.assert_allclose(_np(got), _np(tm(torch.from_numpy(x))),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            _np(got), _np(JV.vit_forward_stacked(jparams, jnp.asarray(x), 4,
                                                 patch=4, remat=remat)),
            **OUT)


def test_two_train_steps_match_jax():
    """Two steps of the stacked train step (lr 1e-2, fp32): each loss and,
    after them, every param and both AdamW moments against the
    reference's; the port updates the dicts it was given in place."""
    jm, tm = _pair()
    jparams = JV.stacked_params_from_module(jm)
    params = TV.stacked_params_from_module(tm)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 10, (2,)).astype(np.int32)
    jstep, jinit = JV.build_vit_train_step(num_heads=4, patch=4,
                                           learning_rate=1e-2,
                                           dtype=jnp.float32)
    step, init = TV.build_vit_train_step(num_heads=4, patch=4,
                                         learning_rate=1e-2,
                                         dtype=torch.float32)
    jopt, opt = jinit(jparams), init(params)
    same = params["qkv_w"]
    for _ in range(2):
        jl, jparams, jopt = jstep(jparams, jopt, jnp.asarray(x),
                                  jnp.asarray(y))
        tl, params, opt = step(params, opt, torch.from_numpy(x),
                               torch.from_numpy(y))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4)
    assert params["qkv_w"] is same and int(opt["step"]) == 2
    # AdamW: an element whose gradient sits in the packages' rounding
    # noise (the key biases' above all) may step up to 2·lr apart
    # (testing.trained_weights_close)
    trained_weights_close(params, {k: torch.from_numpy(_np(v))
                                   for k, v in jparams.items()},
                          lr=1e-2, steps=2, hidden=32)
    for k in jparams:
        for mom in ("m", "v"):
            np.testing.assert_allclose(_np(opt[mom][k]), _np(jopt[mom][k]),
                                       rtol=1e-3, atol=1e-6,
                                       err_msg=(k, mom))
    for _ in range(4):
        loss, params, opt = step(params, opt, torch.from_numpy(x),
                                 torch.from_numpy(y))
    assert float(loss) < float(tl)
