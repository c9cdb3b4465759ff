"""One eager Llama training step written once against the Paddle surface
(``scripts/eager_llama_step.py``) through both packages from the same
numpy weights: one step (loss, every parameter's gradient, the updated
parameters) and three steps (the losses and the parameters), fp32, and
``GradScaler`` over the same Parameters. Only the import differs between
the two runs. The port runs on the CPU; ``auto_cast``'s per-op casts are
held to the reference's in tests/test_torch_dispatch.py, and
chip_smoke.py (phase 31) holds the card against the CPU, fp32 and O1,
and runs the script at Llama-2-7B widths."""

import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close
from scripts import eager_llama_step as E

one_cpu_thread()

# fp32, two layers: products, norms and softmaxes summed in other orders
# by XLA and PyTorch (test_torch_eager_llama's tolerances)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-3, atol=1e-6)
LR, STEPS = 1e-3, 3
CFG = types.SimpleNamespace(num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, hidden_size=64,
                            intermediate_size=128, vocab_size=128,
                            rms_norm_eps=1e-5)
B, S = 2, 16


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    L, h, m, V = (CFG.num_hidden_layers, CFG.hidden_size,
                  CFG.intermediate_size, CFG.vocab_size)
    kvh = CFG.num_key_value_heads * (h // CFG.num_attention_heads)
    shapes = {"embed": (V, h), "wq": (L, h, h), "wk": (L, h, kvh),
              "wv": (L, h, kvh), "wo": (L, h, h), "w_gate": (L, h, m),
              "w_up": (L, h, m), "w_down": (L, m, h), "lm_head": (h, V)}
    out = {k: (rng.randn(*s) * 0.05).astype(np.float32)
           for k, s in shapes.items()}
    for k, s in (("ln1", (L, h)), ("ln2", (L, h)), ("ln_f", (h,))):
        out[k] = (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
    return out


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=-1)


def _run(package, amp_level=None, steps=STEPS):
    """The script through ``package``: step 1's loss and gradients, the
    parameters after step 1, and every step's loss and the parameters
    after ``steps`` steps."""
    S_ = E.surface(package)
    P = S_.paddle
    params = E.make_parameters(S_, _weights(), CFG.num_hidden_layers)
    opt = E.make_optimizer(S_, params, lr=LR)
    cos, sin = E.rope_tables(S_, S, CFG.hidden_size // CFG.num_attention_heads)
    ids_np, labels_np = _batch()
    ids, labels = P.to_tensor(ids_np), P.to_tensor(labels_np)
    loss = E.forward_backward(S_, params, ids, labels, CFG, cos, sin,
                              amp_level)
    grads = {k: np.asarray(p.grad.numpy(), np.float32)
             for k, p in params.items()}
    opt.step()
    opt.clear_grad()
    after1 = {k: np.asarray(p.numpy()) for k, p in params.items()}
    losses = [float(loss)]
    for _ in range(steps - 1):
        losses.append(float(E.train_step(S_, params, opt, ids, labels, CFG,
                                          cos, sin, amp_level)))
    return dict(grads=grads, after1=after1, losses=losses,
                final={k: np.asarray(p.numpy()) for k, p in params.items()},
                leaf_grads_cleared=all(p.grad is None
                                       for p in params.values()))


@pytest.fixture(scope="module")
def runs():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    try:
        return {pkg: _run(pkg) for pkg in ("paddle_tpu", "paddle_tpu_torch")}
    finally:
        tplace._current_place[0] = prev


def test_one_step_loss_and_gradients(runs):
    ref, port = runs["paddle_tpu"], runs["paddle_tpu_torch"]
    np.testing.assert_allclose(port["losses"][0], ref["losses"][0], **LOSS)
    assert set(port["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(port["grads"][k], g, err_msg=k, **GRADS)
    assert port["leaf_grads_cleared"] and ref["leaf_grads_cleared"]


def test_one_step_updated_parameters(runs):
    ref, port = runs["paddle_tpu"], runs["paddle_tpu_torch"]
    trained_weights_close({k: torch.from_numpy(v)
                           for k, v in port["after1"].items()},
                          {k: torch.from_numpy(v)
                           for k, v in ref["after1"].items()},
                          LR, 1, msg="after one step")


def test_three_steps(runs):
    ref, port = runs["paddle_tpu"], runs["paddle_tpu_torch"]
    np.testing.assert_allclose(port["losses"], ref["losses"], **LOSS)
    assert port["losses"][-1] < port["losses"][0]
    trained_weights_close({k: torch.from_numpy(v)
                           for k, v in port["final"].items()},
                          {k: torch.from_numpy(v)
                           for k, v in ref["final"].items()},
                          LR, STEPS, msg="after three steps")


def test_grad_scaler_over_parameters():
    """``GradScaler`` over the same Parameters in both packages: a good
    step moves the weights as the reference's does; a step whose loss is
    inf is skipped, leaving the weights bitwise unchanged and counting a
    bad step."""
    got = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        S_ = E.surface(pkg)
        P = S_.paddle
        params = E.make_parameters(S_, _weights(), CFG.num_hidden_layers)
        opt = S_.optimizer.AdamW(learning_rate=LR,
                                 parameters=list(params.values()))
        scaler = S_.amp.GradScaler(init_loss_scaling=1024.0)
        cos, sin = E.rope_tables(S_, S, CFG.hidden_size
                                 // CFG.num_attention_heads)
        ids, labels = (P.to_tensor(a) for a in _batch())
        loss = E.loss_fn(S_, params, ids, labels, CFG, cos, sin)
        scaled = scaler.scale(loss)
        assert type(scaled).__name__ == "Tensor"
        scaled.backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        good = {k: np.asarray(p.numpy()) for k, p in params.items()}
        bad_loss = E.loss_fn(S_, params, ids, labels, CFG, cos, sin) \
            * float("inf")
        scaler.scale(bad_loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        after_bad = {k: np.asarray(p.numpy()) for k, p in params.items()}
        got[pkg] = (good, after_bad, scaler.state_dict())
    ref, port = got["paddle_tpu"], got["paddle_tpu_torch"]
    trained_weights_close({k: torch.from_numpy(v) for k, v in port[0].items()},
                          {k: torch.from_numpy(v) for k, v in ref[0].items()},
                          LR, 1, msg="scaled step")
    for k in port[0]:
        np.testing.assert_array_equal(port[1][k], port[0][k])
    # the inf step counts one bad step and resets the good count
    assert port[2] == ref[2] == {"scale": 1024.0, "good": 0, "bad": 1}
