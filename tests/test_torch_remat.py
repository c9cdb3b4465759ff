"""The selective remat policies of ``models.llama.build_train_step``
(``dots``, ``attn``, ``offload``) against the reference's
``build_hybrid_train_step`` on a one-device mesh with the same policy,
and against the port's ``full`` policy bit for bit.

What each policy keeps shows in what the backward runs again: ``full``
and ``dots`` replay the flash forward (2 L calls a step), ``attn`` and
``offload`` keep its output and LSE (L calls: the reference's flash VJP
replays it, the port does not); ``dots`` runs no matmul twice.
``offload`` moves its outputs to the host: L x (out + LSE) bytes a
microbatch. The reference's ``offload`` policy does not run on
JAX's CPU backend (no host memory space there), so the port's is held
to the reference's ``attn`` numbers, which every policy shares.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import mesh as pmesh
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# the tolerances of test_torch_train.py
PARAMS = dict(rtol=1e-4, atol=2e-6)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-3, atol=1e-6)

B, S, STEPS = 1, 24, 3
POLICIES = ("dots", "attn", "offload")


def _cfgs():
    kw = dict(num_hidden_layers=2, num_key_value_heads=2)
    return JL.llama_tiny(**kw), TL.llama_tiny(**kw)


def _batches(vocab):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, vocab, (STEPS, 2, B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=-1)


@pytest.fixture(scope="module")
def reference():
    """Per policy: the reference's per-step losses and final weights,
    moments, and its initial weights."""
    jcfg, _ = _cfgs()
    mesh = pmesh.build_mesh({}, devices=jax.devices()[:1])
    ids, labels = _batches(jcfg.vocab_size)
    out = {}
    for policy in ("attn", "dots"):
        step, init = JL.build_hybrid_train_step(
            jcfg, mesh, learning_rate=1e-3, remat=True, remat_policy=policy)
        params, opt = init(seed=0)
        init_np = {k: np.asarray(v) for k, v in params.items()}
        losses = []
        for i in range(STEPS):
            loss, params, opt = step(params, opt, ids[i], labels[i])
            losses.append(float(loss))
        out[policy] = (losses, {k: np.asarray(v) for k, v in params.items()},
                       {k: np.asarray(v) for k, v in opt["m"].items()},
                       init_np)
    out["offload"] = out["attn"]
    return out


def _port_run(policy, init_np, remat=True):
    _, tcfg = _cfgs()
    params = TL.params_from_numpy(init_np, tcfg, device="cpu")
    opt = TL.init_opt_state(params)
    step, _ = TL.build_train_step(tcfg, learning_rate=1e-3, remat=remat,
                                  remat_policy=policy, device="cpu")
    ids, labels = _batches(tcfg.vocab_size)
    losses = []
    for i in range(STEPS):
        loss, params, opt = step(params, opt, torch.from_numpy(ids[i]),
                                 torch.from_numpy(labels[i]))
        losses.append(loss)
    return losses, params, opt


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_build_hybrid_train_step(reference, policy):
    want_losses, want_params, want_m, init_np = reference[policy]
    losses, params, opt = _port_run(policy, init_np)
    for i, (a, b) in enumerate(zip(losses, want_losses)):
        np.testing.assert_allclose(float(a), b, err_msg=f"step {i}", **LOSS)
    for k, t in params.items():
        np.testing.assert_allclose(t.numpy(), want_params[k], err_msg=k,
                                   **PARAMS)
        np.testing.assert_allclose(opt["m"][k].numpy(), want_m[k],
                                   err_msg=k, **GRADS)


@pytest.mark.parametrize("policy", POLICIES + ("no-remat", "unknown"))
def test_policy_equals_full_bit_for_bit(reference, policy):
    """The same kernels on the same inputs: every policy's losses and
    weights are ``full``'s exactly (an unknown name is ``full``, as in
    the reference)."""
    init_np = reference["attn"][3]
    want = _port_run("full", init_np)
    got = _port_run(policy, init_np, remat=policy != "no-remat")
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in TL._MATMULS:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _one_step_counts(policy, init_np, monkeypatch, remat=True):
    _, tcfg = _cfgs()
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    params = TL.params_from_numpy(init_np, tcfg, device="cpu")
    step, _ = TL.build_train_step(tcfg, remat=remat, remat_policy=policy,
                                  device="cpu")
    ids, labels = _batches(tcfg.vocab_size)
    TL.offload_bytes[0] = 0
    with _Count() as c:
        step(params, TL.init_opt_state(params), torch.from_numpy(ids[0]),
             torch.from_numpy(labels[0]))
    return len(calls), c.mm, TL.offload_bytes[0]


def test_what_each_policy_keeps(reference, monkeypatch):
    init_np = reference["attn"][3]
    _, tcfg = _cfgs()
    L, M = tcfg.num_hidden_layers, 2           # layers, microbatches
    counts = {p: _one_step_counts(p, init_np, monkeypatch)
              for p in ("full",) + POLICIES}
    counts["no-remat"] = _one_step_counts("full", init_np, monkeypatch,
                                          remat=False)
    assert counts["full"][0] == counts["dots"][0] == 2 * L * M
    assert counts["attn"][0] == counts["offload"][0] == L * M
    assert counts["no-remat"][0] == L * M
    # dots runs no matmul twice (here the plain attention's are matmuls
    # too); full runs those of the forward again
    assert counts["dots"][1] == counts["no-remat"][1] < counts["full"][1]
    h, heads = tcfg.hidden_size, tcfg.num_attention_heads
    per_layer = B * S * h * 4 + B * heads * S * 4      # fp32 out + LSE
    assert counts["offload"][2] == L * M * per_layer
    assert counts["attn"][2] == counts["dots"][2] == 0
