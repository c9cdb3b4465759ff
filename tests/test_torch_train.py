"""Llama training: the PyTorch port (``paddle_tpu_torch.models.llama``:
``forward_stacked``, ``loss_stacked``, ``build_train_step``) against the
JAX package on the CPU, on the same numpy batches, with the JAX package's
weights carried across through numpy. The port runs its plain kernel
versions here; ``chip_smoke.py`` holds the card against the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import mesh as pmesh
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import rms_norm as trn

# fp32, two layers: products, norms and softmaxes summed in other orders
# by XLA and PyTorch (the serving step's tolerance, test_torch_llama)
LOGITS = dict(rtol=1e-4, atol=1e-5)
# gradients: the same, through the backward's longer chains of sums
GRADS = dict(rtol=1e-3, atol=1e-6)
# after 10 AdamW steps: each step moves a weight by up to lr = 1e-3 with
# m/sqrt(v) computed from gradients that agree to GRADS, so the weights
# agree to a small fraction of one step
PARAMS = dict(rtol=1e-4, atol=2e-6)
LOSS = dict(rtol=1e-5, atol=1e-6)

B, S = 2, 24          # S is not a multiple of the reference's 128 padding


def _configs(**over):
    kw = dict(num_hidden_layers=2, num_key_value_heads=2, **over)
    return JL.llama_tiny(**kw), TL.llama_tiny(**kw)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    np_params = {k: np.asarray(v)
                 for k, v in JL.init_stacked_params(jcfg, seed=0).items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=-1)
    return jcfg, tcfg, np_params, ids, labels


def _torch_params(np_params, tcfg, requires_grad=False):
    p = TL.params_from_numpy(np_params, tcfg, device="cpu")
    return {k: v.requires_grad_(requires_grad) for k, v in p.items()}


def test_forward_logits_and_loss_match_jax(setup):
    jcfg, tcfg, np_params, ids, labels = setup
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    want = np.asarray(jax.jit(functools.partial(
        JL.forward_stacked, config=jcfg))(jp, jnp.asarray(ids)))
    want_loss = float(jax.jit(functools.partial(
        JL.loss_stacked, config=jcfg))(jp, jnp.asarray(ids),
                                       jnp.asarray(labels)))
    tp = _torch_params(np_params, tcfg)
    got = TL.forward_stacked(tp, torch.from_numpy(ids), tcfg)
    assert tuple(got.shape) == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)
    got_loss = TL.loss_stacked(tp, torch.from_numpy(ids),
                               torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(float(got_loss), want_loss, **LOSS)


@pytest.fixture(scope="module")
def jax_grads(setup):
    jcfg, _, np_params, ids, labels = setup
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    return jax.jit(jax.grad(functools.partial(JL.loss_stacked,
                                              config=jcfg)))(
        jp, jnp.asarray(ids), jnp.asarray(labels))


def _check_grads(setup, want, remat):
    _, tcfg, np_params, ids, labels = setup
    tp = _torch_params(np_params, tcfg, requires_grad=True)
    TL.loss_stacked(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                    tcfg, remat=remat).backward()
    assert set(tp) == set(want)
    for k, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want[k]),
                                   err_msg=k, **GRADS)


def test_every_gradient_leaf_matches_jax(setup, jax_grads):
    _check_grads(setup, jax_grads, remat=False)


def test_remat_loss_gradients_match_jax(setup, jax_grads):
    """``loss_stacked(..., remat=True)`` is the composition the train step
    backpropagates; its gradients are the reference's too."""
    _check_grads(setup, jax_grads, remat=True)


def _batches(n_steps, vocab, m=2, mb=1, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (n_steps, m, mb, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=-1)


def test_ten_steps_match_build_hybrid_train_step(setup):
    """Per-step losses and the final weights after 10 AdamW steps, two
    microbatches, full remat — the port against the reference's step on
    a one-device mesh (bench.py's training path)."""
    jcfg, tcfg, _, _, _ = setup
    mesh = pmesh.build_mesh({}, devices=jax.devices()[:1])
    jstep, jinit = JL.build_hybrid_train_step(jcfg, mesh, learning_rate=1e-3,
                                              remat=True)
    jparams, jopt = jinit(seed=0)
    tparams = _torch_params({k: np.asarray(v) for k, v in jparams.items()},
                            tcfg)
    topt = TL.init_opt_state(tparams)
    tstep, _ = TL.build_train_step(tcfg, learning_rate=1e-3, remat=True,
                                   device="cpu")
    ids, labels = _batches(10, jcfg.vocab_size)
    for i in range(10):
        jloss, jparams, jopt = jstep(jparams, jopt, ids[i], labels[i])
        tloss, tparams, topt = tstep(tparams, topt, torch.from_numpy(ids[i]),
                                     torch.from_numpy(labels[i]))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   err_msg=f"step {i}", **LOSS)
    assert int(topt["step"]) == int(jopt["step"]) == 10
    for k, t in tparams.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                   err_msg=k, **PARAMS)
        np.testing.assert_allclose(topt["m"][k].numpy(),
                                   np.asarray(jopt["m"][k]), err_msg=k,
                                   **GRADS)


def _fresh(np_params, tcfg):
    tp = _torch_params(np_params, tcfg)
    return tp, TL.init_opt_state(tp)


def test_k_steps_equals_single_steps(setup):
    _, tcfg, np_params, _, _ = setup
    ids, labels = _batches(2, tcfg.vocab_size, seed=2)
    one, _ = TL.build_train_step(tcfg, device="cpu")
    two, _ = TL.build_train_step(tcfg, k_steps=2, device="cpu")
    p1, o1 = _fresh(np_params, tcfg)
    for i in range(2):
        l1, p1, o1 = one(p1, o1, torch.from_numpy(ids[i]),
                         torch.from_numpy(labels[i]))
    p2, o2 = _fresh(np_params, tcfg)
    l2, p2, o2 = two(p2, o2, torch.from_numpy(ids), torch.from_numpy(labels))
    assert torch.equal(l1, l2)
    assert int(o2["step"]) == 2
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(o1["v"][k], o2["v"][k]), k
    with pytest.raises(ValueError, match="leading axis"):
        two(p2, o2, torch.from_numpy(ids[:1]), torch.from_numpy(labels[:1]))


def test_remat_changes_no_number(setup):
    """Recomputing each layer in the backward gives the same loss and
    weights as keeping the activations."""
    _, tcfg, np_params, _, _ = setup
    ids, labels = _batches(1, tcfg.vocab_size, seed=3)
    out = []
    for remat in (True, False):
        step, _ = TL.build_train_step(tcfg, remat=remat, device="cpu")
        p, o = _fresh(np_params, tcfg)
        loss, p, o = step(p, o, torch.from_numpy(ids[0]),
                          torch.from_numpy(labels[0]))
        out.append((loss, p))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_init_fn_gives_seeded_params_and_fresh_state():
    _, tcfg = _configs()
    _, init = TL.build_train_step(tcfg, device="cpu")
    p, o = init(seed=5)
    p2, _ = init(seed=5)
    assert all(torch.equal(p[k], p2[k]) for k in p)
    assert int(o["step"]) == 0 and o["step"].dtype == torch.int32
    for k, v in p.items():
        assert o["m"][k].dtype == torch.float32 and o["m"][k].shape == v.shape
        assert not o["m"][k].any() and not o["v"][k].any()


def test_cpu_step_launches_no_kernel(setup):
    _, tcfg, np_params, _, _ = setup
    counters = (trn.rms_norm, trn.rms_norm_bwd, tfa.flash_fwd_kernel,
                tfa.flash_bwd_dq_kernel, tfa.flash_bwd_dkv_kernel)
    before = [c.launches for c in counters]
    ids, labels = _batches(1, tcfg.vocab_size, seed=4)
    step, _ = TL.build_train_step(tcfg, device="cpu")
    p, o = _fresh(np_params, tcfg)
    loss, _, _ = step(p, o, torch.from_numpy(ids[0]),
                      torch.from_numpy(labels[0]))
    assert torch.isfinite(loss)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("kw", [
    dict(mesh={"dp": 2}), dict(mesh={"pp": 2, "mp": 1}),
    dict(pipeline_schedule="1f1b"), dict(virtual_pp=2),
    dict(zero_gather="per_step"), dict(seq_shard=True),
    dict(remat_policy="dots"), dict(remat_policy="offload")],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_options_of_later_slices_raise(kw):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TL.build_train_step(tcfg, device="cpu", **kw)


def test_one_device_mesh_is_accepted():
    _, tcfg = _configs()
    step, _ = TL.build_train_step(tcfg, device="cpu",
                                  mesh={"dp": 1, "mp": 1})
    assert callable(step)


def test_init_fn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _configs()
    _, init = TL.build_train_step(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(seed=0)
