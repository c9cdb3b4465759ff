"""The MoE ops, gates, layer, clip and comm wrappers of
``paddle_tpu_torch`` against the reference's (``paddle_tpu/ops/moe_ops.py``,
``paddle_tpu/incubate/distributed/models/moe/``): the counterparts of
``tests/test_moe.py`` and ``tests/test_moe_skew.py``.

One process: every ``moe_ops`` function on the same seeded numpy inputs
(the index ops exactly, the float ops at the reference tests' rtol 1e-6
/ atol 1e-6, the gather VJPs at rtol 1e-4, atol 1e-5); the three gates
with the reference's weights and key stream (indices and the GShard /
Switch draws bit for bit, probabilities and ``l_aux`` at rtol 1e-5);
``MoELayer``'s gather path forward and gradients (rtol 2e-4, atol 2e-5,
``test_moe.py:99``); the expert-aware clip; ``global_scatter`` /
``global_gather``; the skew accounting of ``test_moe_skew.py``.

Expert parallelism: the reference runs one controller over 2 and 4 of
the conftest's CPU devices, its ``MoELayer`` with a ``dp`` moe group (the
``expert_parallel_apply`` shard_map); the port runs one gloo rank a
device (one spawned job a world size, workers in
``tests/torch_dist_workers.py``), each rank feeding its rows of the
tokens. The ranks' rows concatenated are the reference's output and
input gradient; the ranks' parameter gradients summed are the
reference's (a replicated parameter's share on each rank, an expert's on
its owner only); the ranks' mean ``l_aux`` is the reference's. Tolerance
rtol 1e-4, atol 1e-5 (``test_moe.py:276``); 2e-3 / 1e-4 for the skewed
``expert_parallel_ffn`` (``test_moe_skew.py:141``).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu.core.compat import shard_map
from paddle_tpu.distributed import collective as RC
from paddle_tpu.incubate.distributed.models import moe as RMOE
from paddle_tpu.ops import moe_ops as RM
from paddle_tpu.parallel import mesh as rmesh
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.incubate.distributed.models import moe as TMOE
from paddle_tpu_torch.ops import moe_ops as TM

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

EXACT = dict(rtol=1e-6, atol=1e-6)
LAYER_TOL = dict(rtol=2e-4, atol=2e-5)
EP_TOL = dict(rtol=1e-4, atol=1e-5)
SKEW_TOL = dict(rtol=2e-3, atol=1e-4)
WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    if t is None:
        return None
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _routing(seed=0, N=24, E=4, K=2):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, E, (N, K)).astype(np.int32)
    probs = rng.rand(N, K).astype(np.float32)
    x = rng.randn(N, 8).astype(np.float32)
    return idx, probs, x


# ---------------------------------------------------------------------------
# moe_ops, one process
# ---------------------------------------------------------------------------

def test_capacity_ops_match_the_reference():
    idx, probs, _ = _routing()
    top1 = idx[:, 0]
    for fn, args in (
            ("number_count", (top1, 4)), ("number_count", (idx, 4)),
            ("position_in_expert", (top1, 4)),
            ("limit_by_capacity", (np.asarray([5, 1, 3, 0], np.int32), 2)),
            ("limit_by_capacity", (np.asarray([5, 1, 3, 0], np.int32),
                                   np.asarray([1, 2, 3, 4], np.int32))),
            ("prune_gate_by_capacity", (top1, np.asarray([2, 1, 5, 0],
                                                         np.int32), 4)),
            ("random_routing", (idx, probs, np.linspace(
                0, 1, 24).astype(np.float32)))):
        want = getattr(RM, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args))
        got = getattr(TM, fn)(*(torch.from_numpy(a)
                                if isinstance(a, np.ndarray) else a
                                for a in args))
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=fn)


def test_reference_capacity_examples():
    """The reference tests' hand examples (``test_moe.py:22-49``)."""
    np.testing.assert_array_equal(
        _np(TM.number_count(torch.tensor([0, 2, 2, 1, 2, 0]), 4)),
        [2, 1, 3, 0])
    np.testing.assert_array_equal(
        _np(TM.prune_gate_by_capacity(torch.tensor([0, 0, 0, 1, 1, 2]),
                                      torch.tensor([2, 1, 5]), 3)),
        [0, 0, -1, 1, -1, 2])
    out = TM.random_routing(torch.tensor([[0, 1], [2, 3], [1, 0]]),
                            torch.tensor([[0.9, 0.4], [0.8, 0.05],
                                          [0.6, 0.3]]),
                            torch.tensor([0.5, 0.5, 0.7]))
    np.testing.assert_array_equal(_np(out), [[0, 1], [2, -1], [1, -1]])


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_masks_match_the_reference(seed):
    idx, probs, x = _routing(seed)
    E, C = 4, 5
    ji, jp, jx = (jnp.asarray(a) for a in (idx, probs, x))
    ti, tp, tx = (torch.from_numpy(a) for a in (idx, probs, x))
    for a, b in zip(RM.dispatch_combine_masks(ji[:, 0], jp[:, 0], E, C),
                    TM.dispatch_combine_masks(ti[:, 0], tp[:, 0], E, C)):
        np.testing.assert_allclose(_np(b), np.asarray(a), **EXACT)
    for a, b in zip(RM.dispatch_masks_topk(ji, E, C),
                    TM.dispatch_masks_topk(ti, E, C)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    rd, rc = RM.dispatch_combine_topk(ji, jp, E, C)
    td, tc = TM.dispatch_combine_topk(ti, tp, E, C)
    np.testing.assert_allclose(_np(td), np.asarray(rd), **EXACT)
    np.testing.assert_allclose(_np(tc), np.asarray(rc), **EXACT)
    np.testing.assert_allclose(_np(TM.moe_dispatch(tx, td)),
                               np.asarray(RM.moe_dispatch(jx, rd)), **EXACT)
    eo = np.random.RandomState(seed + 5).randn(E, C, 8).astype(np.float32)
    np.testing.assert_allclose(
        _np(TM.moe_combine(torch.from_numpy(eo), tc)),
        np.asarray(RM.moe_combine(jnp.asarray(eo), rc)), **EXACT)


def test_index_dispatch_matches_mask_dispatch():
    """The joint top-K capacity order: the index routes equal the
    reference's, and the index dispatch/combine equal the mask
    einsums (``test_moe.py:281``)."""
    idx, probs, x = _routing()
    E, C = 4, 5
    ti, tp, tx = (torch.from_numpy(a) for a in (idx, probs, x))
    for (rf, ro), (tf, to) in zip(RM.dispatch_indices_topk(jnp.asarray(idx),
                                                           E, C),
                                  TM.dispatch_indices_topk(ti, E, C)):
        np.testing.assert_array_equal(_np(tf), np.asarray(rf))
        np.testing.assert_array_equal(_np(to), np.asarray(ro))
    routes = TM.dispatch_indices_topk(ti, E, C)
    masks = TM.dispatch_masks_topk(ti, E, C)
    np.testing.assert_allclose(
        _np(TM.moe_dispatch_indices(tx, routes, E, C)),
        _np(torch.einsum("nec,nd->ecd", sum(masks), tx)), rtol=1e-6)
    eo = torch.from_numpy(np.random.RandomState(1).randn(E, C, 8).astype(
        np.float32))
    comb = sum(m * tp[:, k][:, None, None] for k, m in enumerate(masks))
    np.testing.assert_allclose(
        _np(TM.moe_combine_indices(eo, routes, tp)),
        _np(torch.einsum("nec,ecd->nd", comb, eo)), **EXACT)


def test_gather_dispatch_and_its_gradients_match_the_reference():
    """``dispatch_plan`` exactly, and the gather dispatch/combine values
    and gradients (x, probs, an expert weight) against the reference's
    custom VJPs (``test_moe.py:312``)."""
    rng = np.random.RandomState(1)
    N, E, C, d, K = 24, 4, 5, 8, 2
    idx = rng.randint(-1, E, (N, K)).astype(np.int32)
    probs = rng.rand(N, K).astype(np.float32)
    x = rng.randn(N, d).astype(np.float32)
    cot = rng.randn(N, d).astype(np.float32)
    w = rng.randn(d, d).astype(np.float32)
    r_routes = RM.dispatch_indices_topk(jnp.asarray(idx), E, C)
    r_plan = RM.dispatch_plan(r_routes, E, C, N)
    t_routes = TM.dispatch_indices_topk(torch.from_numpy(idx), E, C)
    t_plan = TM.dispatch_plan(t_routes, E, C, N)
    for a, b in zip(r_plan, t_plan):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    tfs, cfs, flats, oks = r_plan

    def ref(xv, pv, wv):
        slots = RM.moe_dispatch_gather(xv, tfs, flats, oks, E, C)
        eo = jnp.tanh(slots @ wv)
        return jnp.sum(RM.moe_combine_gather(eo, pv, flats, oks, tfs, cfs)
                       * jnp.asarray(cot))
    val, grads = jax.value_and_grad(ref, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(probs), jnp.asarray(w))
    tx, tpv, tw = (torch.tensor(a, requires_grad=True) for a in (x, probs, w))
    tt, tc, tfl, tok = t_plan
    slots = TM.moe_dispatch_gather(tx, tt, tfl, tok, E, C)
    out = TM.moe_combine_gather(torch.tanh(slots @ tw), tpv, tfl, tok, tt,
                                tc)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(val), rtol=1e-5)
    for t, g in zip((tx, tpv, tw), grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), **EP_TOL)


def _skewed_logits(rs, T, E, hot=(0, 1), hot_frac=0.9):
    logits = rs.randn(T, E).astype(np.float32)
    for i in range(int(T * hot_frac)):
        logits[i, hot[i % len(hot)]] += 8.0
    return logits


def test_capacity_drop_accounting_under_skew():
    """~90 % of the tokens on two experts, capacity 6: each expert keeps
    min(routed, C), and a dropped route adds exactly 0 (identity
    experts give x·Σ of the kept probabilities), as in
    ``test_moe_skew.py:28``; the kept slots are the reference's."""
    rs = np.random.RandomState(0)
    T, E, C, D = 64, 8, 6, 4
    logits = _skewed_logits(rs, T, E)
    gate_prob, gate_idx = TM._top_k(torch.softmax(torch.from_numpy(logits),
                                                  -1), 2)
    routes = TM.dispatch_indices_topk(gate_idx.to(torch.int32), E, C)
    tfs, cfs, flats, oks = TM.dispatch_plan(routes, E, C, T)
    kept = (_np(tfs).reshape(E, C) >= 0).sum(axis=1)
    counts = np.bincount(_np(gate_idx).reshape(-1), minlength=E)
    np.testing.assert_array_equal(kept, np.minimum(counts, C))
    assert kept[0] == C and kept[1] == C and counts[0] > C
    rp, ri = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), 2)
    r_tfs = RM.dispatch_plan(RM.dispatch_indices_topk(ri, E, C), E, C, T)[0]
    np.testing.assert_array_equal(_np(tfs), np.asarray(r_tfs))
    x = torch.from_numpy(rs.randn(T, D).astype(np.float32))
    slots = TM.moe_dispatch_gather(x, tfs, flats, oks, E, C)
    out = _np(TM.moe_combine_gather(slots, gate_prob, flats, oks, tfs, cfs))
    ok, gp = _np(oks), _np(gate_prob)
    for t in range(T):
        w = sum(float(gp[t, k]) for k in range(2) if ok[t, k])
        np.testing.assert_allclose(out[t], _np(x[t]) * w, rtol=1e-5,
                                   atol=1e-6)


def test_empty_experts_stay_finite_with_zero_gradient():
    """Every token on expert 0 (``test_moe_skew.py:74``): the others run
    on empty slots, forward and gradients finite, and their weights'
    gradients exactly 0."""
    rs = np.random.RandomState(1)
    T, E, C, D, FF = 32, 8, 32, 4, 8
    logits = np.full((T, E), -10.0, np.float32)
    logits[:, 0] = 10.0
    x = torch.tensor(rs.randn(T, D).astype(np.float32), requires_grad=True)
    w1 = torch.tensor((rs.randn(E, D, FF) * 0.3).astype(np.float32),
                      requires_grad=True)
    w2 = torch.tensor((rs.randn(E, FF, D) * 0.3).astype(np.float32),
                      requires_grad=True)
    gp, gi = TM._top_k(torch.softmax(torch.from_numpy(logits), -1), 2)
    tfs, cfs, fl, ok = TM.dispatch_plan(
        TM.dispatch_indices_topk(gi.to(torch.int32), E, C), E, C, T)
    slots = TM.moe_dispatch_gather(x, tfs, fl, ok, E, C)
    h = torch.nn.functional.gelu(torch.einsum("ecd,edf->ecf", slots, w1))
    y = torch.einsum("ecf,efd->ecd", h, w2)
    loss = (TM.moe_combine_gather(y, gp, fl, ok, tfs, cfs) ** 2).sum()
    loss.backward()
    assert torch.isfinite(loss)
    for t in (x, w1, w2):
        assert torch.isfinite(t.grad).all()
    assert float(w1.grad[2:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# gates and the layer, one process
# ---------------------------------------------------------------------------

def _expert(pkg, d):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(d, 2 * d), nn.GELU(), nn.Linear(2 * d, d))


def _state(layer):
    return {k: _np(v).copy() for k, v in layer.state_dict().items()}


def _pair(make):
    """The reference's layer and the port's with its weights."""
    ref = make(J, RMOE)
    port = make(TP, TMOE)
    port.set_state_dict(_state(ref))
    return ref, port


def test_uniform_draws_are_the_references_bit_for_bit():
    """The draws the GShard and Switch gates make: ``uniform(key, (n,))``
    and the jitter's ``uniform(key, shape, 1 - eps, 1 + eps)``."""
    from paddle_tpu import random as JR
    from paddle_tpu_torch import random as TR
    for shape, lo, hi in (((37,), 0.0, 1.0), ((16, 8), 0.9, 1.1)):
        J.seed(21)
        TP.seed(21)
        want = jax.random.uniform(JR.next_key(), shape, minval=lo,
                                  maxval=hi)
        got = TR.uniform_draw(TR.next_key(), shape, lo, hi)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("gate,training", [
    ("naive", True), ("gshard", True), ("gshard", False), ("switch", True),
    ("switch", False)])
def test_gates_match_the_reference(gate, training):
    """Indices (capacity pruning, random routing, jitter) bit for bit,
    probabilities and ``l_aux`` at rtol 1e-5."""
    d, E = 8, 4

    def make(pkg, M):
        pkg.seed(0)
        cls = {"naive": M.NaiveGate, "gshard": M.GShardGate,
               "switch": M.SwitchGate}[gate]
        kw = {"capacity": (0.6, 0.8)} if gate != "naive" else {}
        g = cls(d, E, **kw)
        if not training:
            g.eval()
        return g
    ref, port = _pair(make)
    x = np.random.RandomState(0).randn(40, d).astype(np.float32)
    J.seed(5)
    TP.seed(5)
    ri, rv = ref(J.to_tensor(x))
    ti, tv = port(TP.to_tensor(x))
    np.testing.assert_array_equal(_np(ti), _np(ri))
    np.testing.assert_allclose(_np(tv), _np(rv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(port.l_aux), float(ref.l_aux),
                               rtol=1e-5, atol=1e-7)
    if gate != "naive":
        cap = ref.capacity(40, 0.6 if training else 0.8)
        for e in range(E):
            assert (_np(ti) == e).sum() <= cap


def _layer(gate, topk=None, cap=(1.2, 2.4), E=4, d=8, rr=True):
    def make(pkg, M):
        pkg.seed(0)
        return M.MoELayer(d, [_expert(pkg, d) for _ in range(E)], gate=gate,
                          topk=topk, capacity_factor=cap, random_routing=rr)
    return make


@pytest.mark.parametrize("gate,topk,cap", [
    ("naive", 1, (100.0, 100.0)), ("naive", 2, (1.2, 2.4)),
    ("gshard", None, (1.2, 2.4)), ("gshard", None, (0.5, 0.5)),
    ("switch", None, (1.2, 2.4))])
def test_moe_layer_forward_and_gradients_match(gate, topk, cap):
    """The gather path in training mode (GShard's random routing and
    Switch's jitter from the key stream): output, ``l_aux``, and the
    gradients of ``sum(y·g) + 0.01·l_aux`` for the input and every
    parameter (gate included)."""
    ref, port = _pair(_layer(gate, topk, cap))
    rng = np.random.RandomState(3)
    x = rng.randn(32, 8).astype(np.float32)
    g = rng.randn(32, 8).astype(np.float32)
    outs = []
    for pkg, layer in ((J, ref), (TP, port)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        pkg.seed(9)
        y = layer(xt)
        loss = (y * pkg.to_tensor(g)).sum() + 0.01 * layer.l_aux
        loss.backward()
        outs.append((_np(y), float(layer.l_aux), _np(xt.grad),
                     [_np(p.grad) for p in layer.parameters()]))
    (ry, ra, rdx, rg), (ty, ta, tdx, tg) = outs
    np.testing.assert_allclose(ty, ry, **LAYER_TOL)
    np.testing.assert_allclose(ta, ra, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tdx, rdx, **LAYER_TOL)
    for a, b in zip(rg, tg):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, **LAYER_TOL)


def test_naive_top1_is_the_gate_prob_times_the_expert():
    """Top-1 keeps Switch's y = p(x)·E(x) (``test_moe.py:83``), computed
    here by hand from the port's own experts."""
    d, E = 8, 4
    _, port = _pair(_layer("naive", 1, (100.0, 100.0)))
    port.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(16, d).astype(
        np.float32))
    out = port(x)
    probs = torch.softmax(x @ port.gate.gate, -1)
    choice = probs.argmax(-1)
    want = torch.stack([probs[t, choice[t]] * port.experts[int(choice[t])](
        x[t:t + 1])[0] for t in range(16)])
    np.testing.assert_allclose(_np(out), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("gate", ["gshard", "switch", "naive"])
def test_moe_layer_trains_as_the_reference(gate):
    """Adam on the layer and a head for 8 steps (``test_moe.py:108``):
    the losses are the reference's and fall."""
    d, E = 8, 4
    rng = np.random.RandomState(0)
    xs = rng.randn(32, d).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(np.int64)
    losses = []
    for pkg, M in ((J, RMOE), (TP, TMOE)):
        pkg.seed(0)
        layer = M.MoELayer(d, [_expert(pkg, d) for _ in range(E)], gate=gate,
                           random_routing=False)
        head = pkg.nn.Linear(d, 2)
        if pkg is TP:
            layer.set_state_dict(ref_state)
            head.set_state_dict(head_state)
        else:
            ref_state, head_state = _state(layer), _state(head)
        opt = pkg.optimizer.Adam(learning_rate=0.01,
                                 parameters=layer.parameters()
                                 + head.parameters())
        run = []
        for _ in range(8):
            out = head(layer(pkg.to_tensor(xs)))
            loss = pkg.nn.CrossEntropyLoss()(out, pkg.to_tensor(ys))
            if gate != "naive":
                loss = loss + 0.01 * layer.l_aux
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(float(loss))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=1e-6)
    assert losses[1][-1] < losses[1][0]


def test_expert_aware_clip_matches_the_reference():
    """Without a group the clip is the global norm over both kinds:
    the reference's clipped gradients; expert parameters are tagged."""
    ref, port = _pair(_layer("naive", E=2, d=4))
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    got = []
    for pkg, M, layer in ((J, RMOE, ref), (TP, TMOE, port)):
        layer(pkg.to_tensor(x)).mean().backward()
        clip = M.ClipGradForMOEByGlobalNorm(clip_norm=0.05)
        if pkg is J:
            pg = [(p, p._grad_value) for p in layer.parameters()]
        else:
            pg = [(p, p.grad) for p in layer.parameters()]
        got.append([_np(g) for _, g in clip(pg)])
        assert all(getattr(p, "expert", False)
                   for p in layer.experts.parameters())
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


def test_global_scatter_and_gather_match_the_reference():
    rng = np.random.RandomState(4)
    counts = np.asarray([3, 0, 5, 2], np.int32)
    x = rng.randn(int(counts.sum()), 6).astype(np.float32)
    rs = RMOE.global_scatter(J.to_tensor(x), J.to_tensor(counts), None)
    ts = TMOE.global_scatter(TP.to_tensor(x), TP.to_tensor(counts), None)
    np.testing.assert_allclose(_np(ts), _np(rs), **EXACT)
    rg = RMOE.global_gather(rs, J.to_tensor(counts), None)
    tg = TMOE.global_gather(ts, TP.to_tensor(counts), None)
    np.testing.assert_allclose(_np(tg), _np(rg), **EXACT)
    np.testing.assert_allclose(_np(tg), x, **EXACT)


# ---------------------------------------------------------------------------
# expert parallelism over 2 and 4 gloo ranks
# ---------------------------------------------------------------------------

class _RefSingle(J.nn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = J.nn.Linear(d, d)

    def forward(self, x):
        return self.fc(x)


#: name -> (gate, topk, capacity factor, experts, training, random
#: routing, clip norm, gate bias (skew))
LAYERS = {
    "naive_ample": ("naive", 2, (100.0, 100.0), "ffn", True, True, None,
                    None),
    "gshard": ("gshard", None, (1.2, 2.4), "ffn", True, True, 0.05, None),
    "gshard_eval": ("gshard", None, (1.2, 2.4), "ffn", False, True, None,
                    None),
    "switch": ("switch", None, (1.2, 2.4), "ffn", True, True, None, None),
    "gshard_skew": ("gshard", None, (1.0, 1.0), "ffn", True, False, None,
                    (4.0, 3.5)),
    "single_gather": ("gshard", None, (1.2, 2.4), "single", True, True,
                      None, None),
}


def _ref_layer(name, n):
    gate, topk, cap, kind, training, rr, _, skew = LAYERS[name]
    d, E = 8, 8
    J.seed(0)
    experts = [_expert(J, d) if kind == "ffn" else _RefSingle(d)
               for _ in range(E)]
    mesh = rmesh.build_mesh({"dp": n}, devices=jax.devices()[:n])
    rmesh.set_global_mesh(mesh)
    layer = RMOE.MoELayer(d, experts, gate=gate, topk=topk,
                          capacity_factor=cap, random_routing=rr,
                          moe_group=RC.Group("dp", mesh))
    if skew is not None:
        v = np.asarray(layer.gate.gate._value).copy()
        v[:, 0] += skew[0]
        v[:, 1] += skew[1]
        layer.gate.gate.set_value(v)
    if not training:
        layer.eval()
    return layer


def _layer_inputs(name):
    rng = np.random.RandomState(sorted(LAYERS).index(name))
    return (rng.randn(64, 8).astype(np.float32),
            rng.randn(64, 8).astype(np.float32))


FFN = {"ffn_top1": 1, "ffn_top2_skew": 2}


def _ffn_inputs(name):
    rs = np.random.RandomState(2)
    E, D, FF, T = 8, 4, 16, 64
    x = rs.randn(T, D).astype(np.float32)
    logits = _skewed_logits(rs, T, E)
    w1 = (rs.randn(E, D, FF) * 0.3).astype(np.float32)
    w2 = (rs.randn(E, FF, D) * 0.3).astype(np.float32)
    return x, logits, w1, w2, (T if FFN[name] == 1 else 6), FFN[name]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    res = {}
    try:
        for n in WORLDS:
            layers = {}
            for name, (gate, topk, cap, kind, training, rr, clip,
                       _) in LAYERS.items():
                x, g = _layer_inputs(name)
                layers[name] = dict(
                    d=8, E=8, expert=kind, gate=gate, topk=topk, cap=cap,
                    rr=rr, training=training,
                    state=_state(_ref_layer(name, n)), x=x, g=g, coef=0.01,
                    seed=9, clip=clip)
            ffn = {k: _ffn_inputs(k) for k in FFN}
            out = tmp_path_factory.mktemp(f"moe{n}")
            ctx = spawn(W.moe_scenarios, args=(str(out), layers, ffn),
                        nprocs=n, join=False, env={"OMP_NUM_THREADS": "1"})
            try:
                assert ctx.join(timeout=180), f"the {n}-rank job failed"
            finally:
                ctx.terminate()
            ranks = []
            for r in range(n):
                with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
            res[n] = ranks
    finally:
        rmesh.set_global_mesh(None)
    return res


def _reference_run(name, n):
    layer = _ref_layer(name, n)
    try:
        x, g = _layer_inputs(name)
        xt = J.to_tensor(x, stop_gradient=False)
        J.seed(9)
        y = layer(xt)
        loss = (y * J.to_tensor(g)).sum() + 0.01 * n * layer.l_aux
        loss.backward()
        named = list(layer.named_parameters())
        res = dict(out=_np(y), dx=_np(xt.grad), aux=float(layer.l_aux),
                   ep=layer._ep_parts is not None,
                   grads={k: _np(p.grad) for k, p in named})
        clip = LAYERS[name][6]
        if clip:
            c = RMOE.ClipGradForMOEByGlobalNorm(clip)
            res["clipped"] = {k: _np(g2) for (k, _), (_, g2) in zip(
                named, c([(p, p._grad_value) for _, p in named]))}
        return res
    finally:
        rmesh.set_global_mesh(None)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_expert_parallel_layer_matches_the_reference(jobs, n, name):
    """Rows of the output and of dx concatenated, gradients summed over
    the ranks, ``l_aux`` averaged: the reference's expert-parallel
    layer (its gather path for experts that are not Linear → GELU →
    Linear)."""
    want = _reference_run(name, n)
    ranks = [r[name] for r in jobs[n]]
    assert all(r["ep"] == want["ep"] for r in ranks)
    assert want["ep"] == (LAYERS[name][3] == "ffn")
    np.testing.assert_allclose(np.concatenate([r["out"] for r in ranks]),
                               want["out"], **EP_TOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]),
                               want["dx"], **EP_TOL)
    np.testing.assert_allclose(np.mean([r["aux"] for r in ranks]),
                               want["aux"], rtol=1e-5, atol=1e-7)
    for k, v in want["grads"].items():
        got = sum(r["grads"][k] for r in ranks)
        np.testing.assert_allclose(got, v, err_msg=k, **EP_TOL)
    if "clipped" in want:
        for k, v in want["clipped"].items():
            parts = [r["clipped"][k] for r in ranks]
            expert = ".experts." in f".{k}"
            got = sum(parts) if expert else parts[0]
            np.testing.assert_allclose(got, v, err_msg=k, **EP_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_expert_parallel_layer_drops_under_skew(jobs, n):
    """Under the skewed gate the capacity drops tokens on the reference
    side too: some outputs are exactly 0 rows of the experts' sum, and
    the port's rows are the reference's (checked above); here the drop
    is real."""
    want = _reference_run("gshard_skew", n)
    y = np.concatenate([r["gshard_skew"]["out"] for r in jobs[n]])
    assert np.isfinite(y).all()
    assert (np.abs(want["out"]).sum(axis=1) == 0).any()


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(FFN))
def test_expert_parallel_ffn_matches_the_reference(jobs, n, name):
    """``expert_parallel_ffn`` over an expert axis: the reference's
    shard_map (``test_moe.py:192``, top-1 ample; ``test_moe_skew.py:107``,
    top-2 under skew with drops)."""
    x, logits, w1, w2, cap, topk = _ffn_inputs(name)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("expert",))
    f = jax.jit(shard_map(
        lambda xl, lg, a, b: RM.expert_parallel_ffn(
            xl, lg, a, b, "expert", num_experts=w1.shape[0], capacity=cap,
            topk=topk),
        mesh=mesh, in_specs=(P("expert"),) * 4, out_specs=P("expert"),
        check_vma=False))
    want = np.asarray(f(x, logits, w1, w2))
    got = np.concatenate([r[name] for r in jobs[n]])
    np.testing.assert_allclose(got, want, **SKEW_TOL)


def test_workers_import_neither_jax_nor_the_reference(jobs):
    for n, ranks in jobs.items():
        assert all(r["imports"] == [] for r in ranks), n
