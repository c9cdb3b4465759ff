"""``ops/ring_attention.py`` of ``paddle_tpu_torch`` against the
reference's (``paddle_tpu/ops/ring_attention.py``).

The reference runs its ring as one ``shard_map`` program over 4 of the
conftest's CPU devices; the port runs one gloo rank a device over 2 and
4 ranks (one spawned job a world size, workers in
``tests/torch_dist_workers.py``), each rank holding its chunk of the
sequence, and both are held to the reference's 4-device ring. Same numpy inputs (seeded),
fp32. Outputs and dQ/dK/dV, causal and not, with GQA (8 query heads over
2 KV heads), and the eager global-array entry ``ring_flash_attention``.
Tolerances are the reference's own (``tests/test_ring_attention.py``):
rtol 2e-5, atol 2e-5 for outputs; 5e-5 for gradients. The per-hop pieces
(``_merge``, the blocks of the global softmax, the case of a hop) are
held to the reference's in one process.
"""

import functools
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from paddle_tpu.core.compat import shard_map
from paddle_tpu.ops import flash_attention as rfa
from paddle_tpu.ops import ring_attention as RA
from paddle_tpu.parallel import mesh as rmesh

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.ops import ring_attention as TA
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
WORLDS = (2, 4)


def _qkv(b=2, s=32, h=4, hkv=None, d=16, seed=0):
    rng = np.random.RandomState(seed)
    hkv = hkv or h
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    g = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, g


CASES = {"causal": _qkv() + (True,),
         "full": _qkv(seed=1) + (False,),
         "gqa": _qkv(h=8, hkv=2, seed=2) + (True,),
         "gqa_full": _qkv(h=8, hkv=2, seed=3) + (False,)}
FLASH_CASES = {"flash_causal": _qkv(seed=4) + (True,),
               "flash_gqa": _qkv(h=8, hkv=2, seed=5) + (False,)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    res = {}
    for n in WORLDS:
        out = tmp_path_factory.mktemp(f"ring{n}")
        ctx = spawn(W.ring_scenarios, args=(str(out), CASES, FLASH_CASES),
                    nprocs=n, join=False, env={"OMP_NUM_THREADS": "1"})
        try:
            assert ctx.join(timeout=180), f"the {n}-rank job did not finish"
        finally:
            ctx.terminate()
        ranks = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        res[n] = ranks
    return res


def _reference(n, q, k, v, g, causal):
    """The reference's ring over ``n`` devices: the output and the
    gradients of ``sum(out * g)``. (Its result does not depend on ``n``
    beyond summation order: the reference's own tests hold its rings over
    2, 4 and 8 devices to one full-sequence attention at 2e-5.)"""
    mesh = rmesh.build_mesh({"sep": n}, devices=jax.devices()[:n])
    prog = shard_map(
        lambda a, b_, c: RA.ring_attention_array(a, b_, c, "sep",
                                                 causal=causal),
        mesh=mesh, in_specs=(P(None, "sep"),) * 3, out_specs=P(None, "sep"),
        check_vma=False)
    out, vjp = jax.vjp(prog, *(jnp.asarray(t) for t in (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(g))
    return {"out": np.asarray(out), "dq": np.asarray(dq),
            "dk": np.asarray(dk), "dv": np.asarray(dv)}


@functools.lru_cache(maxsize=None)
def _reference_4(name):
    """The reference's ring over its 4-device CPU mesh, once a case."""
    return _reference(4, *CASES[name])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_the_reference(jobs, n, name):
    """The ranks' chunks, concatenated on the sequence, are the output
    and gradients of the reference's ring on its 4-device mesh."""
    want = _reference_4(name)
    for key in ("out", "dq", "dk", "dv"):
        got = np.concatenate([r[name][key] for r in jobs[n]], axis=1)
        np.testing.assert_allclose(got, want[key], err_msg=key,
                                   **(OUT_TOL if key == "out" else GRAD_TOL))


def _whole_sequence(q, k, v, g, causal):
    """The reference's full-sequence attention (``_sdpa_array``, what its
    ``test_ring_flash_attention_eager_api`` holds the ring to): the
    output and the gradients of ``sum(out * g)``."""
    def attn(a, b_, c):
        return rfa._sdpa_array(a, b_, c, scale=1.0 / math.sqrt(q.shape[-1]),
                               causal=causal)
    out, vjp = jax.vjp(attn, *(jnp.asarray(t) for t in (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(g))
    return {"out": np.asarray(out), "dq": np.asarray(dq),
            "dk": np.asarray(dk), "dv": np.asarray(dv)}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_ring_flash_attention_gives_the_global_result(jobs, n, name):
    """Every rank passes the global arrays and gets the global output and
    gradients of the reference's full-sequence attention."""
    want = _whole_sequence(*FLASH_CASES[name])
    for r in jobs[n]:
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(
                r[name][key], want[key], err_msg=f"rank {r['rank']} {key}",
                **(OUT_TOL if key == "out" else GRAD_TOL))


def test_workers_import_neither_jax_nor_the_reference(jobs):
    for n, ranks in jobs.items():
        assert all(r["imports"] == [] for r in ranks), n


def test_ring_flash_attention_over_one_rank_is_whole_sequence_attention():
    """Without a sep group (one process) the entry is rows 5 and 6 over
    the whole sequence: the reference's ``_sdpa_array`` result."""
    q, k, v, g = _qkv(seed=6)
    tq = torch.tensor(q, requires_grad=True)
    out = TA.ring_flash_attention(tq, torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    want = rfa._sdpa_array(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale=1.0 / math.sqrt(16), causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    (out * torch.from_numpy(g)).sum().backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()


def test_merge_with_a_skipped_side_keeps_the_other():
    """A skipped block's lse is -1e30: the merge gives it weight 0, as
    the reference's does, and two skipped sides stay 0."""
    rng = np.random.RandomState(7)
    o1 = rng.randn(3, 5, 4).astype(np.float32)
    l1 = rng.randn(3, 5).astype(np.float32)
    z = np.zeros_like(o1)
    skip = np.full_like(l1, -1e30)
    for a, b_ in (((o1, l1), (z, skip)), ((z, skip), (o1, l1)),
                  ((z, skip), (z, skip))):
        got = TA._merge(*(torch.from_numpy(t) for t in a + b_))
        want = RA._merge(*(jnp.asarray(t) for t in a + b_))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("causal_blk", [False, True])
def test_blocks_of_the_global_softmax_match_the_reference(causal_blk):
    """Two blocks merged, then each block's backward from the merged
    output and the global lse (the reference's
    ``test_ring_block_bwd_matches_autodiff_of_block_fwd`` setup), GQA
    rep 2: the port's blocks (rows 5 and 6's plain versions) against the
    reference's ``_block_ref`` / ``_block_bwd``."""
    rng = np.random.RandomState(12)
    BH, S, D, rep = 4, 32, 16, 2
    q = rng.randn(BH, S, D).astype(np.float32)
    ks = [rng.randn(BH // rep, S, D).astype(np.float32) for _ in range(4)]
    g = rng.randn(BH, S, D).astype(np.float32)
    sc = 1.0 / np.sqrt(D)
    ref_o, ref_l = [], []
    for kk, vv in ((ks[0], ks[1]), (ks[2], ks[3])):
        o, l_ = RA._block_ref(jnp.asarray(q), jnp.asarray(kk),
                              jnp.asarray(vv), sc, causal_blk, rep)
        ref_o.append(o)
        ref_l.append(l_)
        po, pl = TA._block_fwd(torch.from_numpy(q), torch.from_numpy(kk),
                               torch.from_numpy(vv), sc, causal_blk, rep)
        np.testing.assert_allclose(po.numpy(), np.asarray(o), **OUT_TOL)
        np.testing.assert_allclose(pl.numpy(), np.asarray(l_), **OUT_TOL)
    out, lse = RA._merge(ref_o[0], ref_l[0], ref_o[1], ref_l[1])
    for kk, vv in ((ks[0], ks[1]), (ks[2], ks[3])):
        want = RA._block_bwd(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                             out, lse, jnp.asarray(g), sc, causal_blk, rep)
        got = TA._block_bwd(torch.from_numpy(q), torch.from_numpy(kk),
                            torch.from_numpy(vv),
                            torch.from_numpy(np.asarray(out)),
                            torch.from_numpy(np.asarray(lse)),
                            torch.from_numpy(g), sc, causal_blk, rep)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **GRAD_TOL)


def test_hop_cases_follow_global_chunk_positions():
    """src > my skips, src == my is the causal diagonal, src < my is
    full; without causality every hop is full (l.167-170)."""
    assert [TA.hop_case(1, s, True) for s in range(4)] == [
        TA.FULL, TA.DIAG, TA.SKIP, TA.SKIP]
    assert {TA.hop_case(1, s, False) for s in range(4)} == {TA.FULL}


def test_one_process_ring_equals_the_reference():
    """Every rank's hops of one 4-rank ring run in this process with a
    caller-supplied exchange that reads each hop's chunk from the
    whole-sequence tensors (the harness the card's checks use): the
    chunks are the reference ring's output and gradients."""
    q, k, v, g, causal = CASES["gqa"]
    n, b, s, h, d = 4, q.shape[0], q.shape[1], q.shape[2], q.shape[3]
    hk = k.shape[2]
    want = _reference_4("gqa")
    c = s // n

    def chunk(a, i):
        a = torch.from_numpy(a[:, i * c:(i + 1) * c])
        return a.transpose(1, 2).contiguous().reshape(-1, c, d)

    qs = [chunk(q, i) for i in range(n)]
    kvs = [(chunk(k, i), chunk(v, i)) for i in range(n)]
    gs = [chunk(g, i) for i in range(n)]
    dks = [torch.zeros(b * hk, c, d) for _ in range(n)]
    dvs = [torch.zeros(b * hk, c, d) for _ in range(n)]
    sc = 1.0 / math.sqrt(d)
    for my in range(n):
        hop = [my]

        def ex(kr, vr, _h=hop):
            _h[0] = (_h[0] - 1) % n
            return kvs[_h[0]]
        o, lse = TA.ring_forward(qs[my], *kvs[my], my, n, ex, sc, causal,
                                 h // hk)
        back = {"src": my}

        def ex_b(*ts, _b=back):
            if len(ts) == 4:          # a hop: the partials leave with it
                dks[_b["src"]] += ts[2]
                dvs[_b["src"]] += ts[3]
                _b["src"] = (_b["src"] - 1) % n
                kr, vr = kvs[_b["src"]]
                return kr, vr, torch.zeros_like(ts[2]), torch.zeros_like(
                    ts[3])
            dks[_b["src"]] += ts[0]
            dvs[_b["src"]] += ts[1]
            return ts
        dq, _, _ = TA.ring_backward(qs[my], *kvs[my], o, lse, gs[my], my, n,
                                    ex_b, sc, causal, h // hk)
        back_q = dq.reshape(b, h, c, d).transpose(1, 2).numpy()
        np.testing.assert_allclose(
            back_q, want["dq"][:, my * c:(my + 1) * c], **GRAD_TOL)
        np.testing.assert_allclose(
            o.reshape(b, h, c, d).transpose(1, 2).numpy(),
            want["out"][:, my * c:(my + 1) * c], **OUT_TOL)
    for name, parts in (("dk", dks), ("dv", dvs)):
        got = np.concatenate([p.reshape(b, hk, c, d).transpose(1, 2).numpy()
                              for p in parts], axis=1)
        np.testing.assert_allclose(got, want[name], err_msg=name, **GRAD_TOL)
