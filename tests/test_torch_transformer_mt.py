"""``scripts/transformer_mt.py`` through both packages on the CPU, at the
tiny widths of ``chip_smoke.py``'s phase 33 (a): d_model 64, 4 heads,
2 + 2 layers, d_ff 128, a vocabulary of 101, batches of 4 sentence
pairs. One seed builds the same weights in both (the key stream), three
``Model.fit`` steps with dropout 0.1 take the same dropout masks, and
the losses and final weights agree within ``testing.MT_FIT``; greedy
incremental decoding gives the same tokens, and beam search over the
tiny LSTM seq2seq (hidden 32, beam 4) the same ids. fp32."""

import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as TP
from paddle_tpu_torch import testing as T
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import transformer_mt as M  # noqa: E402

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _run(package, tmp):
    S = M.surface(package)
    cfg = dict(M.TINY)
    S.paddle.seed(3)
    net = M.build_model(S, cfg)
    # 12 pairs of one length: three buckets of 4 pairs
    pairs = M.sentence_pairs(12, cfg["vocab"], 8, 8, seed=0)
    loader = M.make_loader(S, pairs, 4 * 9, cfg["max_length"])
    model = M.prepare(S, net, cfg)
    losses = []

    class Rec(S.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    M.train(S, model, loader, os.path.join(tmp, package), callbacks=[Rec()])
    weights = {k: _np(v) for k, v in net.state_dict().items()}
    src = S.paddle.to_tensor(np.random.RandomState(1).randint(
        2, cfg["vocab"], (3, 7)).astype(np.int32))
    greedy = _np(M.greedy_decode(S, net, src, 5))
    S.paddle.seed(5)
    s2s = dict(M.SEQ2SEQ_TINY)
    parts = M.build_seq2seq(S, s2s)
    src2 = S.paddle.to_tensor(np.random.RandomState(2).randint(
        2, s2s["src_vocab"], (3, 9)).astype(np.int32))
    beams = _np(M.beam_search(S, parts, src2, s2s, 5))
    return losses, weights, greedy, beams, S.paddle.get_rng_state()[0]


def test_recipe_through_both_packages(tmp_path):
    rl, rw, rg, rb, rc = _run("paddle_tpu", str(tmp_path))
    pl, pw, pg, pb, pc = _run("paddle_tpu_torch", str(tmp_path))
    assert len(pl) == len(rl) == 3 and pc == rc
    np.testing.assert_allclose(pl, rl, **T.MT_FIT)
    assert list(pw) == list(rw)
    for k in rw:
        # a key bias's gradient is zero up to rounding; at these learning
        # rates Adam's noisy steps stay inside MT_FIT all the same
        np.testing.assert_allclose(pw[k], rw[k], err_msg=k, **T.MT_FIT)
    np.testing.assert_array_equal(pg, rg)
    assert pb.shape == (3, 5, 4)
    np.testing.assert_array_equal(pb, rb)


def test_token_buckets_hold_the_recipes_limits():
    pairs = M.sentence_pairs(200, 50, 16, 128, seed=4)
    buckets = M.token_buckets(pairs, 4096, 256)
    assert sorted(i for b in buckets for i in b) == list(range(200))
    for b in buckets:
        longest = max(len(pairs[i][1]) for i in b) + 1
        assert longest * len(b) <= 4096
    src, trg, lab = M.collate([pairs[i] for i in buckets[0]])
    t = pairs[buckets[0][0]][1]
    assert trg[0, 0] == M.BOS and (trg[0, 1:len(t) + 1] == t).all()
    assert lab[0, len(t)] == M.EOS and (lab[0, len(t) + 1:] == M.BOS).all()
