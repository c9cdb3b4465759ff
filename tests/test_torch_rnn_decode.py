"""``paddle_tpu_torch.nn.rnn`` and ``nn.decode`` against the JAX package
on the CPU: ``SimpleRNN`` / ``LSTM`` / ``GRU`` at every ``direction``,
``time_major`` and ``sequence_length`` (outputs, final states and the
gradients of the inputs and weights), inter-layer dropout under one
seed, the cells and the ``RNN`` wrapper, beam search and ``gather_tree``
with the reference's ids, and the reference's own beam-search scenarios
(``tests/test_beam_search.py``) run through the port. fp32."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

import torch_scenarios

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


R = np.random.RandomState(0)
X = R.randn(3, 5, 4).astype(np.float32)            # (batch, time, in)
LENS = np.array([5, 2, 4], np.int32)


@pytest.mark.parametrize("kind", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True], ids=["bm", "tm"])
@pytest.mark.parametrize("seq", [False, True], ids=["full", "lens"])
def test_rnn_layers(kind, direction, time_major, seq):
    res = []
    for pkg in (J, TP):
        pkg.seed(6)
        layer = getattr(pkg.nn, kind)(4, 6, num_layers=2, direction=direction,
                                      time_major=time_major)
        x = pkg.to_tensor(X.transpose(1, 0, 2).copy() if time_major else X,
                          stop_gradient=False)
        kw = dict(sequence_length=pkg.to_tensor(LENS)) if seq else {}
        out, final = layer(x, **kw)
        (out.sum() + sum(f.sum() for f in _flat(final))).backward()
        res.append(([_np(out)] + [_np(f) for f in _flat(final)],
                    [_np(x.grad)] + [_np(p.grad) for p in layer.parameters()],
                    [n for n, _ in layer.named_parameters()]))
    (ro, rg, rn), (po, pg, pn) = res
    assert pn == rn
    for r, p in zip(ro + rg, po + pg):
        np.testing.assert_allclose(p, r, **TOL)


@pytest.mark.parametrize("kind", ["SimpleRNN", "LSTM", "GRU"])
def test_initial_states_and_inter_layer_dropout(kind):
    res = []
    for pkg in (J, TP):
        pkg.seed(7)
        layer = getattr(pkg.nn, kind)(4, 6, num_layers=3, dropout=0.4)
        h0 = pkg.to_tensor(R.randn(3, 3, 6).astype(np.float32) if not res
                           else res[0][2])
        init = (h0, h0 * 0.5) if kind == "LSTM" else h0
        out, _ = layer(pkg.to_tensor(X), init)
        res.append((_np(out), pkg.get_rng_state()[0], _np(h0)))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    assert res[1][1] == res[0][1]


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("reverse", [False, True])
def test_cells_and_the_rnn_wrapper(cell, reverse):
    res = []
    for pkg in (J, TP):
        pkg.seed(9)
        c = getattr(pkg.nn, cell)(4, 5)
        x = pkg.to_tensor(X[:, 0])
        y, st = c(x)
        wrap = pkg.nn.RNN(c, is_reverse=reverse)
        out, final = wrap(pkg.to_tensor(X))
        res.append([_np(v) for v in [y] + _flat(st) + [out] + _flat(final)])
    for r, p in zip(*res):
        np.testing.assert_allclose(p, r, **TOL)


def _gru_decoder(pkg, beam, vocab=9, hidden=8):
    pkg.seed(12)
    nn = pkg.nn
    cell, emb, proj = nn.GRUCell(5, hidden), nn.Embedding(vocab, 5), \
        nn.Linear(hidden, vocab)
    return nn.BeamSearchDecoder(cell, start_token=0, end_token=vocab - 1,
                                beam_size=beam, embedding_fn=emb,
                                output_fn=proj)


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_matches_the_reference(beam, time_major):
    h0 = R.randn(2, 8).astype(np.float32)
    res = []
    for pkg in (J, TP):
        dec = _gru_decoder(pkg, beam)
        outs, final, lens = pkg.nn.dynamic_decode(
            dec, inits=pkg.to_tensor(h0), max_step_num=6,
            output_time_major=time_major, return_length=True)
        res.append((_np(outs), _np(final.log_probs), _np(lens),
                    _np(final.finished)))
    for r, p in zip(*res):
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, **TOL)
        else:
            np.testing.assert_array_equal(p, r)


def test_gather_tree_and_tiling():
    ids = R.randint(0, 7, (5, 2, 3)).astype(np.int32)
    parents = R.randint(0, 3, (5, 2, 3)).astype(np.int32)
    x = R.randn(2, 4).astype(np.float32)
    out = []
    for pkg in (J, TP):
        out.append((_np(pkg.nn.functional.gather_tree(
            pkg.to_tensor(ids), pkg.to_tensor(parents))),
            _np(pkg.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
                pkg.to_tensor(x), 3))))
    for r, p in zip(*out):
        np.testing.assert_array_equal(p, r)


#: the reference's scenarios that compile the decode with ``jax.jit`` (the
#: port's decode is a loop) and that read the cell's weights through the
#: reference's ``Parameter._value`` (a layer's parameter is a torch leaf
#: here): the port's counterparts follow
BEAM_SKIP = {"TestBeamSearch.test_under_jit",
             "TestBeamSearch.test_matches_numpy_oracle"}


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_beam_search.py", BEAM_SKIP))
def test_beam_search_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_beam_search.py", scenario, request)


def test_beam_search_matches_the_numpy_oracle_in_the_port():
    """The reference scenario's own numpy beam search over the port's
    weights."""
    mod = torch_scenarios.port_module("test_beam_search.py")
    vocab, hidden, beam, steps = 7, 12, 3, 5
    cell, embedding, proj, rs = mod.TestBeamSearch()._make(vocab, hidden)
    h0 = rs.randn(2, hidden).astype(np.float32)
    dec = TP.nn.BeamSearchDecoder(cell, start_token=0, end_token=vocab - 1,
                                  beam_size=beam, embedding_fn=embedding,
                                  output_fn=proj)
    outs, final = TP.nn.dynamic_decode(dec, inits=TP.to_tensor(h0),
                                       max_step_num=steps)
    ids, scores = _np(outs), _np(final.log_probs)
    cp = [_np(p) for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                           cell.bias_hh)]
    for b in range(2):
        seqs, want = mod._np_beam_search(
            cp, _np(embedding.weight), _np(proj.weight).T, _np(proj.bias),
            h0[b], 0, vocab - 1, beam, steps)
        for k in range(beam):
            np.testing.assert_array_equal(ids[b, :, k], seqs[k])
            np.testing.assert_allclose(scores[b, k], want[k], rtol=2e-4)


def test_decode_is_deterministic_in_the_port():
    h0 = R.randn(2, 8).astype(np.float32)
    runs = [_np(TP.nn.dynamic_decode(_gru_decoder(TP, 2),
                                     inits=TP.to_tensor(h0),
                                     max_step_num=4)[0]) for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
