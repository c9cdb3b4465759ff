"""``paddle_tpu_torch.nn.transformer`` against ``paddle_tpu.nn.transformer``
on the CPU: ``MultiHeadAttention`` (self, cross, ``Cache`` growing by
concatenation, ``StaticCache``, ``need_weights``), the encoder and
decoder stacks pre-LN and post-LN with padding and causal masks, the
decoder's incremental decoding against its full pass, and a 3-step
``Model.fit`` of ``nn.Transformer`` with dropout on, whose masks are the
key stream's bits in both packages. Weights come from one seed (the
key stream) and are checked equal first. fp32."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
#: a 3-step fit: two stacks summing in other orders, through Adam
FIT = dict(rtol=1e-4, atol=1e-5)


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


def _same_weights(r, p):
    rn, pn = dict(r.named_parameters()), dict(p.named_parameters())
    assert list(pn) == list(rn)
    for k in rn:
        np.testing.assert_array_equal(_np(pn[k]), _np(rn[k]), err_msg=k)


R = np.random.RandomState(0)
Q, KV = R.randn(2, 3, 16).astype(np.float32), R.randn(2, 5, 16).astype(
    np.float32)
PAD = np.zeros((2, 1, 1, 5), np.float32)
PAD[1, ..., 3:] = -1e9


@pytest.mark.parametrize("mode", ["self", "cross", "cross_mask_kvdim",
                                  "need_weights", "bool_mask"])
def test_multi_head_attention(mode):
    outs = []
    for pkg in (J, TP):
        pkg.seed(2)
        kw = dict(kdim=16, vdim=16) if mode == "cross_mask_kvdim" else {}
        mha = pkg.nn.MultiHeadAttention(
            16, 4, need_weights=mode == "need_weights", **kw)
        q = pkg.to_tensor(Q, stop_gradient=False)
        kv = pkg.to_tensor(KV)
        if mode == "self":
            out = mha(q)
        elif mode == "bool_mask":
            out = mha(q, kv, kv, attn_mask=pkg.to_tensor(PAD == 0))
        else:
            out = mha(q, kv, kv, attn_mask=pkg.to_tensor(PAD))
        first = out[0] if isinstance(out, tuple) else out
        first.sum().backward()
        outs.append(([_np(o) for o in (out if isinstance(out, tuple)
                                       else (out,))],
                     _np(q.grad), mha))
    _same_weights(outs[0][2], outs[1][2])
    for r, p in zip(outs[0][0], outs[1][0]):
        np.testing.assert_allclose(p, r, **TOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], **TOL)


def test_caches_grow_and_static_cache_projects_once():
    got = []
    for pkg in (J, TP):
        pkg.seed(3)
        mha = pkg.nn.MultiHeadAttention(16, 4)
        mem = pkg.to_tensor(KV)
        cache = mha.gen_cache(mem, type=pkg.nn.MultiHeadAttention.Cache)
        static = mha.gen_cache(mem, mem,
                               type=pkg.nn.MultiHeadAttention.StaticCache)
        steps = []
        for t in range(3):
            x = pkg.to_tensor(Q[:, t:t + 1])
            y, cache = mha(x, x, x, cache=cache)
            z, static2 = mha(x, mem, mem, cache=static)
            assert static2 is static
            steps += [_np(y), _np(z)]
        assert list(cache.k.shape) == [2, 3, 4, 4]
        raw = mha.gen_cache(mem, mem, type=pkg.nn.MultiHeadAttention.Cache)
        assert raw.k is mem
        got.append(steps)
    for r, p in zip(*got):
        np.testing.assert_allclose(p, r, **TOL)


def _stack(pkg, before):
    pkg.seed(4)
    nn = pkg.nn
    return nn.Transformer(d_model=16, nhead=4, num_encoder_layers=2,
                          num_decoder_layers=2, dim_feedforward=24,
                          dropout=0.0, normalize_before=before)


@pytest.mark.parametrize("before", [False, True], ids=["post_ln", "pre_ln"])
def test_transformer_stacks(before):
    src = R.randn(2, 5, 16).astype(np.float32)
    tgt = R.randn(2, 4, 16).astype(np.float32)
    res = []
    for pkg in (J, TP):
        net = _stack(pkg, before)
        s = pkg.to_tensor(src, stop_gradient=False)
        mask = pkg.nn.Transformer.generate_square_subsequent_mask(4)
        out = net(s, pkg.to_tensor(tgt), src_mask=pkg.to_tensor(PAD),
                  tgt_mask=mask, memory_mask=pkg.to_tensor(PAD))
        out.sum().backward()
        res.append((_np(out), _np(s.grad), net,
                    [_np(p.grad) for p in net.parameters()]))
    _same_weights(res[0][2], res[1][2])
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)
    for r, p in zip(res[0][3], res[1][3]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-5)


def test_incremental_decoding_matches_the_full_pass():
    """One token a step through ``TransformerDecoder.gen_cache`` gives the
    causal full pass's rows, in both packages."""
    mem = R.randn(2, 5, 16).astype(np.float32)
    tgt = R.randn(2, 4, 16).astype(np.float32)
    res = []
    for pkg in (J, TP):
        dec = _stack(pkg, False).decoder
        dec.eval()
        m = pkg.to_tensor(mem)
        full = dec(pkg.to_tensor(tgt), m, tgt_mask=pkg.nn.Transformer
                   .generate_square_subsequent_mask(4))
        caches = dec.gen_cache(m)
        rows = []
        for t in range(4):
            y, caches = dec(pkg.to_tensor(tgt[:, t:t + 1]), m, cache=caches)
            rows.append(_np(y))
        zipped = dec.gen_cache(m, do_zip=True)
        assert len(zipped) == 2 and len(zipped[0]) == 2
        res.append((_np(full), np.concatenate(rows, 1)))
    for full, inc in res:
        np.testing.assert_allclose(inc, full, **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)


class _Pairs:
    """(src, tgt, label) batches of ids, one shape, from a seed."""

    def __init__(self, n, vocab=23, s=6, t=5, seed=0):
        rs = np.random.RandomState(seed)
        self.b = [(rs.randint(1, vocab, (2, s)).astype(np.int32),
                   rs.randint(1, vocab, (2, t)).astype(np.int32),
                   rs.randint(1, vocab, (2, t)).astype(np.int32))
                  for _ in range(n)]

    def __iter__(self):
        return iter(self.b)

    def __len__(self):
        return len(self.b)


def _seq2seq(pkg):
    nn, F = pkg.nn, pkg.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(23, 16)
            self.tr = nn.Transformer(16, 4, 1, 1, 24, dropout=0.2)
            self.out = nn.Linear(16, 23)

        def forward(self, src, tgt):
            mask = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            return self.out(self.tr(F.dropout(self.emb(src), 0.1,
                                              training=self.training),
                                    self.emb(tgt), tgt_mask=mask))
    return Net()


def test_three_step_fit_with_dropout_on():
    """Dropout after the embedding, on every sublayer and on the
    attention probabilities: the same masks from the same stream, so
    the losses and final weights agree."""
    res = []
    for pkg in (J, TP):
        pkg.seed(8)
        net = _seq2seq(pkg)
        model = pkg.Model(net)
        opt = pkg.optimizer.Adam(learning_rate=1e-2,
                                 parameters=net.parameters())
        model.prepare(opt, pkg.nn.CrossEntropyLoss())
        hist = []

        class Rec(pkg.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                hist.append(logs["loss"])

        model.fit(_Pairs(3), epochs=1, verbose=0, callbacks=[Rec()])
        res.append((hist, {k: _np(v) for k, v in net.state_dict().items()},
                    pkg.get_rng_state()[0]))
    (rh, rw, rc), (ph, pw, pc) = res
    assert pc == rc and len(ph) == 3
    np.testing.assert_allclose(ph, rh, **FIT)
    assert list(pw) == list(rw)
    for k in rw:
        if k.endswith("k_proj.bias"):
            # a key bias adds a constant to each query's scores, which the
            # softmax removes: its gradient is zero up to rounding, which
            # Adam scales to ±lr in either package
            continue
        np.testing.assert_allclose(pw[k], rw[k], err_msg=k, **FIT)
