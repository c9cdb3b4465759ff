"""Transformer-base machine translation, written once against the Paddle
surface, as ``scripts/eager_llama_step.py`` is.

The same code runs with either package; only the import differs:

    S = surface("paddle_tpu")          # the JAX package
    S = surface("paddle_tpu_torch")    # the PyTorch/CUDA port

It holds PaddleNLP's Transformer recipe for WMT14 en-de
(``examples/machine_translation/transformer/configs/transformer.base.yaml``:
``vocab_all.bpe.33708`` padded by ``pad_factor: 8`` to 33 712 tokens,
``weight_sharing: True``, ``batch_size: 4096`` tokens, ``max_length: 256``)
on the high-level API, and its LSTM seq2seq with attention for IWSLT'15
en-vi (``examples/machine_translation/seq2seq``) under beam search:

* :func:`build_model` — ``TransformerMT``: shared source and target word
  embeddings (``Normal(0, d_model**-0.5)`` through a ``ParamAttr``) scaled
  by √d_model, sinusoid position encodings, ``nn.Transformer`` post-LN
  and the output projection tied to the embedding
  (``matmul(..., transpose_y=True)``);
* :func:`criterion` — PaddleNLP's ``CrossEntropyCriterion``: label
  smoothing 0.1 over ``one_hot`` labels, soft-label cross-entropy,
  padding weighted out, summed and divided by the token count;
* :func:`make_optimizer` — ``NoamDecay(d_model, 4000, 2.0)`` and
  ``Adam(0.9, 0.997, 1e-9)``;
* :func:`make_loader` — seeded synthetic sentence pairs, bucketed by
  target tokens and padded to each batch's longest sentence;
* :func:`train` — ``paddle.Model(net).prepare(opt, criterion).fit(...)``
  with ``ModelCheckpoint(save_freq=1)`` and ``LRScheduler(by_step=True)``;
* :func:`greedy_decode` — incremental decoding through the decoder's
  ``gen_cache`` (``Cache`` / ``StaticCache``), a fixed number of steps;
* :func:`build_seq2seq` and :func:`beam_search` — the LSTM encoder, a
  decoder cell of two ``LSTMCell``s with dot-product attention, and
  ``BeamSearchDecoder`` + ``dynamic_decode``.

Weights come from ``paddle.seed``; data are token ids from a seed. No
file is downloaded. ``tests/test_torch_transformer_mt.py`` runs it
through both packages; ``chip_smoke.py`` (phase 33) runs it on the card.
"""

from __future__ import annotations

import importlib
import types

import numpy as np

BOS, EOS = 0, 1          # PaddleNLP's bos_id (also the padding id) and eos_id

#: Transformer-base for WMT14 en-de (PaddleNLP transformer.base.yaml)
BASE = dict(vocab=33712, d_model=512, nhead=8, n_enc=6, n_dec=6, d_ff=2048,
            dropout=0.1, max_length=256, max_tokens=4096)
#: the LSTM seq2seq with attention for IWSLT'15 en-vi (PaddleNLP seq2seq)
SEQ2SEQ = dict(src_vocab=17191, tgt_vocab=7709, hidden=512, num_layers=2,
               beam_size=10, max_step_num=50)
#: the tiny widths the card is held to the CPU at (and the two packages
#: to each other): d_model 64, 4 heads, 2 + 2 layers, d_ff 128, vocab 101
TINY = dict(vocab=101, d_model=64, nhead=4, n_enc=2, n_dec=2, d_ff=128,
            dropout=0.1, max_length=256, max_tokens=48)
SEQ2SEQ_TINY = dict(src_vocab=50, tgt_vocab=40, hidden=32, num_layers=2,
                    beam_size=4, max_step_num=5)


def surface(package: str) -> types.SimpleNamespace:
    """The Paddle surface of ``package``: ``paddle``, ``nn``, ``F``,
    ``optimizer``, ``io``, ``metric``, ``callbacks`` and ``jit``."""
    def sub(name):
        return importlib.import_module(f"{package}.{name}")
    return types.SimpleNamespace(
        paddle=importlib.import_module(package), nn=sub("nn"),
        F=sub("nn.functional"), optimizer=sub("optimizer"), io=sub("io"),
        metric=sub("metric"), callbacks=sub("callbacks"), jit=sub("jit"))


def sinusoid_table(n_position: int, d_model: int) -> np.ndarray:
    """PaddleNLP's ``position_encoding_init``: sin in the first half of
    the channels, cos in the second."""
    channels = d_model // 2
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    inc = np.log(10000.0) / max(channels - 1, 1)
    inv = np.exp(np.arange(channels, dtype=np.float64) * -inc)
    t = pos * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def build_model(S, cfg: dict):
    """``TransformerMT`` at ``cfg``'s widths (keys of :data:`BASE`)."""
    paddle, nn, F = S.paddle, S.nn, S.F
    d = cfg["d_model"]

    class TransformerMT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.dropout = cfg["dropout"]
            self.word_embedding = nn.Embedding(
                cfg["vocab"], d, padding_idx=BOS,
                weight_attr=paddle.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d ** -0.5)))
            self.register_buffer(
                "pos_table", paddle.to_tensor(
                    sinusoid_table(cfg["max_length"] + 1, d)),
                persistable=False)
            self.transformer = nn.Transformer(
                d_model=d, nhead=cfg["nhead"],
                num_encoder_layers=cfg["n_enc"],
                num_decoder_layers=cfg["n_dec"],
                dim_feedforward=cfg["d_ff"], dropout=cfg["dropout"],
                normalize_before=False)

        def embed(self, word, pos):
            x = self.word_embedding(word) * (d ** 0.5) + F.embedding(
                pos, self.pos_table)
            return F.dropout(x, p=self.dropout, training=self.training)

        def positions(self, word):
            s = word.shape[1]
            ar = paddle.arange(0, s, dtype="int32").reshape([1, s])
            return (word != BOS).astype("int32") * ar

        def src_bias(self, src_word):
            b, s = src_word.shape
            return ((src_word == BOS).astype("float32")
                    * -1e9).reshape([b, 1, 1, s])

        def logits(self, dec_out):
            return paddle.matmul(dec_out, self.word_embedding.weight,
                                 transpose_y=True)

        def forward(self, src_word, trg_word):
            bias = self.src_bias(src_word)
            causal = nn.Transformer.generate_square_subsequent_mask(
                trg_word.shape[1])
            out = self.transformer(
                self.embed(src_word, self.positions(src_word)),
                self.embed(trg_word, self.positions(trg_word)),
                src_mask=bias, tgt_mask=causal, memory_mask=bias)
            return self.logits(out)

    return TransformerMT()


def make_criterion(S, vocab: int, epsilon: float = 0.1):
    """PaddleNLP's ``CrossEntropyCriterion(label_smooth_eps=0.1,
    pad_idx=BOS)``: the mean over real target tokens."""
    F = S.F

    def criterion(logits, label):
        weights = (label != BOS).astype("float32")
        soft = F.label_smooth(F.one_hot(label, vocab), epsilon=epsilon)
        cost = F.cross_entropy(logits, soft, soft_label=True,
                               reduction="none")
        return (cost * weights).sum() / weights.sum()
    return criterion


def make_optimizer(S, net, d_model: int, warmup_steps: int = 4000,
                   learning_rate: float = 2.0):
    sched = S.optimizer.lr.NoamDecay(d_model=d_model,
                                     warmup_steps=warmup_steps,
                                     learning_rate=learning_rate)
    return S.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.997,
                            epsilon=1e-9, parameters=net.parameters())


def sentence_pairs(n: int, vocab: int, lo: int, hi: int, seed: int):
    """``n`` pairs of random token ids in ``[2, vocab)``, lengths drawn
    in ``[lo, hi]``."""
    rs = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        ls, lt = rs.randint(lo, hi + 1, size=2)
        pairs.append((rs.randint(2, vocab, size=ls).astype(np.int32),
                      rs.randint(2, vocab, size=lt).astype(np.int32)))
    return pairs


def token_buckets(pairs, max_tokens: int, max_length: int):
    """PaddleNLP's token batching: pairs sorted by length, packed while
    the batch's padded target tokens (sentences × longest target, BOS or
    EOS included) stay within ``max_tokens``; longer pairs are dropped."""
    order = sorted((i for i, (s, t) in enumerate(pairs)
                    if max(len(s), len(t)) + 1 <= max_length),
                   key=lambda i: (len(pairs[i][1]), len(pairs[i][0]), i))
    batches, cur, longest = [], [], 0
    for i in order:
        need = max(longest, len(pairs[i][1]) + 1)
        if cur and need * (len(cur) + 1) > max_tokens:
            batches.append(cur)
            cur, need = [], len(pairs[i][1]) + 1
        cur.append(i)
        longest = need
    if cur:
        batches.append(cur)
    return batches


def collate(samples):
    """Pad a batch of (src, tgt) to its longest sentence: the source,
    the target input ``[BOS] + tgt`` and the label ``tgt + [EOS]``."""
    b = len(samples)
    ls = max(len(s) for s, _ in samples)
    lt = max(len(t) for _, t in samples) + 1
    src = np.full((b, ls), BOS, np.int32)
    trg = np.full((b, lt), BOS, np.int32)
    lab = np.full((b, lt), BOS, np.int32)
    for i, (s, t) in enumerate(samples):
        src[i, :len(s)] = s
        trg[i, 0] = BOS
        trg[i, 1:len(t) + 1] = t
        lab[i, :len(t)] = t
        lab[i, len(t)] = EOS
    return src, trg, lab


def make_loader(S, pairs, max_tokens: int, max_length: int, batches=None):
    """An ``io.DataLoader`` over the pairs, one token bucket a batch (or
    one list of pair indices a batch, where ``batches`` gives them)."""
    class Pairs(S.io.Dataset):
        def __len__(self):
            return len(pairs)

        def __getitem__(self, i):
            return pairs[i]

    if batches is None:
        batches = token_buckets(pairs, max_tokens, max_length)
    return S.io.DataLoader(Pairs(), batch_sampler=batches,
                           collate_fn=collate)


def prepare(S, net, cfg: dict, metrics=None, jit_compile: bool = False):
    """``paddle.Model(net)`` prepared with the recipe's optimizer and
    criterion; ``jit_compile=True`` trains through the compiled step
    (``jit.TrainStep``)."""
    model = S.paddle.Model(net)
    model.prepare(make_optimizer(S, net, cfg["d_model"]),
                  make_criterion(S, cfg["vocab"]), metrics=metrics,
                  jit_compile=jit_compile)
    return model


#: the compiled run's shape buckets (``jit.ShapeBucketer``): batch rows,
#: target length (BOS/EOS included) and source length. Over the smoke's
#: 30 token buckets of 16-128-token pairs they give 5 signatures.
JIT_BUCKETS = dict(rows=(40, 64, 128), trg=(40, 64, 96, 129), src=(128,))


def bucket_batch(S, src, trg, lab, buckets=None):
    """Pad one collated batch to its bucket shape with ``BOS``, the id
    the recipe already treats as padding: a padded source position is
    masked by ``src_bias``, a padded target position comes after every
    real one under the causal mask and has weight 0 in the criterion,
    and a padded row is all padding. Returns the three arrays."""
    b = buckets or JIT_BUCKETS
    rows_trg = S.jit.ShapeBucketer({0: b["rows"], 1: b["trg"]},
                                   pad_value=BOS)
    rows_src = S.jit.ShapeBucketer({0: b["rows"], 1: b["src"]},
                                   pad_value=BOS)
    return (rows_src(np.asarray(src))[0], rows_trg(np.asarray(trg))[0],
            rows_trg(np.asarray(lab))[0])


def train(S, model, loader, save_dir, num_iters=None, callbacks=()):
    """``Model.fit`` over ``loader`` for one epoch (or ``num_iters``
    batches) with ``ModelCheckpoint(save_freq=1)`` into ``save_dir`` and
    ``LRScheduler(by_step=True)``. Returns ``fit``'s history."""
    cbs = [S.callbacks.ModelCheckpoint(save_freq=1, save_dir=save_dir),
           S.callbacks.LRScheduler(by_step=True)] + list(callbacks)
    return model.fit(loader, epochs=1, verbose=0, callbacks=cbs,
                     num_iters=num_iters)


def greedy_decode(S, net, src_word, steps: int, memory_mask: bool = True):
    """Greedy incremental decoding for ``steps`` tokens: the encoder
    once, then one token a step through the decoder's caches (the
    self-attention ``Cache`` grows, the cross-attention ``StaticCache``
    is projected once). ``memory_mask=False`` leaves the source padding
    mask out (sources of one length). Returns (B, steps) token ids."""
    paddle = S.paddle
    net.eval()
    with paddle.no_grad():
        b = src_word.shape[0]
        bias = net.src_bias(src_word) if memory_mask else None
        memory = net.transformer.encoder(
            net.embed(src_word, net.positions(src_word)), src_mask=bias)
        caches = net.transformer.decoder.gen_cache(memory)
        tok = paddle.full([b, 1], BOS, dtype="int32")
        out = []
        for t in range(steps):
            pos = paddle.full([b, 1], t, dtype="int32")
            dec, caches = net.transformer.decoder(
                net.embed(tok, pos), memory, tgt_mask=None,
                memory_mask=bias, cache=caches)
            tok = paddle.argmax(net.logits(dec), axis=-1).astype("int32")
            out.append(tok)
        return paddle.concat(out, axis=1)


def build_seq2seq(S, cfg: dict):
    """(encoder, decoder cell, target embedding, output projection) of
    the attention seq2seq at ``cfg``'s widths (keys of
    :data:`SEQ2SEQ`)."""
    paddle, nn = S.paddle, S.nn
    h = cfg["hidden"]

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedder = nn.Embedding(cfg["src_vocab"], h)
            self.lstm = nn.LSTM(h, h, num_layers=cfg["num_layers"])

        def forward(self, src):
            return self.lstm(self.embedder(src))

    class DecoderCell(nn.Layer):
        """Two LSTM cells with input feeding, then dot-product attention
        over the (beam-tiled) encoder outputs set in ``memory``."""

        def __init__(self):
            super().__init__()
            self.cells = nn.LayerList(
                [nn.LSTMCell(h + h, h), nn.LSTMCell(h, h)])
            self.input_proj = nn.Linear(h, h, bias_attr=False)
            self.output_proj = nn.Linear(h + h, h, bias_attr=False)
            self.memory = None

        def forward(self, step_input, states):
            lstm_states, input_feed = states
            x = paddle.concat([step_input, input_feed], axis=-1)
            new_states = []
            for cell, st in zip(self.cells, lstm_states):
                x, st = cell(x, st)
                new_states.append(st)
            q = self.input_proj(x).unsqueeze(1)                 # (N, 1, H)
            w = S.F.softmax(paddle.matmul(q, self.memory,
                                          transpose_y=True), axis=-1)
            ctx = paddle.matmul(w, self.memory).squeeze(1)      # (N, H)
            out = paddle.tanh(self.output_proj(
                paddle.concat([ctx, x], axis=-1)))
            return out, [new_states, out]

    return (Encoder(), DecoderCell(), nn.Embedding(cfg["tgt_vocab"], h),
            nn.Linear(h, cfg["tgt_vocab"]))


def beam_search(S, parts, src, cfg: dict, max_step_num: int):
    """``BeamSearchDecoder`` + ``dynamic_decode`` over the seq2seq:
    the encoder's final states start the decoder, its outputs are tiled
    across the beams. Returns the (batch, max_step_num, beam) ids."""
    paddle, nn = S.paddle, S.nn
    encoder, cell, embedder, proj = parts
    k = cfg["beam_size"]
    for m in parts:
        m.eval()
    with paddle.no_grad():
        enc_out, (h, c) = encoder(src)
        cell.memory = nn.BeamSearchDecoder.tile_beam_merge_with_batch(
            enc_out, k)
        states = [[(h[i], c[i]) for i in range(cfg["num_layers"])],
                  paddle.zeros([src.shape[0], cfg["hidden"]],
                               dtype="float32")]
        dec = nn.BeamSearchDecoder(cell, start_token=BOS, end_token=EOS,
                                   beam_size=k, embedding_fn=embedder,
                                   output_fn=proj)
        ids, _ = nn.dynamic_decode(dec, inits=states,
                                   max_step_num=max_step_num)
        return ids
