"""ERNIE/BERT MLM: the PyTorch port (``paddle_tpu_torch.models.ernie``,
its fused layers and ``optimizer.adamw``) against the JAX package's
eager model on the CPU, on the same numpy batches, with the JAX model's
weights carried across by name. The port runs its plain kernel versions
here; ``chip_smoke.py`` and tests/test_torch_gpu.py hold the card
against the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import ernie as JE
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import layer_norm_fused as tln
from paddle_tpu_torch.optimizer.adamw import AdamW
from paddle_tpu_torch.testing import key_bias_split, one_cpu_thread

one_cpu_thread()

# fp32, two layers: products, norms and softmaxes summed in other orders
# by XLA and PyTorch (test_torch_train's tolerances)
OUT = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
# gradients: the same, through the backward's longer chains of sums
GRADS = dict(rtol=1e-3, atol=1e-6)
# after 5 AdamW steps at lr 1e-3: the weights agree to a small fraction
# of one step
PARAMS = dict(rtol=1e-4, atol=2e-6)

B, S = 3, 24
CFG = dict(max_position_embeddings=32)
CFG_H = TE.ernie_tiny().hidden_size


def _np_value(a):
    return np.asarray(a._value if hasattr(a, "_value") else a)


def _batch(seed=0, vocab=128):
    """A packed batch: 2-3 sequences per row, trailing pads (-1) in two
    rows, 30 % of the real positions scored; and the same ids as a
    padded batch (pad token 0 where the packed batch has pads)."""
    rng = np.random.RandomState(seed)
    seg = np.full((B, S), -1, np.int32)
    seg[0] = np.repeat([0, 1, 2], [8, 10, 6])
    seg[1, :19] = np.repeat([0, 1], [12, 7])
    seg[2, :9] = 0
    ids = np.where(seg >= 0, rng.randint(1, vocab, (B, S)), 0).astype(
        np.int32)
    labels = np.where((rng.rand(B, S) < 0.3) & (seg >= 0), ids,
                      -100).astype(np.int64)
    return ids, seg, labels


@pytest.fixture(scope="module")
def jax_net():
    paddle.seed(0)
    return JE.ErnieForMaskedLM(JE.ernie_tiny(**CFG))


def _port_net(jnet, cls=TE.ErnieForMaskedLM):
    net = cls(TE.ernie_tiny(**CFG), device="cpu")
    TE.params_from_numpy(net, {n: _np_value(p)
                               for n, p in jnet.named_parameters()})
    return net


def _t(a):
    return torch.from_numpy(a)


def _p(a):
    return paddle.to_tensor(a)


@pytest.mark.parametrize("mode", ["padded", "packed"])
def test_model_outputs_match_jax(jax_net, mode):
    ids, seg, _ = _batch()
    net = _port_net(jax_net)
    if mode == "packed":
        want = jax_net.ernie(_p(ids), segment_ids=_p(seg))
        got = net.ernie(_t(ids), segment_ids=_t(seg))
    else:
        want = jax_net.ernie(_p(ids))
        got = net.ernie(_t(ids))
    for name, g, w in zip(("sequence", "pooled"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), _np_value(w),
                                   err_msg=name, **OUT)


@pytest.mark.parametrize("mode", ["padded", "packed"])
def test_mlm_loss_and_every_gradient_leaf_match_jax(jax_net, mode):
    """The loss and every parameter's gradient against the JAX eager
    backward, including which leaves get none: the pooler (off the loss
    path) gets ``None``, the post-LN attention's unused
    ``pre_ln_scale``/``pre_ln_bias`` get zeros."""
    ids, seg, labels = _batch(seed=1)
    kw = dict(segment_ids=seg) if mode == "packed" else {}
    for p in jax_net.parameters():
        p.clear_grad()
    want = jax_net.compute_loss(_p(ids), _p(labels),
                                **{k: _p(v) for k, v in kw.items()})
    want.backward()
    net = _port_net(jax_net)
    got = net.compute_loss(_t(ids), _t(labels),
                           **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    got.backward()
    jgrads = dict(jax_net.named_parameters())
    no_grad = set()
    for name, p in net.named_parameters():
        jg = jgrads[name].grad
        assert (p.grad is None) == (jg is None), name
        if jg is None:
            no_grad.add(name)
            continue
        np.testing.assert_allclose(p.grad.numpy(), _np_value(jg),
                                   err_msg=name, **GRADS)
    assert no_grad == {"ernie.pooler.dense.weight", "ernie.pooler.dense.bias"}
    for i in range(2):
        pre = f"ernie.encoder.{i}.self_attn.pre_ln_"
        grads = dict(net.named_parameters())
        assert not grads[pre + "scale"].grad.any()
        assert not grads[pre + "bias"].grad.any()


def test_five_adamw_steps_match_jax_eager():
    """Five packed MLM steps: the port's ``build_mlm_train_step`` against
    the JAX eager loop (``loss.backward(); AdamW.step();
    clear_grad()``), lr 1e-3, wd 0.01, from the same weights. The pooler,
    which gets no gradient, stays where it started on both sides; the
    unused pre-LN scales are decayed on both."""
    paddle.seed(3)
    jnet = JE.ErnieForMaskedLM(JE.ernie_tiny(**CFG))
    net = _port_net(jnet)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jnet.parameters(),
                     weight_decay=0.01)
    step, _ = TE.build_mlm_train_step(TE.ernie_tiny(**CFG),
                                      learning_rate=1e-3, device="cpu")
    topt = AdamW(learning_rate=1e-3, parameters=net.named_parameters(),
                 weight_decay=0.01)
    for i in range(5):
        ids, seg, labels = _batch(seed=10 + i)
        want = jnet.compute_loss(_p(ids), _p(labels), segment_ids=_p(seg))
        want.backward()
        opt.step()
        opt.clear_grad()
        got = step(net, topt, _t(ids), _t(labels), _t(seg))
        np.testing.assert_allclose(float(got), float(want), err_msg=str(i),
                                   **LOSS)
    jparams = dict(jnet.named_parameters())
    for name, p in net.named_parameters():
        # the key bias is rounding noise on both sides: 2·lr·steps only
        gk, got = key_bias_split(name, p.detach(), CFG_H)
        wk, want = key_bias_split(name, _t(_np_value(jparams[name])), CFG_H)
        if gk is not None:
            torch.testing.assert_close(gk, wk, rtol=0, atol=2 * 1e-3 * 5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name,
                                   **PARAMS)
    params = dict(net.named_parameters())
    for name in ("ernie.pooler.dense.weight", "ernie.pooler.dense.bias"):
        assert torch.equal(params[name].detach(), start[name]), name
    # zero gradient, weight decay alone: p · (1 − lr·wd)⁵
    pre = "ernie.encoder.0.self_attn.pre_ln_scale"
    np.testing.assert_allclose(params[pre].detach().numpy(),
                               (1 - 1e-3 * 0.01) ** 5, rtol=1e-6)


def test_adamw_master_weights_match_jax_multi_precision():
    """bf16 parameters with fp32 master weights (``amp.decorate`` O2):
    five steps of the same bf16 gradients through the port's AdamW and
    the JAX package's ``AdamW(multi_precision=True)``. Both update an
    fp32 master and round it to bf16, so they agree to fp32 rounding."""
    rng = np.random.RandomState(4)
    shapes = [(6, 5), (7,)]
    values = [(0.5 * rng.randn(*s)).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jp = [paddle.create_parameter(list(s), "bfloat16") for s in shapes]
    for p, v in zip(jp, values):
        p._value = jnp.asarray(v, jnp.bfloat16)
    opt = jopt.AdamW(learning_rate=1e-2, parameters=jp, weight_decay=0.01,
                     multi_precision=True)
    tp = [torch.nn.Parameter(_t(v).bfloat16()) for v in values]
    topt = AdamW(learning_rate=1e-2,
                 parameters=[(str(i), p) for i, p in enumerate(tp)],
                 weight_decay=0.01, multi_precision=True)
    for gs in grads:
        for p, t, g in zip(jp, tp, gs):
            p._grad_value = jnp.asarray(g, jnp.bfloat16)
            t.grad = _t(g).bfloat16()
        opt.step()
        topt.step()
    for i, (p, t) in enumerate(zip(jp, tp)):
        master = opt._accumulators[id(p)]["master"]
        np.testing.assert_allclose(topt.state[str(i)]["master"].numpy(),
                                   np.asarray(master), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            t.detach().float().numpy(),
            np.asarray(p._value.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["fp32", "bf16_master", "bf16"])
def test_adamw_update_gives_the_same_bits_in_every_grouping(kind,
                                                           monkeypatch):
    """``adamw_update_`` runs its one arithmetic as multi-tensor passes
    over runs of tensors and as one-tensor passes over the largest:
    every grouping gives the same bits."""
    from paddle_tpu_torch.optimizer import adamw as A

    shapes = [(7, 5), (30,), (3, 4, 5), (2,)]
    dt = torch.float32 if kind == "fp32" else torch.bfloat16

    def run(chunk, big):
        monkeypatch.setattr(A, "_CHUNK_ELEMS", chunk)
        monkeypatch.setattr(A, "_BIG", big)
        rng = np.random.RandomState(9)

        def draw():
            return [_t(rng.randn(*s).astype(np.float32)).to(dt)
                    for s in shapes]

        ps = draw()
        ms, vs = ([torch.zeros(s) for s in shapes] for _ in range(2))
        masters = [p.float() for p in ps] if kind == "bf16_master" else None
        for t in (1, 2, 3):
            A.adamw_update_(ps, draw(), ms, vs, lr=1e-2, beta1=0.9,
                            beta2=0.999, eps=1e-8, weight_decay=0.01,
                            bc1=1 - 0.9 ** t, bc2=1 - 0.999 ** t,
                            masters=masters)
        return ps + ms + vs + (masters or [])

    want = run(1 << 26, 1 << 24)                 # one multi-tensor run
    for chunk, big in ((40, 1 << 24), (1 << 26, 30), (1 << 26, 1)):
        for got, w in zip(run(chunk, big), want):
            assert torch.equal(got, w), (chunk, big)


def test_packed_matches_per_sequence():
    """Each sequence of a packed batch comes out as when it runs alone
    (tests/test_bert_packed.py's check, inside the port)."""
    net = TE.init(TE.ErnieModel(TE.ernie_tiny(**CFG), device="cpu"), seed=7)
    rng = np.random.RandomState(0)
    lens = [5, 9, 7, 12, 3]
    seqs = [rng.randint(1, 100, (n,)) for n in lens]
    rows, seg, locs = [[]], [[]], []
    for s in seqs:
        if len(rows[-1]) + len(s) > 16:
            rows.append([])
            seg.append([])
        locs.append((len(rows) - 1, len(rows[-1])))
        seg[-1] += [max(seg[-1], default=-1) + 1] * len(s)
        rows[-1] += list(s)
    ids = np.asarray([r + [0] * (16 - len(r)) for r in rows], np.int32)
    segs = np.asarray([r + [-1] * (16 - len(r)) for r in seg], np.int32)
    with torch.no_grad():
        packed, _ = net(_t(ids), segment_ids=_t(segs))
        for s, (row, start) in zip(seqs, locs):
            solo, _ = net(_t(s[None, :].astype(np.int32)))
            np.testing.assert_allclose(
                packed[row, start:start + len(s)].numpy(), solo[0].numpy(),
                rtol=2e-4, atol=2e-4)


def test_packed_position_ids_match_jax():
    _, seg, _ = _batch()
    want = _np_value(JE.packed_position_ids(_p(seg)))
    got = TE.packed_position_ids(_t(seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sequence_classification_matches_jax():
    paddle.seed(5)
    jnet = JE.ErnieForSequenceClassification(JE.ernie_tiny(**CFG),
                                             num_classes=3)
    net = _port_net(jnet, lambda cfg, device: (
        TE.ErnieForSequenceClassification(cfg, num_classes=3, device=device)))
    ids, _, _ = _batch(seed=2)
    np.testing.assert_allclose(net(_t(ids)).detach().numpy(),
                               _np_value(jnet(_p(ids))), **OUT)


def test_init_is_seeded_with_the_reference_distributions():
    cfg = TE.ernie_tiny(hidden_size=64, intermediate_size=256)

    def make(seed):
        return TE.init(TE.ErnieForMaskedLM(cfg, device="cpu"), seed)

    a, b, c = make(0), make(0), make(1)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert not torch.equal(pa["transform.weight"], pc["transform.weight"])
    names = {n for n, _ in JE.ErnieForMaskedLM(
        JE.ernie_tiny(hidden_size=64, intermediate_size=256))
        .named_parameters()}
    assert set(pa) == names
    assert torch.equal(pa["ernie.encoder.0.self_attn.ln_scale"],
                       torch.ones(64))
    assert not pa["ernie.encoder.1.ffn.b1"].any() and not pa["bias"].any()
    std = pa["ernie.embeddings.word_embeddings"].std().item()
    assert 0.015 < std < 0.025
    w1 = pa["ernie.encoder.0.ffn.w1"]                  # (64, 256)
    limit = (6.0 / (64 + 256)) ** 0.5
    assert w1.abs().max().item() <= limit and w1.abs().max() > 0.9 * limit


_PUBLIC_LAYERS = {
    "mlm": lambda d: TE.ErnieForMaskedLM(TE.ernie_tiny(), device=d),
    "model": lambda d: TE.ErnieModel(TE.ernie_tiny(), device=d),
    "classification": lambda d: TE.ErnieForSequenceClassification(
        TE.ernie_tiny(), device=d),
    "attention": lambda d: _fused().FusedMultiHeadAttention(32, 4, device=d),
    "ffn": lambda d: _fused().FusedFeedForward(32, 64, device=d),
    "linear": lambda d: _nn().Linear(32, 16, device=d),
    "layer_norm": lambda d: _nn().LayerNorm(32, device=d),
}


def _fused():
    from paddle_tpu_torch.incubate.nn.layer import fused_transformer
    return fused_transformer


def _nn():
    from paddle_tpu_torch.nn import common_layers
    return common_layers


@pytest.mark.parametrize("layer", sorted(_PUBLIC_LAYERS))
def test_layers_default_to_the_card_and_initialise_when_built(layer,
                                                             monkeypatch):
    """``device=None`` means the card (and raises without one); built on
    the CPU, every weight is drawn at construction, from torch's default
    generator, as the reference draws from its global seed."""
    make = _PUBLIC_LAYERS[layer]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)
    torch.manual_seed(21)
    a = dict(make("cpu").named_parameters())
    torch.manual_seed(21)
    b = dict(make("cpu").named_parameters())
    for name, p in a.items():
        assert p.device.type == "cpu" and torch.isfinite(p).all(), name
        assert torch.equal(p, b[name]), name
        if p.dim() == 2:                 # embeddings, Xavier weights
            assert p.std() > 0, name
        elif name.endswith(("scale", "weight")):     # LayerNorm scales
            assert torch.equal(p, torch.ones_like(p)), name
        else:                            # biases
            assert not p.any(), name


def test_cpu_training_step_launches_no_kernel():
    cfg = TE.ernie_tiny(**CFG)
    step, init = TE.build_mlm_train_step(cfg, device="cpu")
    model, opt = init(seed=0)
    ids, seg, labels = _batch(seed=3)
    counters = (tln.layer_norm, tln.layer_norm_bwd, tfa.flash_fwd_kernel,
                tfa.flash_bwd_dq_kernel, tfa.flash_bwd_dkv_kernel)
    before = [c.launches for c in counters]
    loss = step(model, opt, _t(ids), _t(labels), _t(seg))
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_fused_layers_and_grads_match_jax(pre):
    """FusedMultiHeadAttention (causal) and FusedFeedForward (gelu) in
    both LayerNorm placements, outputs and every parameter gradient; the
    attention block's LN that the placement leaves unused gets zeros, as
    the reference's one op over all its parameters gives it."""
    from paddle_tpu.incubate.nn.layer import fused_transformer as JF
    from paddle_tpu_torch.incubate.nn.layer import fused_transformer as TF_

    paddle.seed(11)
    h, nh, f = 32, 4, 64
    jattn = JF.FusedMultiHeadAttention(h, nh, normalize_before=pre)
    jffn = JF.FusedFeedForward(h, f, activation="gelu", normalize_before=pre)
    tattn = TF_.FusedMultiHeadAttention(h, nh, normalize_before=pre,
                                        device="cpu")
    tffn = TF_.FusedFeedForward(h, f, activation="gelu", normalize_before=pre,
                                device="cpu")
    for jm, tm in ((jattn, tattn), (jffn, tffn)):
        TE.params_from_numpy(tm, {n: _np_value(p)
                                  for n, p in jm.named_parameters()})
    rng = np.random.RandomState(12)
    # a weighted sum: a post-LN output's plain sum has no gradient
    x, r = (rng.randn(2, 10, h).astype(np.float32) for _ in range(2))
    want = jffn(jattn(_p(x)))
    (want * _p(r)).sum().backward()
    got = tffn(tattn(_t(x)))
    np.testing.assert_allclose(got.detach().numpy(), _np_value(want), **OUT)
    (got * _t(r)).sum().backward()
    for jm, tm in ((jattn, tattn), (jffn, tffn)):
        jgrads = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       _np_value(jgrads[name].grad),
                                       err_msg=name, **GRADS)
    unused = ("ln_scale", "ln_bias") if pre else ("pre_ln_scale",
                                                  "pre_ln_bias")
    assert all(not getattr(tattn, n).grad.any() for n in unused)


@pytest.mark.parametrize("mask", ["none", "additive", "segments"])
def test_prefill_attention_paths_match_jax(mask):
    """``_prefill_attention``'s three paths: no mask (the flash kernels),
    an additive mask (a plain einsum and softmax) and segment ids (the
    segment-masked flash kernels)."""
    from paddle_tpu.ops import fused_transformer_block as jftb
    from paddle_tpu_torch.ops import fused_transformer_block as tftb

    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(2, 3, 20, 8).astype(np.float32) for _ in range(3))
    kw, causal = {}, mask == "none"
    if mask == "additive":
        add = np.where(rng.rand(2, 1, 1, 20) < 0.2, -1e4, 0.0)
        kw = dict(attn_mask=add.astype(np.float32))
    if mask == "segments":
        seg = np.repeat([[0, 1, -1]], [9, 7, 4], axis=1).repeat(2, axis=0)
        kw = dict(seg_ids=seg.astype(np.int32))
    want = jftb._prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kw["attn_mask"]) if "attn_mask" in kw else None,
        causal=causal,
        seg_ids=jnp.asarray(kw["seg_ids"]) if "seg_ids" in kw else None)
    got = tftb._prefill_attention(
        _t(q), _t(k), _t(v),
        _t(kw["attn_mask"]) if "attn_mask" in kw else None, causal=causal,
        seg_ids=_t(kw["seg_ids"]) if "seg_ids" in kw else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)
