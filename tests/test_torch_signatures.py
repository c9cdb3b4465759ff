"""Public signatures: a call written against ``paddle_tpu`` binds the
same way in ``paddle_tpu_torch``.

The walk covers every public callable that both packages define: each
module of the port whose counterpart exists in the JAX package, each
name defined there (functions and classes) that the counterpart also
has, and each public method that both classes define. For every pair:

* the port's positional parameters are the reference's, in its order;
* every parameter of the reference is accepted by the port;
* a parameter of the port's own (``device``, ``dtype``, ``decoding``,
  ``decoded``, ...) is keyword-only, so a positional call meant for the
  reference can never land in it.

The behavioural cases below show the misbindings this convention
repaired: each call is the reference's own positional form."""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

P = inspect.Parameter
_POS = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)


def _unwrap(v):
    return v.__func__ if isinstance(v, (staticmethod, classmethod)) else v


def _pairs():
    """(id, port callable, reference callable) for every public callable
    both packages define, in a fixed order."""
    out = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        if info.name.endswith("__main__"):
            continue
        ref_name = "paddle_tpu" + info.name[len("paddle_tpu_torch"):]
        try:
            ref = importlib.import_module(ref_name)
        except ImportError:
            continue                    # a module only the port has
        mod = importlib.import_module(info.name)
        for name in sorted(vars(mod)):
            t = getattr(mod, name)
            r = getattr(ref, name, None)
            if (name.startswith("_") or r is None or not callable(t)
                    or not callable(r)
                    or getattr(t, "__module__", "") != info.name):
                continue
            out.append((f"{info.name[17:]}.{name}", t, r))
            if not (inspect.isclass(t) and inspect.isclass(r)):
                continue
            for mname in sorted(vars(t)):
                mt = _unwrap(vars(t)[mname])
                mr = _unwrap(inspect.getattr_static(r, mname, None))
                if (not mname.startswith("_") and inspect.isfunction(mt)
                        and inspect.isfunction(mr)):
                    out.append((f"{info.name[17:]}.{name}.{mname}", mt, mr))
    return out


_PAIRS = _pairs()


def _params(fn):
    """The parameters, without a leading ``self``/``cls`` (a method and
    a static method of the same name compare alike)."""
    ps = list(inspect.signature(fn).parameters.values())
    if ps and ps[0].name in ("self", "cls") and ps[0].kind in _POS:
        ps = ps[1:]
    return ps


def test_the_walk_covers_the_ported_surface():
    ids = {i for i, _, _ in _PAIRS}
    assert len(_PAIRS) > 400
    for must in ("inference.decoding.ContinuousBatchingEngine",
                 "ops.rms_norm.rms_norm",
                 "ops.paged_attention.ragged_paged_attention",
                 "models.ernie.ErnieForSequenceClassification",
                 "incubate.nn.layer.fused_transformer.FusedMultiTransformer",
                 "serving.multihost.HostHandle.submit",
                 "observability.federation.FederationHub.ingest",
                 "nn.layer.Layer.state_dict", "nn.layer.Layer.set_state_dict",
                 "resilience.trainer.ResilientTrainer.run",
                 "resilience.durable.restore_train_state",
                 "distributed.checkpoint.save_state_dict.save_state_dict",
                 "distributed.checkpoint.async_save.TrainState.skip_batches",
                 "distributed.env.get_rank", "framework.io_save.save",
                 "io.DataLoader"):
        assert must in ids, must


@pytest.mark.parametrize("ident,port,ref", _PAIRS,
                         ids=[i for i, _, _ in _PAIRS])
def test_signature_binds_like_the_reference(ident, port, ref):
    try:
        rp = _params(ref)
    except (TypeError, ValueError):
        # no introspectable signature (an exception class's builtin
        # constructor): the port's must be the same builtin one
        with pytest.raises((TypeError, ValueError)):
            _params(port)
        return
    tp = _params(port)
    t_pos = [p.name for p in tp if p.kind in _POS]
    r_pos = [p.name for p in rp if p.kind in _POS]
    assert t_pos == r_pos, f"{ident}: positional {t_pos} != {r_pos}"
    t_names = {p.name for p in tp}
    t_var_kw = any(p.kind == P.VAR_KEYWORD for p in tp)
    for p in rp:
        if p.kind == P.VAR_POSITIONAL:
            assert any(q.kind == P.VAR_POSITIONAL for q in tp), ident
        elif p.kind == P.VAR_KEYWORD:
            assert t_var_kw, f"{ident}: takes no **{p.name}"
        else:
            assert p.name in t_names or t_var_kw, \
                f"{ident}: refuses the reference's {p.name!r}"
    r_names = {p.name for p in rp}
    for p in tp:
        if p.name not in r_names and p.kind in _POS:
            pytest.fail(f"{ident}: the port's {p.name!r} is positional")


# ---------------------------------------------------------------------------
# the repaired misbindings, each in the reference's positional form
# ---------------------------------------------------------------------------

def _tiny_engine_args():
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(num_hidden_layers=1)
    return cfg, TL.init_params(cfg, 0, device="cpu")


def test_engine_eighth_positional_is_prefix_cache():
    from paddle_tpu_torch.inference.decoding import ContinuousBatchingEngine
    cfg, _ = _tiny_engine_args()
    eng = ContinuousBatchingEngine(cfg, None, 2, 16, 128, None, 8, True,
                                   device="cpu")
    assert eng.cache is not None
    # step_tokens keeps its default: max(slots, chunk, page)
    assert eng._step_tokens == 16
    plain = ContinuousBatchingEngine(cfg, None, 2, 16, 128, None, 8,
                                     device="cpu")
    assert plain.cache is None


@pytest.mark.parametrize("check", [True, False])
def test_check_invariants_gates_the_page_audit(check, monkeypatch):
    from paddle_tpu_torch.inference.decoding import (ContinuousBatchingEngine,
                                                     GenerationConfig)
    cfg, params = _tiny_engine_args()
    eng = ContinuousBatchingEngine(
        cfg, GenerationConfig(max_new_tokens=3), num_slots=2, page_size=4,
        max_seq_len=32, chunk=2, prefix_cache=True, check_invariants=check,
        device="cpu")
    calls = []
    real = eng.mgr.check_conservation
    monkeypatch.setattr(eng.mgr, "check_conservation",
                        lambda: (calls.append(1), real())[1])
    out = eng.serve(params, [np.arange(1, 7, dtype=np.int32)])
    assert len(out[0]) == 3
    assert bool(calls) is check


def test_engine_mesh_and_mp_axis():
    from paddle_tpu_torch.inference.decoding import ContinuousBatchingEngine
    cfg, _ = _tiny_engine_args()
    # the reference's defaults are accepted; a mesh is a later slice
    ContinuousBatchingEngine(cfg, mp_axis="mp", mesh=None, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(cfg, mesh=object(), mp_axis="tp",
                                 device="cpu")


def test_rms_norm_takes_weight_and_epsilon():
    from paddle_tpu.ops import rms_norm as JR
    from paddle_tpu_torch.ops import rms_norm as TR
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(JR.rms_norm_array(jnp.asarray(x), jnp.asarray(w),
                                        1e-3))
    got = TR.rms_norm(torch.from_numpy(x), weight=torch.from_numpy(w),
                      epsilon=1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_fused_multi_transformer_fourth_positional_is_dropout_rate():
    from paddle_tpu.incubate.nn.layer import fused_transformer as JF
    from paddle_tpu_torch.incubate.nn.layer import fused_transformer as TF
    j = JF.FusedMultiTransformer(64, 4, 128, 0.0, "gelu")
    t = TF.FusedMultiTransformer(64, 4, 128, 0.0, "gelu", device="cpu")
    assert (t.activation, t.dropout_rate) == (j.activation, j.dropout_rate)
    assert t.activation == "gelu"
    TF.FusedMultiHeadAttention(64, 4, 0.1, 0.1, True, device="cpu")
    ffn = TF.FusedFeedForward(64, 128, 0.1, "gelu", device="cpu")
    assert ffn.activation == "gelu"


def test_ragged_paged_attention_ninth_positional_is_mesh():
    from paddle_tpu_torch.ops import paged_attention as TPA
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(np.float32))
    kp = torch.from_numpy(
        rng.standard_normal((4, 4, 1, 8)).astype(np.float32))
    vp = torch.from_numpy(
        rng.standard_normal((4, 4, 1, 8)).astype(np.float32))
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    row = torch.zeros(3, dtype=torch.int32)
    pos = torch.arange(3, dtype=torch.int32)
    lens = torch.tensor([3], dtype=torch.int32)
    a = TPA.ragged_paged_attention(q, kp, vp, bt, row, pos, lens, 0.5, None,
                                   "mp")
    b = TPA.ragged_paged_attention(q, kp, vp, bt, row, pos, lens, 0.5)
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        TPA.ragged_paged_attention(q, kp, vp, bt, row, pos, lens, 0.5,
                                   object())


def test_ernie_classifier_third_positional_is_dropout():
    from paddle_tpu_torch.models import ernie as TE
    net = TE.ErnieForSequenceClassification(TE.ernie_tiny(), 3, 0.1,
                                            device="cpu")
    assert net.classifier.weight.dtype == torch.float32
    assert net.classifier.weight.shape[1] == 3


def test_serving_request_keeps_the_reference_field_order():
    from paddle_tpu_torch.serving.scheduler import ServingRequest
    args = [7, np.zeros(2, np.int32)] + [None] * 15
    req = ServingRequest(*args, 1234)
    assert (req.token_checksum, req.decoded) == (1234, 0)


def test_layers_take_weight_attr_and_bias_attr():
    import paddle_tpu.nn as JNN
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers as TMP
    from paddle_tpu_torch.nn import common_layers as TC
    j = JNN.Linear(4, 3, None, False)
    t = TC.Linear(4, 3, None, False, device="cpu")
    assert j.bias is None and t.bias is None
    ln = TC.LayerNorm(4, 1e-5, None, False, device="cpu")
    assert ln.bias is None and ln.weight is not None
    col = TMP.ColumnParallelLinear(4, 8, None, False, device="cpu")
    assert col.bias is None
    row = TMP.RowParallelLinear(4, 8, None, True, True, device="cpu")
    assert row.input_is_parallel and row.bias is not None
    emb = TMP.VocabParallelEmbedding(10, 4, None, None, "emb", device="cpu")
    assert emb.weight.shape == (10, 4)
    with pytest.raises(NotImplementedError):
        TMP.ColumnParallelLinear(4, 8, object(), device="cpu")
    with pytest.raises(TypeError):                  # as the reference's
        TC.Linear(4, 3, object(), device="cpu")
    with pytest.raises(TypeError):
        JNN.Linear(4, 3, object())


def test_embedding_padding_idx_and_cross_entropy_options():
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu_torch.nn import functional as TF
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 2, 1]], np.int64)
    want = np.asarray(JF.embedding(paddle.to_tensor(ids),
                                   paddle.to_tensor(w), 2)._value)
    got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    logits = torch.zeros(2, 4)
    label = torch.tensor([1, 2])
    for red in ("mean", "sum"):
        want = JF.cross_entropy(paddle.to_tensor(logits.numpy()),
                                paddle.to_tensor(label.numpy()), None, -100,
                                red)
        got = TF.cross_entropy(logits, label, None, -100, red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=1e-6)


def test_mix_precision_layer_and_speculation_telemetry_arguments():
    from paddle_tpu_torch.distributed.fleet.utils import (
        mix_precision_utils as TM)
    from paddle_tpu_torch.inference.speculative import SpeculationTelemetry
    layer = TM.MixPrecisionLayer(torch.nn.Linear(2, 2), "float16")
    assert layer._dtype == "float16"
    assert SpeculationTelemetry("3").replica == "3"


def test_prefix_cache_record_takes_the_reference_order():
    from paddle_tpu_torch.kvcache import PrefixCache, RefcountedKVCacheManager
    cache = PrefixCache(RefcountedKVCacheManager(1, 8, 4, 1, 8,
                                                 dtype=torch.float32,
                                                 device="cpu"))
    cache.record(5, 12, 8, 2, False, "t")
    cache.record(6, 12, 0, 0, True)
    snap = cache.snapshot()
    assert (snap["hits"], snap["misses"], snap["cow_copies"],
            snap["cached_tokens"]) == (1, 1, 1, 8)
