"""Public names: a name that a ported module of ``paddle_tpu`` defines
exists in its counterpart in ``paddle_tpu_torch`` (``test_torch_
signatures.py`` then checks how a callable binds).

The walk imports every module of the port, and for each one whose
counterpart exists in the JAX package takes each public name the
counterpart defines: in a module, its functions and classes defined
there and its other public values; in a package, what it exports from
inside itself (submodules included). Every such name must be in the
port's module, and every public attribute of such a class in the
port's class. The names that stay JAX-only, or wait on a later item of
ROADMAP.md's Queue A, are listed below with the reason: each of them
is absent from the port or raises ``NotImplementedError`` there.

The names this file walks also compute what the reference computes
where they compute something (the parity cases at the end).
"""

import importlib
import inspect
import pkgutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

_JAX = "JAX-only: a Pallas/XLA or jax-device construct with no torch form"

#: reference name -> why the port does not have it yet
DEFERRED = {
    "core.compat": _JAX + " (jax version shims)",
    "core.native": "the reference's g++ build helper; the port builds its "
                   "copy of tcp_store.cc in distributed/store.py",
    "core.autograd.GradNode": _JAX + " (the tape node of the jax eager "
                              "tape; torch's autograd records the graph)",
    "core.place.Place.jax_device": _JAX,
    "ops._common.is_tpu_platform": _JAX,
    "ops._common.on_tpu": _JAX,
    "ops._common.use_pallas": _JAX + " (the port picks by tensor device)",
    "ops.paged_attention.paged_attention_pallas": _JAX,
    "ops.paged_attention.ragged_paged_attention_pallas": _JAX,
    "ops.paged_attention.paged_attention_array": _JAX + " (an *_array "
                                                 "entry over jax arrays)",
    "ops.paged_attention.paged_prefill_attention_array": _JAX,
    "ops.paged_attention.paged_write_array": _JAX,
    "ops.paged_attention.ragged_paged_attention_array": _JAX,
    "ops.rms_norm.rms_norm_array": _JAX,
    "distributed.auto_parallel.api.ProcessMesh.jax_mesh": _JAX + " (the "
    "port's ProcessMesh.rank_mesh is its mesh of ranks)",
}


def _required(ref, ref_name):
    """The public names ``ref`` defines (module docstring). A package's
    submodules are the files in it, whether imported yet or not."""
    is_pkg = hasattr(ref, "__path__")
    if is_pkg:
        for m in pkgutil.iter_modules(ref.__path__):
            if not m.name.startswith("_"):
                yield m.name, None
    for name in sorted(vars(ref)):
        v = getattr(ref, name)
        if name.startswith("_") or isinstance(v, types.ModuleType):
            continue
        mod = getattr(v, "__module__", None) or ""
        if is_pkg:
            if callable(v) and (mod == ref_name
                                or mod.startswith(ref_name + ".")):
                yield name, v
        elif mod == ref_name or (not callable(v) and mod in ("", "builtins")
                                 and not isinstance(v, type)):
            yield name, v


def _walk():
    mods = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        if not info.name.endswith("__main__"):
            mods.append(importlib.import_module(info.name))
    out = []           # (qualified name, present in the port)
    for mod in mods:
        short = mod.__name__[len("paddle_tpu_torch."):]
        ref_name = "paddle_tpu." + short
        try:
            ref = importlib.import_module(ref_name)
        except ImportError:
            continue                        # a module only the port has
        subs = ({m.name for m in pkgutil.iter_modules(mod.__path__)}
                if hasattr(mod, "__path__") else set())
        for name, r in _required(ref, ref_name):
            q = f"{short}.{name}"
            if r is None:                   # a submodule of the package
                out.append((q, name in subs))
                continue
            try:
                t = getattr(mod, name)
            except AttributeError:
                out.append((q, False))
                continue
            except NotImplementedError:
                out.append((q, "raises"))
                continue
            out.append((q, True))
            if inspect.isclass(r) and inspect.isclass(t) \
                    and r.__module__ == ref_name:
                for a in vars(r):
                    if not a.startswith("_"):
                        out.append((f"{q}.{a}", hasattr(t, a)))
    return out


_NAMES = _walk()


def test_every_public_name_is_ported_or_deferred_with_a_reason():
    missing = [q for q, ok in _NAMES if ok is not True and q not in DEFERRED]
    assert not missing, f"public names the port lacks: {missing}"


def test_deferred_names_are_absent_or_raise():
    """A deferred name that the port has gained leaves the list; one the
    reference no longer defines too."""
    state = dict(_NAMES)
    stale = [q for q in DEFERRED if q not in state]
    assert not stale, f"no longer defined by the reference: {stale}"
    ported = [q for q in DEFERRED if state[q] is True]
    assert not ported, f"ported now, drop from DEFERRED: {ported}"


def test_the_walk_covers_the_queue_c_12_names():
    have = {q for q, ok in _NAMES if ok is True}
    for q in ("incubate.nn.FusedMultiTransformer",
              "incubate.nn.FusedMultiHeadAttention",
              "incubate.nn.FusedFeedForward", "incubate.nn.functional",
              "inference.Drafter", "inference.DraftModel",
              "inference.NgramDrafter", "inference.SpeculationTelemetry",
              "inference.SamplerConfig", "inference.GrammarArena",
              "inference.TokenDFA", "inference.compile_regex",
              "inference.json_grammar", "inference.json_regex",
              "models.llama.llama2_13b", "models.llama.param_nbytes",
              "models.llama.kv_geometry",
              "ops.layer_norm_fused.layer_norm_fused",
              "ops.flash_attention.scaled_dot_product_attention",
              "ops.paged_attention.PagedKVCacheManager.seq_len",
              "inference.constrain.GrammarArena.device_table"):
        assert q in have, q


def test_the_walk_covers_the_distributed_iv_names():
    """The names that waited for Distributed IV are ported now: the
    walk finds each of them, none raising."""
    have = {q for q, ok in _NAMES if ok is True}
    for q in ("ops.paged_attention.PagedKVCacheManager.shard_heads",
              "serving.elastic", "serving.ElasticServingController",
              "serving.FlightSnapshot", "serving.ResizeRecord",
              "serving.elastic.MAX_RESIZES",
              "distributed.auto_parallel", "distributed.shard_tensor",
              "distributed.ProcessMesh", "distributed.Shard",
              "distributed.Replicate", "distributed.Partial",
              "distributed.reshard", "distributed.shard_layer",
              "distributed.dtensor_from_fn", "distributed.Strategy",
              "distributed.auto_parallel.Engine",
              "distributed.auto_parallel.engine.Engine.fit",
              "parallel.mesh.serving_mesh",
              "parallel.mesh.shrink_serving_mesh",
              "models.llama.shard_params_tp"):
        assert q in have, q


# ---------------------------------------------------------------------------
# parity of the names that compute something
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["7b", "13b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_nbytes_and_kv_geometry_match(size, dtype):
    from paddle_tpu.models import llama as JL
    from paddle_tpu_torch.models import llama as TL
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = getattr(JL, f"llama2_{size}")(dtype=jd)
    tcfg = getattr(TL, f"llama2_{size}")(dtype=td)
    assert TL.param_nbytes(tcfg) == JL.param_nbytes(jcfg)
    for page in (16, 128):
        assert TL.kv_geometry(tcfg, page) == JL.kv_geometry(jcfg, page)
    for f in ("hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "vocab_size"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_init_stacked_params_are_the_references_draws():
    from paddle_tpu.models import llama as JL
    from paddle_tpu_torch.models import llama as TL
    want = JL.init_stacked_params(JL.llama_tiny(), seed=3)
    got = TL.init_stacked_params(TL.llama_tiny(), seed=3, device="cpu")
    assert list(got) == list(want)
    for k in want:
        # normal draws: to an ulp of XLA's erfinv (random.erfinv)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_layer_norm_fused_matches_the_reference():
    from paddle_tpu.ops import layer_norm_fused as JLN
    from paddle_tpu_torch.ops import layer_norm_fused as TLN
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 256).astype(np.float32)
    w = rng.randn(256).astype(np.float32)
    b = rng.randn(256).astype(np.float32)
    want = np.asarray(JLN.layer_norm_fused(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), 1e-5))
    jg = jax.grad(lambda *a: jnp.sum(JLN.layer_norm_fused(*a, 1e-5) ** 2),
                  argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, b))
    got = TLN.layer_norm_fused(tx, tw, tb, 1e-5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    (got ** 2).sum().backward()
    for t, g in zip((tx, tw, tb), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4)
    assert TLN.layer_norm_fused is TLN.layer_norm


def test_sdpa_at_the_reference_path_matches():
    from paddle_tpu.ops import flash_attention as JFA
    import paddle_tpu as rp
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.core import place as tplace
    from paddle_tpu_torch.ops import flash_attention as TFA
    prev = tplace._current_place[0]
    tp.set_device("cpu")
    try:
        rng = np.random.RandomState(0)
        q, k, v = (rng.randn(2, 16, 2, 64).astype(np.float32)
                   for _ in range(3))
        for causal in (False, True):
            want = JFA.scaled_dot_product_attention(
                rp.to_tensor(q), rp.to_tensor(k), rp.to_tensor(v), None,
                0.0, causal, True, 0.125)
            got = TFA.scaled_dot_product_attention(
                tp.to_tensor(q), tp.to_tensor(k), tp.to_tensor(v), None,
                0.0, causal, True, 0.125)
            np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                       rtol=1e-5, atol=1e-5)
    finally:
        tplace._current_place[0] = prev


def test_seq_len_and_device_table():
    from paddle_tpu.inference import constrain as JC
    from paddle_tpu.ops import paged_attention as JPA
    from paddle_tpu_torch.inference import constrain as TC
    from paddle_tpu_torch.ops import paged_attention as TPA
    for pa, kw in ((JPA, {}), (TPA, {"device": "cpu"})):
        m = pa.PagedKVCacheManager(1, 8, 4, 1, 8, **kw)
        m.allocate("s", 6)
        m.extend("s", 3)
        assert m.seq_len("s") == 9
        with pytest.raises(KeyError):
            m.seq_len("unknown")
    vocab = ["a", "b", "<eos>"]
    arenas = []
    for C in (JC, TC):
        kw = {} if C is JC else {"device": "cpu"}
        arena = C.GrammarArena(len(vocab), 8, **kw)
        arena.register(C.compile_regex("ab", vocab, eos_token_id=2))
        arenas.append(np.asarray(arena.device_table()))
    np.testing.assert_array_equal(arenas[1], arenas[0])
