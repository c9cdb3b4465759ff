"""dy2static in ``paddle_tpu_torch.jit`` against ``paddle_tpu.jit``'s on
the CPU: the reference's own scenarios (``tests/test_dy2static.py``,
``test_dy2static_loops.py``, ``test_dy2static_return.py``) run through the
port unchanged (``torch_scenarios`` with its ``jax`` shim: ``jax.jit(f)``
runs ``f`` as a compiled program's body), and the same converted
functions through both packages on the same inputs (fp32, rtol 1e-6):
the values, the ConversionErrors and the fallback warnings agree; a
data-dependent ``while`` is a counted, evented graph break."""

import warnings

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

import torch_scenarios

one_cpu_thread()

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


#: scenarios the runner cannot express: one calls the JAX package's
#: model with jnp methods (``.astype``) inside the traced loop, one
#: needs ``bool`` of a traced raw array to raise (a raw torch tensor of
#: one element has a truth value). Their counterparts are
#: ``test_greedy_decode_with_early_exit_matches_reference`` and
#: ``test_value_position_or_raises_on_a_traced_tensor`` below
LOOPS_SKIP = {"TestRealModelPath.test_greedy_decode_loop_with_break",
              "TestReviewRepros.test_value_position_or_keeps_python_semantics"}
RETURN_SKIP = {"TestReturnInLoop.test_greedy_decode_loop_with_early_return"}


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_dy2static.py", jax_shim=True))
def test_dy2static_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_dy2static.py", scenario, request)


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_dy2static_loops.py", LOOPS_SKIP, jax_shim=True))
def test_dy2static_loops_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_dy2static_loops.py", scenario, request)


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_dy2static_return.py", RETURN_SKIP, jax_shim=True))
def test_dy2static_return_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_dy2static_return.py", scenario, request)


# ---------------------------------------------------------------------------
# the same converted functions through both packages
# ---------------------------------------------------------------------------

def _branchy(x):
    if (x.sum() > 0):
        y = x * 2.0
    elif (x.mean() > -0.5):
        y = x - 1.0
    else:
        y = -x
    return y + 1.0


def _loopy(x):
    s = x * 0.0
    i = 0
    while (s.sum() < 10.0):
        s = s + x
        i += 1
        if (s.sum() >= 6.0):
            break
    return s


def _ranged(x, n):
    s = x * 0.0
    for i in range(n):
        s = s + x + i
    return s


def _early(x):
    s = x
    while s.sum() < 40.0:
        s = s * 2.0
        if s.max() > 9.0:
            return s * -1.0
    return s


def _boolops(x):
    if (x.sum() > 0) and not (x.max() > 5.0) or (x.min() < -9.0):
        y = x * 3.0
    else:
        y = x
    return y


def _iterate(x):
    s = x[0] * 0.0
    for i, row in enumerate(x):
        s = s + row * float(i)
    return s


CASES = {
    "if_elif": (_branchy, [np.ones(3), -np.ones(3) * 0.25, -np.ones(3)]),
    "while_break": (_loopy, [np.ones(4)]),
    "for_range": (_ranged, [np.ones(2)]),
    "return_in_while": (_early, [np.ones(2) * 0.5, np.ones(2) * 3.0]),
    "bool_ops": (_boolops, [np.ones(2), np.ones(2) * 7.0,
                            -np.ones(2) * 10.0]),
    "for_over_tensor": (_iterate, [np.arange(6.0).reshape(3, 2)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_converted_function_matches_reference(name):
    fn, inputs = CASES[name]
    jsf, tsf = J.jit.to_static(fn), TP.jit.to_static(fn)
    for x in inputs:
        x = x.astype(np.float32)
        args_j, args_t = [J.to_tensor(x)], [TP.to_tensor(x)]
        if fn is _ranged:
            args_j.append(J.to_tensor(np.int32(3)))
            args_t.append(TP.to_tensor(np.int32(3)))
        want = np.asarray(jsf(*args_j)._value)
        got = tsf(*args_t).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert tsf.recompile_count == jsf.recompile_count


def _one_armed(x):
    if (x.sum() > 0):
        y = x * 2.0
    return y  # noqa: F821


def _grows(x):
    s = x
    while s.sum() < 6.0:
        s = TP.concat([s, s]) if isinstance(s, TP.Tensor) \
            else J.concat([s, s])
    return s


@pytest.mark.parametrize("fn,match", [(_one_armed, "initialise"),
                                      (_grows, None)],
                         ids=["one_armed_if", "growing_carry"])
def test_conversion_errors_and_fallback_match_reference(fn, match):
    """Strict mode raises the reference's ConversionError; the default
    falls back to eager with the reference's warning and value."""
    x = np.ones((2,), np.float32)
    for pkg in (J, TP):
        pkg.set_flags({"FLAGS_dy2static_fallback": 0})
        try:
            with pytest.raises(pkg.jit.ConversionError, match=match):
                pkg.jit.to_static(fn)(pkg.to_tensor(x))
        finally:
            pkg.set_flags({"FLAGS_dy2static_fallback": 1})
    outs = []
    for pkg in (J, TP):
        with pytest.warns(UserWarning, match="falling back to the EAGER"):
            out = pkg.jit.to_static(fn)(pkg.to_tensor(x))
        outs.append(np.asarray(out._value) if pkg is J else out.numpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def _concrete_while(x, n=3):
    i = 0
    while i < n:
        x = x + 1.0
        i += 1
    return x


def test_data_dependent_while_is_a_counted_evented_graph_break(monkeypatch):
    from paddle_tpu_torch.jit import dy2static as D
    from paddle_tpu_torch.observability import events
    seen = []
    monkeypatch.setattr(events.event_log, "emit",
                        lambda kind, **f: seen.append((kind, f)))
    monkeypatch.setattr(D, "_break_noted", set())
    before = sum(D.graph_breaks.values())
    sf = TP.jit.to_static(_loopy)
    for _ in range(3):
        out = sf(TP.to_tensor(np.ones((4,), np.float32)))
    np.testing.assert_allclose(out.numpy(), 2.0 * np.ones(4))
    assert sum(D.graph_breaks.values()) - before == 3
    breaks = [f for k, f in seen if k == "dy2static_graph_break"]
    assert len(breaks) == 1 and "while" in breaks[0]["reason"]
    # a concrete while is no break
    TP.jit.to_static(_concrete_while)(TP.to_tensor(np.ones(2, np.float32)))
    assert sum(D.graph_breaks.values()) - before == 3


def test_traced_host_read_raises_the_concretization_error():
    """``bool`` of a traced Tensor inside a compiled program raises the
    counterpart of JAX's ConcretizationTypeError; to_static falls back
    to eager on it, as the reference does."""
    from paddle_tpu_torch.core.tensor import ConcretizationError

    def f(x):
        return x * 2.0 if bool(x.sum() > 0) else x

    with pytest.warns(UserWarning, match="ConcretizationError"):
        out = TP.jit.to_static(f)(TP.to_tensor(np.ones(2, np.float32)))
    np.testing.assert_allclose(out.numpy(), 2.0)
    TP.set_flags({"FLAGS_dy2static_fallback": 0})
    try:
        with pytest.raises(ConcretizationError):
            TP.jit.to_static(f)(TP.to_tensor(np.ones(2, np.float32)))
    finally:
        TP.set_flags({"FLAGS_dy2static_fallback": 1})


def test_value_position_or_raises_on_a_traced_tensor():
    """``x or default`` in value position is not rewritten: concrete
    operands keep Python's result, a traced Tensor raises (the
    reference's TracerBoolConversionError, the port's
    ConcretizationError) under strict mode, in both packages."""
    def f(x):
        scale = x.sum() or 1.0
        if (scale > 0):
            r = x * scale
        else:
            r = x
        return r

    x = np.full(4, 2.0, np.float32)
    for pkg in (J, TP):
        conv = pkg.jit.convert_control_flow(f)
        np.testing.assert_allclose(np.asarray(conv(pkg.to_tensor(x))
                                              ._value.tolist()), 16.0)
        pkg.set_flags({"FLAGS_dy2static_fallback": 0})
        try:
            with pytest.raises(TypeError):   # both errors are TypeErrors
                pkg.jit.to_static(f)(pkg.to_tensor(x))
        finally:
            pkg.set_flags({"FLAGS_dy2static_fallback": 1})


def test_greedy_decode_with_early_exit_matches_reference():
    """The reference's model-path scenario with the port's model: a
    greedy decode loop over a tiny Llama with an EOS break, converted,
    equal token for token to the reference's converted loop over the
    same weights."""
    import paddle_tpu.models.llama as JL
    import paddle_tpu_torch.models.llama as TL
    cfg_j = JL.llama_tiny()
    cfg_t = TL.llama_tiny()
    jparams = JL.init_stacked_params(cfg_j, seed=0)
    import jax
    tparams = TL.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg_t, device="cpu")
    prompt = np.array([[3, 17, 42, 9]], np.int32)
    P = prompt.shape[1]

    def decode_j(ids, eos):
        import jax.numpy as jnp
        buf = jnp.zeros((1, P + 6), jnp.int32)
        buf = jax.lax.dynamic_update_slice(buf, ids, (0, 0))
        out = []
        for i in range(6):
            lg = JL.forward_stacked(jparams, buf[:, :P + i], cfg_j)
            nxt = int(np.asarray(jnp.argmax(lg[0, -1].astype(jnp.float32))))
            out.append(nxt)
            if nxt == eos:
                break
            buf = buf.at[0, P + i].set(nxt)
        return out

    def decode_t(ids, eos):
        import torch
        buf = torch.zeros((1, P + 6), dtype=torch.int32)
        buf[:, :P] = ids
        out = []
        for i in range(6):
            lg = TL.forward_stacked(tparams, buf[:, :P + i], cfg_t)
            nxt = int(torch.argmax(lg[0, -1].float()))
            out.append(nxt)
            if nxt == eos:
                break
            buf[0, P + i] = nxt
        return out

    import torch
    conv_t = TP.jit.convert_control_flow(decode_t)
    conv_j = J.jit.convert_control_flow(decode_j)
    eos = -1
    want = conv_j(prompt, eos)
    got = conv_t(torch.from_numpy(prompt), eos)
    assert got == want
    eos = want[2]
    assert conv_t(torch.from_numpy(prompt), eos) == conv_j(prompt, eos)
