"""The port's op table (``paddle_tpu_torch.core.op_schema``) and the public
ops it and the hand-written modules give, driven by the JAX package's
single-source schema: every ``OpSpec`` of ``paddle_tpu.core.op_schema``
runs through the port's public op (``getattr(paddle_tpu_torch, name)``)
on the spec's own ``sample`` and is held to the spec's numpy ``oracle``
at ``spec.tolerance`` (fp32, or the spec's one dtype where it has no
fp32); every spec with ``grad=True`` is differentiated through the port
and held to the JAX package's gradient of the same loss (``jax.grad`` of
the spec's function: what its tape records for the op). The port runs on
the CPU."""

import zlib

import numpy as np
import pytest

import paddle_tpu_torch as TP
from paddle_tpu.core.op_schema import OPS
from paddle_tpu_torch.core import op_schema as TS
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _dtype(spec):
    return "float32" if "float32" in spec.dtypes else spec.dtypes[0]


def _cast_args(args, spec, dtype):
    out = []
    for i, a in enumerate(args):
        if i in spec.integer_inputs or not np.issubdtype(
                np.asarray(a).dtype, np.floating):
            out.append(a)
        else:
            out.append(np.asarray(a).astype(dtype))
    return out


def _sample(name):
    spec = OPS[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
    return spec, rng, spec.sample(rng)


def test_the_port_table_mirrors_the_reference():
    assert set(TS.OPS) == set(OPS)
    for name, spec in OPS.items():
        t = TS.OPS[name]
        assert (t.dtypes, t.grad, t.grad_arg, t.n_outputs,
                t.integer_inputs) == (spec.dtypes, spec.grad, spec.grad_arg,
                                      spec.n_outputs, spec.integer_inputs), name
        assert t.tolerance("float32") == spec.tolerance("float32")
    # install() adds only the names the namespace lacks
    ns = {"abs": TP.abs}
    added = TS.install(ns)
    assert ns["abs"] is TP.abs and "abs" not in added and "trace" in added
    assert TP.trace is not None and TP.trace.__name__ == "trace"


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_the_reference_oracle(name):
    spec, _, (args, attrs) = _sample(name)
    dtype = _dtype(spec)
    cast = _cast_args(args, spec, "float32" if dtype == "int32" else dtype)
    fn = getattr(TP, name)
    got = fn(*[TP.to_tensor(a) if isinstance(a, np.ndarray) else a
               for a in cast], **attrs)
    ref = spec.oracle(*[np.asarray(a, np.float64)
                        if (isinstance(a, np.ndarray)
                            and np.issubdtype(a.dtype, np.floating))
                        else a for a in args], **attrs)
    gots = got if isinstance(got, (tuple, list)) else (got,)
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    tol = spec.tolerance(dtype)
    assert len(gots) >= len(refs)
    for g, r in zip(gots, refs):
        gv = np.asarray(g.numpy()) if hasattr(g, "numpy") else np.asarray(g)
        rv = np.asarray(r)
        kind = np.complex128 if (np.iscomplexobj(gv) or np.iscomplexobj(rv)) \
            else np.float64
        np.testing.assert_allclose(gv.astype(kind), rv.astype(kind),
                                   rtol=tol, atol=max(spec.atol, tol),
                                   equal_nan=True)


_GRAD_CASES = [name for name, spec in sorted(OPS.items()) if spec.grad]


def _ref_grad(spec, args, attrs, k):
    """The JAX package's gradient of Σ outputs (as fp32) with respect to
    ``args[k]``: ``jax.grad`` of the spec's own function, which is what
    the reference's tape records for the op (``jax.vjp`` of it), traced
    once."""
    import jax
    import jax.numpy as jnp

    def loss(xk):
        full = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args]
        full[k] = xk
        out = spec.fn(*full, **attrs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) * 1.0) for o in outs)

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(args[k])),
                      np.float64)


def _port_grad(name, args, attrs, k):
    """The port's gradient of the same loss through its public op."""
    tensors = [TP.to_tensor(a) if isinstance(a, np.ndarray) else a
               for a in args]
    tensors[k] = TP.to_tensor(args[k], stop_gradient=False)
    out = getattr(TP, name)(*tensors, **attrs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    loss = None
    for o in outs:
        term = (o.astype("float32") * 1.0).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return np.asarray(tensors[k].grad.numpy(), np.float64)


@pytest.mark.parametrize("name", _GRAD_CASES)
def test_gradient_matches_the_reference(name):
    spec, _, (args, attrs) = _sample(name)
    k = spec.grad_arg
    np.testing.assert_allclose(_port_grad(name, args, attrs, k),
                               _ref_grad(spec, args, attrs, k),
                               rtol=1e-4, atol=1e-5)
