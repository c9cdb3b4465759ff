"""The JAX package's own test scenarios, run through the PyTorch port.

:func:`port_scenarios` reads a test module of the JAX package, renames
the package in its source to ``paddle_tpu_torch`` and runs the result as
a module of its own, so each scenario (its inputs, its numpy oracle and
its assertions) runs unchanged through the port. A test file
parametrises over the ids and calls :func:`run`, which supplies the
pytest fixtures a scenario asks for, and expands a scenario's own
``pytest.mark.parametrize`` into one id a value. The module's ``np`` is
numpy with one change: ``np.asarray`` / ``np.array`` read a torch
tensor detached (the reference's ``Tensor._value`` is a host-readable
array; the port's is a torch tensor, which numpy reads only without its
graph). Scenarios that reach the JAX package's internals otherwise are
left out by the caller, with the reason, and covered by port-written
tests beside them.

``port_module(filename, jax_shim=True)`` also renames the scenario's
``jax`` and ``jax.numpy`` imports to :data:`JAX` / :data:`JNP`, the
port's counterparts of the few calls such scenarios make:
``jax.jit(fn)`` runs ``fn`` over torch tensors as the body of a compiled
program of the port (every tensor "traced", ``core.tensor._tracing``),
``jnp.asarray`` / ``zeros`` / ``ones`` / ... make torch tensors with the
reference's x64-off dtypes, and ``jax.errors.TracerBoolConversionError``
is the error torch raises for the truth value of a many-element tensor
(the port's counterpart of a traced value's ``bool``)."""

from __future__ import annotations

import inspect
import os
import re
import types

import numpy as _numpy

_HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE: dict = {}


def _host(x):
    import torch
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


class _Numpy(types.ModuleType):
    """numpy, reading torch tensors detached in ``asarray`` / ``array``."""

    def __getattr__(self, name):
        return getattr(_numpy, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return _numpy.asarray(_host(a), *args, **kw)

    @staticmethod
    def array(a, *args, **kw):
        return _numpy.array(_host(a), *args, **kw)


_NP = _Numpy("numpy")


def _torch_value(a):
    import torch
    from paddle_tpu_torch.core.tensor import Tensor, to_torch
    if isinstance(a, Tensor):
        return a._value
    if isinstance(a, torch.Tensor):
        return a
    return to_torch(a, device="cpu")


def _jit(fn):
    """``jax.jit(fn)``: ``fn`` run over torch tensors as a compiled
    program's body (the port's tracing scope)."""
    def run(*args):
        from paddle_tpu_torch.core import tensor as T
        xs = [_torch_value(a) for a in args]
        T._tracing[0] += 1
        try:
            out = fn(*xs)
        finally:
            T._tracing[0] -= 1
        if isinstance(out, (tuple, list)):
            return type(out)(_torch_value(o) for o in out)
        return _torch_value(out)
    return run


class _Jnp(types.ModuleType):
    """The ``jax.numpy`` calls of the dy2static scenarios, over torch."""

    def __getattr__(self, name):
        import torch
        dtypes = {"float32": torch.float32, "int32": torch.int32,
                  "bfloat16": torch.bfloat16, "bool_": torch.bool}
        if name in dtypes:
            return dtypes[name]
        fns = {"asarray": lambda a, dtype=None: (
                   _torch_value(a) if dtype is None
                   else _torch_value(a).to(dtype)),
               "zeros": lambda shape, dtype=torch.float32: torch.zeros(
                   shape, dtype=dtype),
               "ones": lambda shape, dtype=torch.float32: torch.ones(
                   shape, dtype=dtype),
               "argmax": lambda a, axis=None: torch.argmax(
                   _torch_value(a), dim=axis),
               "take": lambda a, i, axis=None: torch.index_select(
                   _torch_value(a), axis or 0,
                   _torch_value(i).reshape(1).long())[0],
               "sqrt": lambda a: torch.sqrt(_torch_value(a)),
               "abs": lambda a: torch.abs(_torch_value(a))}
        if name in fns:
            return fns[name]
        raise AttributeError(f"jax.numpy.{name} has no port counterpart "
                             "in the scenario runner")


def _dynamic_update_slice(buf, upd, start):
    out = buf.clone()
    idx = tuple(slice(int(s), int(s) + n) for s, n in zip(start, upd.shape))
    out[idx] = upd
    return out


JNP = _Jnp("jax.numpy")
JAX = types.SimpleNamespace(
    jit=_jit, numpy=JNP,
    errors=types.SimpleNamespace(TracerBoolConversionError=RuntimeError),
    lax=types.SimpleNamespace(dynamic_update_slice=_dynamic_update_slice))


def port_module(filename: str, jax_shim: bool = False) -> types.ModuleType:
    """``tests/<filename>`` with ``paddle_tpu`` renamed
    ``paddle_tpu_torch``, executed as a fresh module (once). With
    ``jax_shim`` its ``jax`` imports are the port's counterparts
    (module docstring)."""
    if filename not in _CACHE:
        path = os.path.join(_HERE, filename)
        with open(path) as f:
            src = re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", f.read())
        src = re.sub(r"^import numpy as np$", "np = _NP", src,
                     flags=re.M)
        if jax_shim:
            src = re.sub(r"^import jax$", "jax = _JAX", src, flags=re.M)
            src = re.sub(r"^import jax\.numpy as jnp$", "jnp = _JNP", src,
                         flags=re.M)
        mod = types.ModuleType("port_" + filename[:-3])
        mod.__file__ = path
        mod._NP = _NP
        mod._JAX, mod._JNP = JAX, JNP
        exec(compile(src, path, "exec"), mod.__dict__)
        _CACHE[filename] = mod
    return _CACHE[filename]


def _params(fn):
    """``[(argname, value), ...]`` for each case of the function's own
    single-name ``parametrize`` mark, or ``[None]``."""
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            name, values = mark.args[0], mark.args[1]
            return [(name, v) for v in values]
    return [None]


def _label(value):
    return getattr(value, "__name__", str(value))


def _expand(sid, fn):
    return [sid if p is None else f"{sid}[{_label(p[1])}]"
            for p in _params(fn)]


def scenario_ids(filename: str, skip=(), jax_shim: bool = False) -> list:
    """The ids (``test_x``, ``TestY.test_x``, ``test_x[value]``) of the
    module's scenarios, in file order, without those in ``skip``."""
    mod = port_module(filename, jax_shim)
    out = []
    for name, v in vars(mod).items():
        if name.startswith("test") and inspect.isfunction(v):
            out += _expand(name, v)
        elif name.startswith("Test") and inspect.isclass(v):
            for m, fn in vars(v).items():
                if m.startswith("test"):
                    out += _expand(f"{name}.{m}", fn)
    return [i for i in out if i not in skip]


def run(filename: str, scenario: str, request) -> None:
    """Run one scenario, its fixtures taken from pytest's ``request``."""
    mod = port_module(filename)
    base, _, case = scenario.partition("[")
    cls_name, _, fn_name = base.rpartition(".")
    fn = getattr(getattr(mod, cls_name)(), fn_name) if cls_name \
        else getattr(mod, fn_name)
    kwargs = {}
    for p in _params(getattr(fn, "__func__", fn)):
        if p is not None and f"{_label(p[1])}]" == case:
            kwargs[p[0]] = p[1]
    kwargs.update({p: request.getfixturevalue(p)
                   for p in inspect.signature(fn).parameters
                   if p not in kwargs})
    fn(**kwargs)
