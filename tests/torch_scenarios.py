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
tests beside them."""

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


def port_module(filename: str) -> types.ModuleType:
    """``tests/<filename>`` with ``paddle_tpu`` renamed
    ``paddle_tpu_torch``, executed as a fresh module (once)."""
    if filename not in _CACHE:
        path = os.path.join(_HERE, filename)
        with open(path) as f:
            src = re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", f.read())
        src = re.sub(r"^import numpy as np$", "np = _NP", src,
                     flags=re.M)
        mod = types.ModuleType("port_" + filename[:-3])
        mod.__file__ = path
        mod._NP = _NP
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


def scenario_ids(filename: str, skip=()) -> list:
    """The ids (``test_x``, ``TestY.test_x``, ``test_x[value]``) of the
    module's scenarios, in file order, without those in ``skip``."""
    mod = port_module(filename)
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
