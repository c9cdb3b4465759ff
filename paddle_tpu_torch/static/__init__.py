"""``paddle_tpu_torch.static`` — counterpart of ``paddle_tpu/static``:
the static-graph surface that dygraph-era scripts consume.

The reference's static graph engine (ProgramDesc + StandaloneExecutor,
SURVEY.md §2.1) is replaced by compiled programs (``jit``): ``InputSpec``
declares shapes, ``save_inference_model``/``load_inference_model`` go
through ``jit.save``/``jit.load`` (a ``torch.export`` program), and
``Executor.run`` feeds and fetches a loaded program. Graph *building*
(``default_main_program``) raises, as in the reference; the legacy
script shims (``data``, ``program_guard``, ...) keep feed/fetch scripts
running.
"""

from __future__ import annotations

from ..core.dtype import convert_dtype


class InputSpec:
    """Shape/dtype declaration for jit/save surfaces (reference:
    python/paddle/static/input.py:§0)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=False):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), str(tensor.dtype), name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)


# ---------------------------------------------------------------------------
# Executor / inference-model IO (SURVEY.md §2.1 standalone-executor row)
# ---------------------------------------------------------------------------
class Program:
    """A compiled program handle. The reference's ProgramDesc/PIR Program is
    replaced by a serialized program (jit.save); this wrapper gives
    Executor.run a feed/fetch surface over it."""

    def __init__(self, translated=None):
        self._translated = translated
        n = len(translated.input_spec) if translated is not None else 0
        self.feed_names = [f"x{i}" for i in range(n)]
        n_out = translated.n_outputs if translated is not None else 0
        self.fetch_names = [f"out{i}" for i in range(n_out)]

    def __call__(self, *args):
        return self._translated(*args)


class CompiledProgram(Program):
    """Parity alias (reference: paddle.static.CompiledProgram)."""


def default_main_program():
    raise NotImplementedError(
        "graph-building static mode is replaced by compiled programs; use "
        "paddle_tpu_torch.jit.to_static / jit.save, then Executor.run on "
        "the loaded program")


default_startup_program = default_main_program


class Executor:
    """Runs loaded inference programs (reference: StandaloneExecutor via
    paddle.static.Executor.run — SURVEY.md §3.4); run() is dispatch +
    fetch. Fetches are numpy arrays (``return_numpy``) or torch
    tensors."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program: "Program" = None, feed=None, fetch_list=None,
            return_numpy: bool = True):
        import numpy as _np
        if program is None or program._translated is None:
            raise ValueError("Executor.run needs a loaded Program "
                             "(static.load_inference_model)")
        feed = feed or {}
        args = []
        for name in program.feed_names:
            if name not in feed:
                raise ValueError(f"missing feed '{name}' "
                                 f"(expected {program.feed_names})")
            args.append(feed[name])
        out = program(*args)
        outs = list(out) if isinstance(out, tuple) else [out]
        program.fetch_names = [f"out{i}" for i in range(len(outs))]
        vals = [o._value for o in outs]
        if fetch_list:
            idx = []
            for f in fetch_list:
                if isinstance(f, int):
                    idx.append(f)
                elif isinstance(f, str) and f.startswith("out") \
                        and f[3:].isdigit():
                    idx.append(int(f[3:]))
                else:
                    raise ValueError(
                        f"unknown fetch {f!r}; valid fetches are indices or "
                        f"{program.fetch_names}")
            vals = [vals[i] for i in idx]
        return [(v.detach().cpu().numpy() if return_numpy else v)
                for v in vals]

    def close(self):
        pass


def load_inference_model(path_prefix: str, executor: "Executor" = None):
    """Returns (program, feed_names, fetch_names) — reference signature."""
    from ..jit.save_load import load as _load
    prog = Program(_load(path_prefix))
    return prog, list(prog.feed_names), prog.fetch_names


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, program=None, layer=None,
                         input_spec=None):
    """Save a Layer as an inference program (jit.save under the hood).

    The reference extracts a pruned ProgramDesc from feed/fetch vars; here
    the model must be passed explicitly (``layer`` + ``input_spec``, where
    input_spec defaults to ``feed_vars`` when those are InputSpecs/arrays).
    """
    from ..jit.save_load import save as _save
    target = layer if layer is not None else program
    spec = input_spec or feed_vars
    if target is None:
        raise ValueError("save_inference_model needs layer= (an nn.Layer)")
    _save(target, path_prefix, input_spec=spec)


# ---------------------------------------------------------------------------
# legacy static-era script surface: the names static scripts import at
# module top. Graph BUILDING stays replaced by compiled programs (the
# design stance above); these shims let eval/serving scripts that only
# feed/fetch keep working unchanged.
# ---------------------------------------------------------------------------
import contextlib as _contextlib


def data(name, shape, dtype="float32", lod_level=0):
    """Placeholder declaration → InputSpec (the reference creates a graph
    Variable; the spec is what jit.save consumes)."""
    return InputSpec([s if s is not None and s >= 0 else None
                      for s in shape], dtype, name)


@_contextlib.contextmanager
def program_guard(main_program=None, startup_program=None):
    """No-op scope: programs are compiled, not built (kept so `with
    paddle.static.program_guard(...)` blocks run unchanged)."""
    yield


@_contextlib.contextmanager
def scope_guard(scope=None):
    yield


@_contextlib.contextmanager
def name_scope(prefix=None):
    yield


@_contextlib.contextmanager
def device_guard(device=None):
    yield


class _GlobalScope:
    def find_var(self, name):
        return None

    def var(self, name):
        return None


_scope = _GlobalScope()


def global_scope():
    return _scope


def cuda_places(device_ids=None):
    import torch
    from ..core.place import CUDAPlace
    n = torch.cuda.device_count()
    ids = device_ids if device_ids is not None else range(n)
    return [CUDAPlace(i) for i in ids]


def cpu_places(device_count=1):
    from ..core.place import CPUPlace
    return [CPUPlace() for _ in range(device_count)]

from . import nn  # noqa: E402,F401  (static.nn builders)
