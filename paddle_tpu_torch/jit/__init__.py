"""``paddle_tpu_torch.jit`` — counterpart of ``paddle_tpu/jit/__init__.py``
(dy2static, ``to_static``, ``TrainStep``).

The reference compiles with ``jax.jit``: ``to_static`` traces a Layer's
forward into one XLA program, ``TrainStep`` the whole training step
(forward, backward, clip, update, buffers). The port's compiled program
is a **CUDA graph**, one per input signature that :class:`CompileGuard`
sees (:class:`ProgramCache`): the first call of a signature runs the
body eagerly on a side stream (its real work; it also builds the
kernels and warms cuBLAS), then captures it; every later call copies
its inputs into the graph's static buffers and replays. A graph replays
exactly the kernels of the eager run, so a compiled program's results
are bitwise those of its body run eagerly on the same device (which is
what ``_graphs = False``, a private switch, does). A capture that fails
raises: there is no eager and no CPU fallback. On the CPU the body runs
on every call. The one exception is a data-dependent ``while`` (a graph
break, :mod:`.dy2static`): a program that hits one is counted and runs
eagerly on its device.

Inside a body every tensor is "traced" (``core.tensor.is_tracing``):
host reads raise, and dy2static takes the compiled routes. The key
stream folds into a per-call key that is a static device input
(``random.traced_key_scope``), so dropout masks differ per call.

The compiled train step takes the learning rate as an fp32 and the step
count as an int32 device scalar, written before each replay, as the
reference's compiled step takes them as arrays (its l.286-288); the
eager ``Optimizer.step`` passes Python numbers, so the two round
``beta ** step`` and the rate differently in the last bits. Parameters,
optimizer slots and buffers are updated in place (a graph reads them at
the addresses it captured).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import random as _random
from ..core import tensor as _tensor_mod
from ..core.tensor import Tensor
from ..inference import graphs as _graphs_mod
from ..inference import prng
from ..optimizer.optimizer import _lr_factor
from .dy2static import _leaves, _structure
from .functional import (  # noqa: F401
    bind, buffer_arrays, param_arrays, tree_unwrap, tree_wrap,
)

__all__ = ["RecompileWarning", "CompileGuard", "ProgramCache",
           "StaticFunction", "to_static", "TrainStep", "not_to_static",
           "enable_to_static"]


class RecompileWarning(UserWarning):
    """A compiled function saw a new input signature and recompiled."""


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, e) for e in tree)
    if isinstance(tree, dict):
        # visited in ``dy2static._leaves``' order, returned in the tree's
        done = {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    return fn(tree)


class CompileGuard:
    """Input-signature guard for compiled programs — the SOT-guard
    equivalent. Every new signature is a cache miss: it goes to
    ``observability.runtime.recompiles.record_miss`` (first compile
    included), and every miss after the first counts in
    ``recompile_count`` and warns with :class:`RecompileWarning`, so a
    shape leak in a training loop cannot capture a graph per step
    silently."""

    def __init__(self, name: str):
        self.name = name
        self._sigs: set = set()
        self.recompile_count = 0

    @staticmethod
    def signature(*trees):
        """The trees' structure and each leaf's (shape, dtype)."""
        leaves = _leaves(trees)
        out = [_structure(trees)]
        for v in leaves:
            v = v._value if isinstance(v, Tensor) else v
            if isinstance(v, torch.Tensor):
                out.append((tuple(v.shape), str(v.dtype)))
            else:
                out.append((tuple(getattr(v, "shape", ())),
                            str(getattr(v, "dtype", type(v).__name__))))
        return tuple(out)

    def check(self, *trees) -> bool:
        """Record the call signature; returns True when it misses the
        cache (the first call does not count as a recompile)."""
        sig = self.signature(*trees)
        if sig in self._sigs:
            return False
        miss = bool(self._sigs)
        self._sigs.add(sig)
        # record_miss, not note: _sigs already dedupes per instance, and
        # two same-named guards must each count their own recompiles
        from ..observability.runtime import recompiles
        recompiles.record_miss(f"jit.{self.name}", sig)
        if miss:
            self.recompile_count += 1
            warnings.warn(
                f"{self.name}: input signature changed (seen "
                f"{len(self._sigs)} distinct signatures) -> CUDA graph "
                f"recapture #{self.recompile_count}. Pad/bucket inputs to "
                "stable shapes to avoid per-step compilation.",
                RecompileWarning, stacklevel=3)
        return miss


class _Entry:
    __slots__ = ("statics", "captured", "eager")

    def __init__(self, statics):
        self.statics = statics
        self.captured: Optional[_graphs_mod.Captured] = None
        self.eager = False


def _breaks() -> int:
    from .dy2static import graph_breaks
    return sum(graph_breaks.values())


class ProgramCache:
    """The compiled programs of one function: a CUDA graph per signature
    on the card (module docstring), the body itself on the CPU. Warm-up
    and capture are ``inference.graphs``' (:func:`~..inference.graphs.
    capture`), the one capture path of the port.

    :meth:`run` takes the signature key, the body and the body's input
    tensors; the body returns a tree of tensors. A replay's outputs are
    the graph's own buffers, so they are cloned before they are
    returned (a caller may keep them across calls). Each graph has its
    own memory pool: the programs of different signatures never share
    intermediates. A capture that raises leaves its signature
    uncaptured: the next call warms up and captures again."""

    def __init__(self, name: str):
        self.name = name
        self.entries: Dict[Any, _Entry] = {}
        #: private switch: False runs the body eagerly on the card on
        #: every call (the run the graphs are held against)
        self.graphs = True
        self.captures = 0
        #: seconds of each capture, in order
        self.capture_seconds: List[float] = []
        #: signatures whose body hit a data-dependent ``while`` (run
        #: eagerly on their device)
        self.graph_breaks = 0
        self._stream: Optional[torch.cuda.Stream] = None

    def _body(self, body, inputs):
        _tensor_mod._tracing[0] += 1
        try:
            return body(*inputs)
        finally:
            _tensor_mod._tracing[0] -= 1

    def run(self, key, body: Callable, inputs: List[torch.Tensor],
            device: torch.device):
        if device.type != "cuda":
            return self._body(body, inputs)
        # on the card every input is a device tensor, as in the graph (a
        # CPU scalar tensor would take torch's host-scalar kernels)
        inputs = [t.to(device) for t in inputs]
        if not self.graphs:
            return self._body(body, inputs)
        entry = self.entries.get(key)
        if entry is not None and entry.eager:
            return self._body(body, inputs)
        if entry is None:
            entry = self.entries[key] = _Entry(
                [torch.empty_like(t, device=device) for t in inputs])
        for s, t in zip(entry.statics, inputs):
            s.copy_(t, non_blocking=True)
        if entry.captured is not None:
            return _tree_map(lambda v: v.clone()
                             if isinstance(v, torch.Tensor) else v,
                             entry.captured.replay())
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)

        def run():
            return self._body(body, entry.statics)
        before = _breaks()
        out = _graphs_mod.warm_up(run, self._stream, device)
        if _breaks() != before:
            entry.eager = True
            self.graph_breaks += 1
            return out
        entry.captured = _graphs_mod.capture(run, self._stream, device)
        self.captures += 1
        self.capture_seconds.append(entry.captured.seconds)
        return out


def _host_key() -> torch.Tensor:
    """The next key of the framework stream, as a CPU (2,) int64."""
    k = _random.next_key()
    return k.detach().cpu() if isinstance(k, torch.Tensor) else k


def _layer_device(layer) -> Optional[torch.device]:
    for p in layer.parameters():
        return p.device
    for b in layer.buffers():
        return b.device
    return None


def _is_array(v) -> bool:
    """Whether an argument leaf is an input of the compiled program: a
    tensor, a numpy array or a Python number. ``jax.jit`` traces all of
    them (a Python number as a weakly typed scalar), so the body sees
    each as a Tensor and a new value replays the same program."""
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float))


def _program_inputs(leaves):
    """``(inputs, statics)`` of a call's argument leaves: the array
    leaves as tensors (numbers and numpy arrays in the canonical dtypes
    on the host: a Python float is fp32, an int int32, as under
    ``jax.jit``), and the other leaves themselves (None, strings, other
    objects), which the body reads as constants and which therefore key
    the program by their values. An unhashable constant raises, as
    ``jax.jit`` raises on a leaf that is not an array."""
    inputs, statics = [], []
    for v in leaves:
        if isinstance(v, torch.Tensor):
            inputs.append(v)
        elif _is_array(v):
            inputs.append(_tensor_mod.to_torch(v, "cpu"))
        else:
            try:
                hash(v)
            except TypeError:
                raise TypeError(
                    f"an argument of type {type(v).__name__} is neither "
                    "an array nor a hashable constant: a compiled "
                    "function takes tensors, numpy arrays, Python numbers "
                    "and hashable constants") from None
            statics.append(v)
    return inputs, tuple(statics)


class StaticFunction:
    """A compiled forward (inference/eval) over an imperative fn/Layer.

    The wrapped fn passes through the dy2static AST rewrite first
    (:mod:`.dy2static`), so data-dependent Python ``if``/``while`` over
    Tensors take the compiled routes instead of failing. When building
    still fails (a ConversionError, a host read of a traced value, an
    unrollable iteration) and ``FLAGS_dy2static_fallback`` is on (the
    default), the call falls back to the EAGER path with a warning and
    stays eager — the reference's graceful fallback;
    ``FLAGS_dy2static_fallback=0`` restores the strict raise. The
    compiled forward is not differentiable (its output stops gradients),
    as the reference's jitted forward."""

    def __init__(self, fn: Callable, layer=None, donate_params: bool = False):
        from .dy2static import convert_control_flow
        self._orig_fn = fn
        self._fn = convert_control_flow(fn)
        self._layer = layer
        self._fallback = False
        self.guard = CompileGuard(getattr(fn, "__name__", "to_static"))
        self.programs = ProgramCache(self.guard.name)

    @property
    def _graphs(self) -> bool:
        return self.programs.graphs

    @_graphs.setter
    def _graphs(self, on: bool) -> None:
        self.programs.graphs = bool(on)

    def _device(self, tensors) -> torch.device:
        for t in tensors:
            if t.device.type == "cuda":
                return t.device
        dev = _layer_device(self._layer) if self._layer is not None else None
        if dev is not None:
            return dev
        return tensors[0].device if tensors else torch.device("cpu")

    def __call__(self, *args, **kwargs):
        if self._fallback:
            return self._orig_fn(*args, **kwargs)
        uargs, ukwargs = tree_unwrap(args), tree_unwrap(kwargs)
        leaves = _leaves((uargs, ukwargs))
        inputs, statics = _program_inputs(leaves)
        self.guard.check(uargs, ukwargs)
        tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
        key = _host_key()
        device = self._device(tensors)
        structure = (uargs, ukwargs)
        fn = self._fn

        def body(*ins):
            it = iter(ins[:-1])
            a, kw = _tree_map(lambda v: next(it) if _is_array(v) else v,
                              structure)
            with torch.no_grad(), _random.traced_key_scope(ins[-1]):
                out = fn(*tree_wrap(a), **tree_wrap(kw))
            return tree_unwrap(out)

        from .dy2static import ConversionError
        training = bool(getattr(self._layer, "training", False))
        try:
            out = self.programs.run(
                (self.guard.signature(uargs, ukwargs), training, statics),
                body, inputs + [key], device)
        except (ConversionError, _tensor_mod.TracedIterationError,
                _tensor_mod.ConcretizationError) as e:
            from ..flags import flag_value
            if not flag_value("dy2static_fallback"):
                raise
            warnings.warn(
                f"{self.guard.name}: tracing failed "
                f"({type(e).__name__}: {str(e).splitlines()[0]}); falling "
                "back to the EAGER path for this and future calls — the "
                "function will not be compiled "
                "(FLAGS_dy2static_fallback=0 restores the strict raise)",
                stacklevel=2)
            self._fallback = True
            return self._orig_fn(*args, **kwargs)
        return tree_wrap(out)

    @property
    def recompile_count(self) -> int:
        return self.guard.recompile_count


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Parity with ``paddle.jit.to_static`` (decorator or call form). A
    Layer gets its ``forward`` replaced by a :class:`StaticFunction`."""
    from ..nn.layer import Layer

    def decorate(fn):
        if isinstance(fn, Layer):
            sf = StaticFunction(fn.forward, layer=fn)
            fn.forward = sf
            return fn
        layer = getattr(fn, "__self__", None)
        if isinstance(layer, Layer):
            return StaticFunction(fn, layer=layer)
        return StaticFunction(fn, layer=None)

    if function is not None:
        return decorate(function)
    return decorate


def keep_slots(opt, held) -> None:
    """Copy every optimizer state slot that an update rebound back into
    the slot's own tensor (``held``: ``{name: dict(state)}`` taken
    before the update) and bind it again: a CUDA graph's next replay
    reads what this one wrote."""
    for n, s in opt.state.items():
        old = held.get(n, {})
        for k, v in list(s.items()):
            o = old.get(k)
            if o is not None and v is not o:
                o.copy_(v)
                s[k] = o


def compiled_update(opt, lr: torch.Tensor, t: torch.Tensor) -> None:
    """One optimizer update inside a compiled program: the optimizer's
    own clip and ``_apply`` with the rate ``lr`` (fp32) and the step
    ``t`` (int32) as device scalars, the state updated in place
    (:func:`keep_slots`). A group-sharded optimizer makes its own
    (``_sharded_update``: the same arithmetic on its slabs)."""
    if hasattr(opt, "_sharded_update"):
        return opt._sharded_update(lr, t)
    held = {n: dict(s) for n, s in opt.state.items()}
    items = []
    for name, p, g in opt._live():
        wd = opt._weight_decay if opt._decay_enabled(name, p) else 0.0
        f = _lr_factor(p)
        items.append((name, p, g, lr if f == 1.0 else lr * f, wd))
    opt._apply(items, t)
    keep_slots(opt, held)


class TrainStep:
    """One compiled training step: forward + backward + clip + optimizer
    update + buffer updates, as one CUDA graph per batch signature.

    ``loss_fn(model, *batch) -> scalar Tensor``. Each call advances the
    optimizer's step count, reads its learning rate on the host and
    draws one key from the framework stream, as the reference's
    ``TrainStep.__call__`` (its l.269-290); the body clears the
    gradients to None, runs the forward and ``backward``, and updates
    the parameters, the optimizer state (made for every trainable
    parameter at construction, as the reference's l.201-203) and the
    buffers in place. The gradients are None again after the call. The
    returned loss is a Tensor.

    ``in_shardings`` (the reference accepts it and places nothing): how
    the batch splits over the global mesh, a ``parallel.mesh.
    SlabSharding`` or ``PartitionSpec`` for every batch array, or a
    list with one per batch argument (None: whole). Every rank passes
    the global batch and the step takes its slab; the gradients are then
    averaged over the axes that split the batch (data parallelism), so
    the update is the global batch's. With one rank on those axes the
    step is the plain one."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 in_shardings=None, donate: bool = True):
        self.in_shardings = in_shardings
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.guard = CompileGuard(type(self).__name__)
        self.programs = ProgramCache("TrainStep")
        ids = {id(p) for p in model.parameters()}
        for name, p in zip(optimizer._names, optimizer._parameter_list):
            if id(p) in ids and getattr(p, "trainable", p.requires_grad):
                optimizer._state_of(name, p)
        self._params = list(model.parameters())
        self._multi: Dict[int, Callable] = {}

    @property
    def _graphs(self) -> bool:
        return self.programs.graphs

    @_graphs.setter
    def _graphs(self, on: bool) -> None:
        self.programs.graphs = bool(on)
        for run in self._multi.values():
            run.programs.graphs = bool(on)

    def _device(self) -> torch.device:
        return _layer_device(self.model) or torch.device("cpu")

    def _buffer_slots(self):
        return [(m, n, b) for m in self.model.modules()
                for n, b in m._buffers.items() if b is not None]

    def _body(self, batch, key, lr, t):
        """One step over torch tensors; returns the loss (0-d)."""
        model, opt = self.model, self.optimizer
        bufs = self._buffer_slots()
        with _random.traced_key_scope(key):
            for p in self._params:
                p.grad = None
            with torch.enable_grad():
                loss = self.loss_fn(model, *tree_wrap(list(batch)))
                raw = loss._value if isinstance(loss, Tensor) else loss
                raw.backward()
        with torch.no_grad():
            self._update(lr, t)
            # a layer that rebinds a buffer: write the new value into the
            # buffer the graph reads, and bind it back
            for m, n, b in bufs:
                new = m._buffers.get(n)
                if new is not b and new is not None:
                    b.copy_(new)
                    m._buffers[n] = b
        for p in self._params:
            p.grad = None
        return self._report(raw.detach())

    def _report(self, loss):
        """The loss returned: the mean over the groups that split the
        batch (each rank's is its slab's)."""
        from ..distributed import collective as C
        for g in self._batch_groups():
            loss = C._raw_all_reduce(loss, g, "avg")
        return loss

    def _batch_shardings(self, n: int) -> list:
        from ..parallel import mesh as _mesh
        sh = self.in_shardings
        if sh is None:
            return [None] * n
        if not isinstance(sh, (list, tuple)) or isinstance(
                sh, _mesh.PartitionSpec):
            sh = [sh] * n
        return [None if s is None else _mesh._sharding(s, None) for s in sh]

    def _batch_slabs(self, vals: list, lead: int = 0) -> list:
        """This rank's slab of each batch array under ``in_shardings``
        (past ``lead`` leading dims that stay whole)."""
        out = []
        for v, s in zip(vals, self._batch_shardings(len(vals))):
            if s is not None and isinstance(v, torch.Tensor) \
                    and v.dim() > lead:
                v = v[(slice(None),) * lead + s.index(tuple(v.shape[lead:]))]
            out.append(v)
        return out

    def _batch_groups(self) -> list:
        """The mesh groups that split the batch (more than one rank)."""
        groups, seen = [], set()
        for s in self._batch_shardings(1 if not isinstance(
                self.in_shardings, (list, tuple)) else len(
                self.in_shardings)):
            if s is None:
                continue
            for a in s.spec.axes(0):
                g = s.mesh.group(a)
                if a not in seen and g is not None and g.nranks > 1:
                    seen.add(a)
                    groups.append(g)
        return groups

    def _update(self, lr, t) -> None:
        """The update after the backward: the gradients averaged over the
        groups that split the batch, then :func:`compiled_update`."""
        from ..distributed import collective as C
        for g in self._batch_groups():
            for p in self._params:
                if p.grad is not None:
                    C.all_reduce(p.grad, op="avg", group=g)
        compiled_update(self.optimizer, lr, t)

    def _scalars(self, step: int):
        opt = self.optimizer
        lr = torch.tensor(opt.get_lr(), dtype=torch.float32)
        t = torch.tensor(step, dtype=torch.int32)
        return lr, t

    def __call__(self, *batch):
        vals = self._batch_slabs([v for v in tree_unwrap(list(batch))])
        self.guard.check(tuple(vals))
        opt = self.optimizer
        opt._step_count += 1
        lr, t = self._scalars(opt._step_count)
        key = _host_key()
        n = len(vals)

        def body(*ins):
            return self._body(ins[:n], ins[n], ins[n + 1], ins[n + 2])

        loss = self.programs.run(self.guard.signature(tuple(vals)), body,
                                 vals + [key, lr, t], self._device())
        return Tensor._wrap(loss, True)

    def multi_step(self, k: int):
        """``k`` optimizer steps in ONE dispatch (one graph of ``k``
        bodies). Returns a callable with the step's batch signature,
        except every batch array carries a leading ``k`` axis (one slice
        per inner step). The LR is read once per dispatch (a scheduler's
        value is shared by the k inner steps), each inner step draws its
        own key (``k`` split keys), and the returned loss is the last
        inner step's — the reference's contract."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k in self._multi:
            return self._multi[k]
        guard = CompileGuard(f"TrainStep.multi_step[{k}]")
        programs = ProgramCache(f"TrainStep.multi_step[{k}]")
        programs.graphs = self.programs.graphs
        opt = self.optimizer

        def run(*batch):
            vals = self._batch_slabs([v for v in tree_unwrap(list(batch))],
                                     lead=1)
            for leaf in vals:
                shape = tuple(getattr(leaf, "shape", ()))
                if len(shape) == 0 or shape[0] != k:
                    raise ValueError(
                        f"multi_step({k}) batch arrays need a leading "
                        f"{k} axis; got shape {shape}")
            guard.check(tuple(vals))
            base_step = opt._step_count + 1
            opt._step_count += k
            lr, t = self._scalars(base_step)
            keys = prng.split(_host_key(), k)
            n = len(vals)

            def body(*ins):
                xs, ks, lr_d, t_d = ins[:n], ins[n], ins[n + 1], ins[n + 2]
                loss = None
                for i in range(k):
                    loss = self._body([x[i] for x in xs], ks[i], lr_d,
                                      t_d + i)
                return loss

            loss = programs.run(guard.signature(tuple(vals)), body,
                                vals + [keys, lr, t], self._device())
            return Tensor._wrap(loss, True)

        run.guard = guard
        run.programs = programs
        self._multi[k] = run
        return run


def not_to_static(fn):
    return fn


def enable_to_static(flag: bool):
    pass


from .save_load import save, load, TranslatedLayer  # noqa: E402,F401
from .bucketing import ShapeBucketer, pad_to_bucket, next_bucket  # noqa: E402,F401
from .dy2static import ConversionError, convert_control_flow  # noqa: E402,F401
from .fusion import (FusionCandidate, FusionPass, FusionPlan,  # noqa: E402,F401
                     FusionRegion, FusedOptimizerStep,
                     install_optimizer_fusion, stage_eager)
from .fusion import REGIONS as FUSION_REGIONS  # noqa: E402,F401
