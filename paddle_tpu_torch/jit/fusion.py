"""Profile-guided fusion pass — counterpart of ``paddle_tpu/jit/fusion.py``.

:class:`FusionPass` reads the hot-chain artifact that
``observability.profiling.DispatchChainProfiler`` exports
(``paddle_tpu.hot_chains``), maps ranked chains to declared **fusable
regions** (:data:`REGIONS`) and :meth:`FusionPlan.apply` installs them:
the continuous-batching engine's decode tail (``decode_tail``:
``engine.enable_fused_tail()``) and the optimizer's grad-transform →
update chain (``optimizer_chain``: :class:`FusedOptimizerStep`).

Admission discipline, as in the reference:

* **byte-identical** outputs fused vs. unfused. The fused decode tail
  runs the unified step's own body over a packed plan (two uploads a
  step instead of one per plan array); the fused optimizer step replays
  the optimizer's own clip and ``_apply`` code in one program, with the
  per-step host scalars staged as the exact values the eager kernels
  receive (below), so fusing never changes a bit of training state;
* **recompile-count-neutral**: fused programs have the unfused ones'
  signatures.

Degradation contract: a stale artifact (symbols renamed since the
capture, an incompatible schema) produces structured ``fusion_skipped``
events — one per chain per process — and
``paddle_fusion_skipped_total{reason}`` counts, never an exception.

Eager-granularity staging (the bit-exactness mechanism)
-------------------------------------------------------

The reference stages a traced jaxpr with a contraction fence after every
floating-point equation (:func:`stage_eager` there), because XLA
contracts and re-associates a fused program. A CUDA graph contracts
nothing: it replays the eager kernels. What a graph would freeze are the
host scalars the eager step passes to its kernels — the learning rate
and the bias corrections ``1 − β^t`` change every step. In the fused
step they are :class:`HostScalar` floats: arithmetic with Python numbers
stays on the host in float64, as in the eager step, and where one
reaches a torch function (``_StageMode``, a ``TorchFunctionMode``) it is
replaced by one element of a staged fp32 device vector holding the
value the eager kernel would have received: the scalar rounded to fp32
for products and sums; for a division by a host scalar the form that
reproduces the eager kernel, learned once per function and device on a
calibration input (``_div_rule``: a true division by fp32(s), or a
product with the reciprocal rounded once from float64, which is how
CUDA's ``div`` and ``_foreach_div`` by a host scalar compute). The host writes the vector through one pinned
staging buffer before each call. :func:`stage_eager` is this module's
counterpart of the reference's function: it stages any eager function
of host scalars so.
"""

from __future__ import annotations

import json
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..observability.events import emit_event
from ..observability.profiling import (PROFILE_VERSION, chain_armed,
                                       dispatch_sites, note_chain)
from ..observability.registry import get_registry
from ..observability.runtime import recompiles
from ..optimizer.optimizer import _lr_factor

#: the artifact this pass consumes (DispatchChainProfiler.export)
ARTIFACT_KIND = "paddle_tpu.hot_chains"

_reg = get_registry()
_admitted_total = _reg.counter(
    "paddle_fusion_admitted_total",
    "hot chains admitted and installed as fused megaregions, by region",
    labels=("region",))
_skipped_total = _reg.counter(
    "paddle_fusion_skipped_total",
    "hot chains the fusion pass skipped (stale artifact, schema "
    "mismatch, no declared region), by reason",
    labels=("reason",))
_active = _reg.gauge(
    "paddle_fusion_active",
    "1 while a fused megaregion is installed for the region",
    labels=("region",))

#: (chain ops tuple, reason) pairs already reported — the skip event is
#: emitted once per chain per process, the counter counts every skip
_skip_noted: set = set()

#: region name -> weak references to the installed targets; the active
#: gauge reflects whether any install target is still alive
_installed_targets: Dict[str, Any] = {}


def _refresh_active_gauges() -> None:
    for region, refs in _installed_targets.items():
        alive = [r for r in refs if r() is not None]
        _installed_targets[region] = alive
        _active.set(1.0 if alive else 0.0, region=region)


def _note_install(region: str, target: Any) -> None:
    try:
        ref = weakref.ref(target)
    except TypeError:               # unweakrefable target: pin forever
        ref = (lambda t=target: t)
    _installed_targets.setdefault(region, []).append(ref)


# ---------------------------------------------------------------------------
# Fusable regions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FusionRegion:
    """A declared fusable region: a named rewrite this tree knows how to
    install, matched against hot chains by op signature. ``signatures``
    are contiguous op subsequences as they appear in the artifact;
    ``target`` names the keyword :meth:`FusionPlan.apply` installs on."""

    name: str
    signatures: Tuple[Tuple[str, ...], ...]
    target: str                     # "engine" | "optimizer"
    doc: str = ""

    def match(self, ops: Sequence[str]) -> Optional[Tuple[str, ...]]:
        """The first signature appearing contiguously in ``ops``."""
        ops = tuple(ops)
        for sig in self.signatures:
            n = len(sig)
            if any(ops[i:i + n] == sig
                   for i in range(len(ops) - n + 1)):
                return sig
        return None


#: built-in regions (a test/bench may register more via REGIONS)
REGIONS: Dict[str, FusionRegion] = {
    "decode_tail": FusionRegion(
        name="decode_tail",
        signatures=(("cbe.unified_step", "cbe.decode_tail"),
                    ("cbe.plan_step", "cbe.unified_step"),
                    ("cbe.spec_step", "cbe.decode_tail")),
        target="engine",
        doc="unified ragged step's decode tail: packed plan upload, "
            "vectorized steady-state planning "
            "(ContinuousBatchingEngine.enable_fused_tail)"),
    "optimizer_chain": FusionRegion(
        name="optimizer_chain",
        signatures=(("grad_clip", "optimizer_update"),
                    ("optimizer_update", "optimizer_update"),
                    ("optimizer_update",)),
        target="optimizer",
        doc="eager grad transform -> per-param optimizer update chain "
            "fused into ONE bit-exact program (FusedOptimizerStep)"),
    "sampling_epilogue": FusionRegion(
        name="sampling_epilogue",
        signatures=(("cbe.unified_step", "cbe.sample_epilogue"),
                    ("cbe.sample_epilogue", "cbe.decode_tail"),
                    ("cbe.spec_step", "cbe.sample_epilogue")),
        target="engine",
        doc="the sampling epilogue in the same decode-tail program as "
            "the ragged step (ContinuousBatchingEngine.enable_fused_tail)"),
}


@dataclass
class FusionCandidate:
    region: FusionRegion
    ops: Tuple[str, ...]
    matched: Tuple[str, ...]
    count: int = 0
    est_us: float = 0.0


@dataclass
class FusionPlan:
    """The pass output: chains mapped to installable regions plus the
    structured skips. ``apply`` installs each candidate on the matching
    duck-typed target and reports what it did."""

    candidates: List[FusionCandidate] = field(default_factory=list)
    skipped: List[Dict[str, Any]] = field(default_factory=list)

    def candidate(self, region_name: str) -> Optional[FusionCandidate]:
        for c in self.candidates:
            if c.region.name == region_name:
                return c
        return None

    def apply(self, engine=None, optimizer=None) -> Dict[str, Any]:
        """Install every planned region whose target was passed.
        Returns ``{region name: installed object}``; a target that lacks
        the install surface, or rejects it, is skipped with reason
        ``target-unsupported`` — never an exception."""
        installed: Dict[str, Any] = {}
        for cand in self.candidates:
            name = cand.region.name
            if name in installed:
                continue
            target = {"engine": engine,
                      "optimizer": optimizer}.get(cand.region.target)
            if target is None:
                continue
            # idempotence: re-applying over an installed region must not
            # re-count the admission or re-emit the event
            if cand.region.target == "engine":
                already = bool(getattr(target, "_fused_tail", False))
            else:
                already = isinstance(getattr(target, "_fused_step", None),
                                     FusedOptimizerStep)
            try:
                if cand.region.target == "engine":
                    target.enable_fused_tail()
                    installed[name] = target
                else:
                    installed[name] = install_optimizer_fusion(target)
            except Exception as exc:
                _note_skip(cand.ops, "target-unsupported", region=name,
                           error=f"{type(exc).__name__}: {exc}")
                continue
            _note_install(name, installed[name] if
                          cand.region.target == "optimizer" else target)
            if already:
                continue
            _admitted_total.inc(region=name)
            emit_event("fusion_applied", region=name,
                       chain="->".join(cand.ops),
                       est_us=cand.est_us, count=cand.count)
        _refresh_active_gauges()
        return installed


def _note_skip(ops: Sequence[str], reason: str, **extra) -> None:
    """Count every skip; emit the structured event once per (chain,
    reason) per process so a pass re-run cannot flood the event log."""
    _skipped_total.inc(reason=reason)
    key = (tuple(ops), reason)
    if key in _skip_noted:
        return
    _skip_noted.add(key)
    emit_event("fusion_skipped", chain="->".join(ops), reason=reason,
               **extra)


class FusionPass:
    """Maps a ``paddle_tpu.hot_chains`` artifact to installable fused
    regions. ``resolver`` (op name -> current symbol) defaults to
    :func:`profiling.dispatch_sites` (an AST scan of the port's tree);
    the pass trusts op names only as far as they still resolve in the
    current tree, so a stale artifact degrades to structured skips."""

    def __init__(self, regions: Optional[Dict[str, FusionRegion]] = None,
                 resolver: Optional[Callable[[], Dict[str, str]]] = None):
        self.regions = dict(regions if regions is not None else REGIONS)
        self._resolver = resolver or dispatch_sites

    @staticmethod
    def load(path: str) -> Dict[str, Any]:
        with open(path) as f:
            return json.load(f)

    def plan(self, artifact: Any) -> FusionPlan:
        """Rank-order walk over the artifact's chains. Never raises on
        artifact problems: schema mismatches and unresolvable symbols
        become ``fusion_skipped`` entries."""
        _refresh_active_gauges()
        plan = FusionPlan()
        if not isinstance(artifact, dict) \
                or artifact.get("kind") != ARTIFACT_KIND \
                or artifact.get("schema_version",
                                artifact.get("version")) != PROFILE_VERSION:
            got = None
            if isinstance(artifact, dict):
                got = (artifact.get("kind"),
                       artifact.get("schema_version",
                                    artifact.get("version")))
            _note_skip(("<artifact>",), "schema-mismatch", got=repr(got),
                       want=f"{ARTIFACT_KIND} v{PROFILE_VERSION}")
            plan.skipped.append({"chain": ("<artifact>",),
                                 "reason": "schema-mismatch"})
            return plan
        sites = self._resolver()
        claimed = artifact.get("symbols") or {}
        for chain in artifact.get("chains", []):
            ops = tuple(chain.get("ops", ()))
            if not ops:
                continue
            # staleness first: an op the artifact resolved to a symbol
            # that no longer resolves means the capture predates a
            # refactor — never rewrite against it
            stale = [op for op in ops if claimed.get(op)
                     and op not in sites]
            if stale:
                _note_skip(ops, "symbol-missing",
                           missing=",".join(stale))
                plan.skipped.append({"chain": ops,
                                     "reason": "symbol-missing",
                                     "missing": stale})
                continue
            matched_region = None
            matched_sig = None
            for region in self.regions.values():
                sig = region.match(ops)
                if sig is not None:
                    matched_region, matched_sig = region, sig
                    break
            if matched_region is None:
                _note_skip(ops, "no-region")
                plan.skipped.append({"chain": ops, "reason": "no-region"})
                continue
            missing = [op for op in matched_sig if op not in sites]
            if missing:
                _note_skip(ops, "symbol-missing", region=matched_region.name,
                           missing=",".join(missing))
                plan.skipped.append({"chain": ops,
                                     "reason": "symbol-missing",
                                     "missing": missing})
                continue
            plan.candidates.append(FusionCandidate(
                region=matched_region, ops=ops, matched=matched_sig,
                count=int(chain.get("count", 0)),
                est_us=float(chain.get("est_us", 0.0))))
        return plan


# ---------------------------------------------------------------------------
# Eager-granularity staging (bit-exact fused regions)
# ---------------------------------------------------------------------------
class HostScalar(float):
    """A host (float64) scalar expression over the stager's leaves
    (``lr``, ``step``), passed where the eager code passes a Python
    float. Arithmetic with Python numbers stays on the host in float64,
    as in the eager step; a torch function that receives one gets a
    staged device scalar instead (module docstring). Its float value is
    the expression at build time (for host code that only reads it)."""

    def __new__(cls, stager, ev):
        obj = super().__new__(cls, float(ev(stager.env)))
        obj._st = stager
        obj._ev = ev
        return obj

    def _lift(self, other):
        if isinstance(other, HostScalar):
            return other._ev
        if isinstance(other, (int, float)) and not isinstance(other, bool):
            return lambda env, v=other: v
        return None

    def _binop(self, other, op, rev: bool):
        oe = self._lift(other)
        if oe is None:
            return NotImplemented
        me = self._ev
        if rev:
            return HostScalar(self._st, lambda env: op(oe(env), me(env)))
        return HostScalar(self._st, lambda env: op(me(env), oe(env)))

    def __mul__(self, o): return self._binop(o, lambda a, b: a * b, False)
    def __rmul__(self, o): return self._binop(o, lambda a, b: a * b, True)
    def __add__(self, o): return self._binop(o, lambda a, b: a + b, False)
    def __radd__(self, o): return self._binop(o, lambda a, b: a + b, True)
    def __sub__(self, o): return self._binop(o, lambda a, b: a - b, False)
    def __rsub__(self, o): return self._binop(o, lambda a, b: a - b, True)
    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b, False)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: a / b, True)

    def __pow__(self, o): return self._binop(o, lambda a, b: a ** b, False)
    def __rpow__(self, o): return self._binop(o, lambda a, b: a ** b, True)

    def __neg__(self):
        return HostScalar(self._st, lambda env: -self._ev(env))

    __hash__ = object.__hash__

    def __eq__(self, other):
        return self is other


class _Stager:
    """The staged scalars of one fused program. Each use of a
    :class:`HostScalar` by a torch function takes the next slot, in the
    body's (deterministic) order: the slot holds the scalar's evaluator
    over the host environment and how the eager kernel received it
    (:func:`_staged_value`)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slots: List[Tuple[Callable, str]] = []
        self.cursor = 0
        self.env: Dict[str, float] = {"lr": 0.0, "step": 1.0}
        self.vec: Optional[torch.Tensor] = None

    def leaf(self, name: str) -> HostScalar:
        return HostScalar(self, lambda env, n=name: env[n])

    def slot(self, s: HostScalar, how: str) -> torch.Tensor:
        j = self.cursor
        if j >= self.capacity:
            raise RuntimeError(
                f"the fused step stages more than {self.capacity} host "
                "scalars")
        self.cursor += 1
        if j < len(self.slots):
            self.slots[j] = (s._ev, how)
        else:
            self.slots.append((s._ev, how))
        return self.vec[j]

    def values(self, out: np.ndarray) -> None:
        for j, (ev, how) in enumerate(self.slots):
            out[j] = _staged_value(ev(self.env), how)


#: torch functions that divide their first operand by their second
_DIVS = {torch.Tensor.div, torch.Tensor.div_, torch.Tensor.__truediv__,
         torch.Tensor.__itruediv__, torch.div, torch.true_divide}
_FOREACH_DIVS = {torch._foreach_div, torch._foreach_div_}
_INPLACE = {torch.Tensor.div_, torch.Tensor.__itruediv__,
            torch._foreach_div_}
#: (division function, device type) -> how a staged scalar reproduces the
#: eager kernel's division by a host scalar (:func:`_staged_value`):
#: "value" (a true division by fp32(s)), "recip" (a product with the
#: reciprocal taken in float64 and rounded once: CUDA's ``div`` and
#: ``_foreach_div`` by a host scalar) or "recip32" (a product with the
#: fp32 reciprocal of fp32(s)); learned once by :func:`_div_rule`
_DIV_RULES: Dict[tuple, str] = {}


def _staged_value(s: float, how: str) -> np.float32:
    """The fp32 a kernel receives for the host scalar ``s``."""
    if how == "recip":
        return np.float32(1.0 / s)
    if how == "recip32":
        return np.float32(1.0) / np.float32(s)
    return np.float32(s)


def _divide(func, x, r, how):
    """``func(x, s)`` with the staged scalar ``r`` (:func:`_staged_value`
    of ``s``): a division by it for "value", else a product."""
    inplace = func in _INPLACE
    if func in _FOREACH_DIVS:
        if how == "value":
            return func(x, r)
        return (torch._foreach_mul_ if inplace else torch._foreach_mul)(x, r)
    if how == "value":
        return func(x, r)
    return x.mul_(r) if inplace else x * r


def _div_rule(func, device: torch.device) -> str:
    """How ``func``'s division of a tensor (list) on ``device`` by a Python
    float rounds: the staged form that reproduces it bit for bit on a
    calibration input (outside any capture; cached)."""
    key = (func, device.type)
    if key in _DIV_RULES:
        return _DIV_RULES[key]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4099, generator=gen).to(device)
    # the bias corrections (where the two reciprocals part) and others
    scalars = [1 - b ** t for b in (0.9, 0.999) for t in range(1, 9)]
    scalars += [1 - 0.997 ** 120, 0.271, 3e-3, 7.0]

    def run(how, s):
        xs = [x.clone()] if func in _FOREACH_DIVS else x.clone()
        if how is None:
            out = func(xs, s)
        else:
            v = torch.tensor(_staged_value(s, how), device=device)
            out = _divide(func, xs, v, how)
        out = xs if func in _INPLACE else out
        return out[0] if isinstance(out, (list, tuple)) else out

    for how in ("value", "recip", "recip32"):
        if all(torch.equal(run(None, s), run(how, s)) for s in scalars):
            _DIV_RULES[key] = how
            return how
    raise RuntimeError(f"no staged form of {func} reproduces its eager "
                       f"division by a host scalar on {device}")


class _StageMode(TorchFunctionMode):
    """Replaces every :class:`HostScalar` argument of a torch function by
    its staged device scalar: the value the eager kernel would have
    received (module docstring)."""

    def __init__(self, stager: _Stager):
        super().__init__()
        self.st = stager

    def _sub(self, v):
        if isinstance(v, HostScalar):
            return self.st.slot(v, "value")
        if isinstance(v, (list, tuple)) and any(
                isinstance(e, HostScalar) for e in v):
            return type(v)(self.st.slot(e, "value")
                           if isinstance(e, HostScalar) else e for e in v)
        return v

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(isinstance(a, HostScalar) or (
                isinstance(a, (list, tuple)) and any(
                    isinstance(e, HostScalar) for e in a))
                for a in list(args) + list(kwargs.values())):
            return func(*args, **kwargs)
        if func is torch.Tensor.__rtruediv__:
            # torch computes ``s / x`` as reciprocal(x) * s
            x, s = args[0], args[1]
            return x.reciprocal() * self.st.slot(s, "value")
        if (func in _DIVS or func in _FOREACH_DIVS) and len(args) == 2 \
                and not kwargs and isinstance(args[1], HostScalar):
            x = args[0]
            dev = (x[0] if func in _FOREACH_DIVS else x).device
            how = _div_rule(func, dev)
            return _divide(func, x, self.st.slot(args[1], how), how)
        args = tuple(self._sub(a) for a in args)
        kwargs = {k: self._sub(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def stage_eager(fn: Callable, *example_args, capacity: int = 64):
    """Stage ``fn(lr, step, *args)`` (an eager function of host scalars
    and tensors): returns ``staged(vec, *args)`` that runs ``fn`` with
    ``lr``/``step`` as :class:`HostScalar` leaves under the staging mode
    over the device vector ``vec``, and the stager whose ``env`` and
    ``values`` fill that vector per call. ``example_args`` (the
    reference traces over them) are not needed: nothing is traced."""
    stager = _Stager(capacity)

    def staged(vec, *args):
        stager.vec = vec
        stager.cursor = 0
        lr, step = stager.leaf("lr"), stager.leaf("step")
        with _StageMode(stager):
            return fn(lr, step, *args)
    return staged, stager


# ---------------------------------------------------------------------------
# Region: optimizer_chain — the fused grad-transform/update program
# ---------------------------------------------------------------------------
class _ClipParam:
    """``need_clip`` stand-in handed to grad-clip transforms."""

    __slots__ = ("need_clip",)

    def __init__(self, nc: bool):
        self.need_clip = bool(nc)


class _FusedProgram:
    __slots__ = ("names", "params", "grads", "stager", "staged", "vec",
                 "host", "programs", "key", "copied")


class FusedOptimizerStep:
    """ONE program for the whole eager optimizer chain: the optimizer's
    own ``_grad_clip`` and ``_apply`` over every parameter that has a
    gradient, with the step's host scalars staged (module docstring), so
    parameters and state are byte-identical to ``Optimizer.step()``.

    Installed by :func:`install_optimizer_fusion` (the pass's
    ``optimizer_chain`` region): ``optimizer.step()`` then delegates
    here. On the card the program is a CUDA graph per parameter-set
    signature: each step copies the gradients into the graph's static
    buffers and the staged scalars through one pinned vector, then
    replays. The signature depends on parameter shapes and dtypes, state
    slots, static per-parameter attributes and the hyperparameters (a
    mutated beta rebuilds), never on the step or the learning rate."""

    def __init__(self, optimizer):
        self._opt = optimizer
        self._compiled: Dict[Tuple, _FusedProgram] = {}
        self.steps_fused = 0
        #: private switch: False runs the staged body eagerly on the card
        self._graphs = True

    def _hyper_signature(self) -> Tuple:
        opt = self._opt
        skip = {"_step_count", "_learning_rate"}

        def scalars(obj):
            return tuple(sorted(
                (k, bool(v) if isinstance(v, bool) else float(v))
                for k, v in vars(obj).items()
                if k not in skip and isinstance(v, (int, float, bool))))

        clip = opt._grad_clip
        csig = (() if clip is None
                else (type(clip).__name__,) + scalars(clip))
        return scalars(opt) + (csig,)

    def _signature(self, live) -> Tuple:
        opt = self._opt
        sig = [self._hyper_signature()]
        for name, p, g in live:
            st = opt._state_of(name, p)
            sig.append((
                name, tuple(p.shape), str(p.dtype), str(p.device),
                tuple(g.shape), str(g.dtype),
                tuple(sorted((k, tuple(v.shape), str(v.dtype))
                             for k, v in st.items())),
                bool(opt._decay_enabled(name, p)), _lr_factor(p),
                bool(getattr(p, "need_clip", True)),
            ))
        return tuple(sig)

    def _build(self, live) -> _FusedProgram:
        from . import ProgramCache, keep_slots
        opt = self._opt
        prog = _FusedProgram()
        prog.names = [n for n, _, _ in live]
        prog.params = [p for _, p, _ in live]
        device = prog.params[0].device
        wd_on = [opt._decay_enabled(n, p) for n, p, _ in live]
        factors = [_lr_factor(p) for _, p, _ in live]
        clip_objs = [_ClipParam(getattr(p, "need_clip", True))
                     for _, p, _ in live]

        def whole(lr, step, *grads):
            pairs = list(zip(clip_objs, grads))
            if opt._grad_clip is not None:
                pairs = opt._grad_clip(pairs)
            held = {n: dict(opt.state[n]) for n in prog.names}
            items = []
            for i, (_, g) in enumerate(pairs):
                wd = opt._weight_decay if wd_on[i] else 0.0
                lri = lr if factors[i] == 1.0 else lr * factors[i]
                items.append((prog.names[i], prog.params[i], g, lri, wd))
            opt._apply(items, step)
            keep_slots(opt, held)

        capacity = 4 * len(live) + 8
        prog.staged, prog.stager = stage_eager(whole, capacity=capacity)
        prog.vec = torch.zeros((capacity,), dtype=torch.float32,
                               device=device)
        prog.host = torch.zeros((capacity,), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        prog.grads = [torch.empty_like(g) for _, _, g in live]
        prog.programs = ProgramCache("fusion.optimizer_chain")
        prog.programs.graphs = self._graphs
        prog.key = ("params", len(live))
        #: the event after the last upload from ``host``: the host waits
        #: for it before writing the next step's scalars
        prog.copied = None
        return prog

    def step(self) -> None:
        opt = self._opt
        armed = chain_armed[0]
        t0 = time.perf_counter_ns() if armed else 0
        opt._step_count += 1
        grads = opt._grads()
        named = list(zip(opt._names, opt._parameter_list))
        live = [(n, p, g) for (n, p), g in zip(named, grads)
                if g is not None and getattr(p, "trainable", p.requires_grad)]
        if not live:
            return
        key = self._signature(live)
        prog = self._compiled.get(key)
        if prog is None:
            recompiles.record_miss("fusion.optimizer_chain",
                                   ("params", len(live)))
            prog = self._compiled[key] = self._build(live)
        prog.programs.graphs = self._graphs
        prog.stager.env = {"lr": opt.get_lr(), "step": opt._step_count}
        with torch.no_grad():
            torch._foreach_copy_(prog.grads, [g for _, _, g in live])
            if not prog.stager.slots:
                # first call: learn the slots with a dry trace of the host
                # expressions on a scratch copy, so the vector is right
                # before the real (warm-up) run
                self._learn_slots(prog)
            if prog.copied is not None:
                prog.copied.synchronize()     # the last upload has read it
            vals = prog.host.numpy()
            prog.stager.values(vals)
            prog.vec.copy_(prog.host, non_blocking=True)
            if prog.vec.is_cuda:
                prog.copied = torch.cuda.Event()
                prog.copied.record()
            prog.programs.run(prog.key, self._body(prog), [prog.vec],
                              prog.vec.device)
        self.steps_fused += 1
        if armed:
            note_chain(op_name="fused_optimizer_step",
                       dur_ns=time.perf_counter_ns() - t0)

    @staticmethod
    def _body(prog: _FusedProgram):
        def body(vec):
            prog.staged(vec, *prog.grads)
            return vec
        return body

    def _learn_slots(self, prog: _FusedProgram) -> None:
        """Run the staged body once over clones of the parameters, the
        optimizer state and the gradients (on their device), swapped in
        for the real ones, to learn which host scalars it stages. The
        real tensors are never written: the vector is still zeros, so
        the dry pass computes garbage. Whatever it raises, the real
        parameters, state and step count are back in place, and the
        slots are learned again at the next step."""
        opt = self._opt
        params, count = list(prog.params), opt._step_count
        state = {n: opt.state[n] for n in prog.names}
        try:
            prog.params[:] = [p.detach().clone() for p in params]
            for n in prog.names:
                opt.state[n] = {k: v.clone() for k, v in state[n].items()}
            prog.staged(prog.vec, *[g.clone() for g in prog.grads])
        except BaseException:
            prog.stager.slots.clear()
            raise
        finally:
            prog.params[:] = params
            opt.state.update(state)
            opt._step_count = count


def install_optimizer_fusion(optimizer) -> FusedOptimizerStep:
    """Install the ``optimizer_chain`` region: ``optimizer.step()``
    delegates to the fused step from now on (idempotent)."""
    fused = getattr(optimizer, "_fused_step", None)
    if isinstance(fused, FusedOptimizerStep):
        return fused
    fused = FusedOptimizerStep(optimizer)
    optimizer._fused_step = fused
    return fused


# ---------------------------------------------------------------------------
# Region: decode_tail — the fused unified/spec step programs
# ---------------------------------------------------------------------------
def pack_plan(ids, use_carry, token_row, positions, kv_lens, last_idx,
              sample_mask, *, decoding=None):
    """Pack one unified-step plan into two int32 uploads: the token-axis
    group ``(5, K, step_tokens)`` (ids, use_carry, decoding, token_row,
    positions: the reference's four and the port's ``decoding`` flags)
    and the row-axis group ``(3, K, rows)`` (kv_lens, last_idx,
    sample_mask) — two host→device copies per step instead of eight."""
    if decoding is None:
        decoding = np.zeros_like(use_carry)
    plan_tt = np.stack([ids, use_carry.astype(np.int32),
                        decoding.astype(np.int32), token_row,
                        positions]).astype(np.int32)
    plan_tr = np.stack([kv_lens, last_idx,
                        sample_mask.astype(np.int32)]).astype(np.int32)
    return plan_tt, plan_tr


def build_fused_unified_step(model_step: Callable, sample_fn: Callable,
                             num_rows: int, *, epilogue: bool = False):
    """The fused decode-tail twin of the engine's unified step: the same
    ops in the same order (per micro-round the carry select,
    ``model_step``, the sampling epilogue, the carry update) fed from
    the packed plan of :func:`pack_plan`, so the emitted tokens are
    byte-identical to the unfused program's by construction.

    ``model_step(ids, token_row, positions, kv_lens, last_idx, bt,
    gstate, decoding) -> logits`` (the grammar state rides into the
    model's logits hook); ``sample_fn(logits, kv_lens, gstate) ->
    (tokens, grammar states)``. ``epilogue``: the rows' grammar states
    advance. The returned ``run(plan_tt, plan_tr, bt, tok, gstate)``
    returns the (K, rows) emitted tokens and updates the carries ``tok``
    and (with the epilogue) ``gstate`` in place."""

    def run(plan_tt, plan_tr, bt, tok_carry, gst_carry):
        ids, token_row, positions = plan_tt[0], plan_tt[3], plan_tt[4]
        use_carry, decoding = plan_tt[1].bool(), plan_tt[2].bool()
        kv_lens, last_idx = plan_tr[0], plan_tr[1]
        sample_mask = plan_tr[2].bool()
        tok, gst = tok_carry, gst_carry
        emitted = []
        for k in range(ids.shape[0]):
            row_c = token_row[k].long().clamp(0, num_rows - 1)
            ids_eff = torch.where(use_carry[k], tok[row_c], ids[k])
            logits = model_step(ids_eff, token_row[k], positions[k],
                                kv_lens[k], last_idx[k], bt, gst,
                                decoding[k])
            nxt, ngst = sample_fn(logits, kv_lens[k], gst)
            emitted.append(tok)
            tok = torch.where(sample_mask[k], nxt, tok)
            if epilogue:
                gst = torch.where(sample_mask[k], ngst, gst)
        out = torch.stack(emitted)
        tok_carry.copy_(tok)
        if epilogue:
            gst_carry.copy_(gst)
        return out
    return run


def pack_spec_plan(ids, token_row, positions, decoding, kv_lens, cand_idx,
                   drafts, draft_len, sampled, spec_k: int):
    """Pack one speculative round's plan into two int32 uploads: the
    token-axis group ``(4, T)`` (ids, token_row, positions, decoding) and
    the row-axis group ``(3 + (k + 1) + k, rows)`` (kv_lens, draft_len,
    sampled, then the candidate indices and the drafts, one row each
    per candidate / draft position)."""
    rows = kv_lens.shape[0]
    k1 = spec_k + 1
    plan_tt = np.stack([ids, token_row, positions,
                        decoding.astype(np.int32)]).astype(np.int32)
    plan_tr = np.concatenate([
        np.stack([kv_lens, draft_len, sampled.astype(np.int32)]),
        cand_idx.reshape(rows, k1).T,
        drafts.reshape(rows, -1).T]).astype(np.int32)
    return plan_tt, plan_tr


def build_fused_spec_step(model_step: Callable, spec_sample_fn: Callable,
                          spec_k: int, num_rows: int):
    """The fused decode-tail twin of the speculative step: the same
    single ragged step and in-program verify epilogue as the unfused
    program, fed from :func:`pack_spec_plan`'s two uploads; greedy
    streams are byte-identical by construction.

    ``model_step(ids, token_row, positions, kv_lens, cand_idx, bt,
    decoding) -> logits``; ``spec_sample_fn(logits (rows, k+1, V),
    drafts, draft_len, pos_base, gstate) -> (toks (rows, k+1), accepted
    (rows,), gstate')``. The returned ``run(plan_tt, plan_tr, bt,
    gstate)`` returns (rows, k+2) int32 (candidates, then the accepted
    count); only rows that commit a token (``sampled``) advance their
    grammar state in place."""
    k1 = spec_k + 1

    def run(plan_tt, plan_tr, bt, gst_carry):
        ids, token_row, positions = plan_tt[0], plan_tt[1], plan_tt[2]
        decoding = plan_tt[3].bool()
        kv_lens, draft_len = plan_tr[0], plan_tr[1]
        sampled = plan_tr[2].bool()
        cand_idx = plan_tr[3:3 + k1].t().contiguous().reshape(num_rows * k1)
        drafts = plan_tr[3 + k1:].t().contiguous()
        logits = model_step(ids, token_row, positions, kv_lens, cand_idx,
                            bt, decoding)
        lg = logits.reshape(num_rows, k1, -1)
        pos_base = positions[cand_idx.reshape(num_rows, k1)[:, 0].long()]
        toks, accepted, ngst = spec_sample_fn(lg, drafts, draft_len,
                                              pos_base, gst_carry)
        gst_carry.copy_(torch.where(sampled, ngst, gst_carry))
        return torch.cat([toks, accepted[:, None]], dim=1)
    return run
