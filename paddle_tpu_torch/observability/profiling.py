"""Continuous profiling: hot producer→consumer dispatch chains —
counterpart of ``paddle_tpu/observability/profiling.py``.

The always-on dispatch telemetry (``observability.runtime``) counts every
op through ``core.dispatch.apply`` and samples 1/64 durations. This
module folds that into ranked **producer→consumer chains** (op A
followed by op B on one thread), each scored by observed frequency ×
sampled mean op cost: the candidates a fusion pass would rewrite into
one region. The serving engine's plan/dispatch/unpack phases tap the
same profiler through :func:`note_chain`.

Recording follows the telemetry's zero-overhead contract: the
dispatcher checks the module-level ``chain_armed`` cell (one list index)
and only then notes the transition (plain dict ops, no lock).

:meth:`DispatchChainProfiler.export` emits a stable JSON artifact
(deterministic for the same counters) whose ops are resolved by
:func:`dispatch_sites`: each op maps to the qualified name of the
function that dispatches it (the ``op_name=`` literal's enclosing def).
The JAX package resolves these over its static analyzer's project index
(``analysis/``, not ported); the port scans its own source tree with
``ast``, which gives the same mapping for the port's modules.
"""

from __future__ import annotations

import ast
import functools
import json
import platform
import sys
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

#: the one cell ``core.dispatch.apply`` checks per armed dispatch
chain_armed = [False]

#: artifact schema version (the JAX package's)
PROFILE_VERSION = 1

_PKG_DIR = Path(__file__).resolve().parents[1]


def run_metadata() -> Dict[str, str]:
    """Deterministic run metadata stamped into the artifact (no wall
    clock: two exports over one capture stay byte-identical)."""
    torch = sys.modules.get("torch")
    return {
        "python": platform.python_version(),
        "host_platform": sys.platform,
        "torch": getattr(torch, "__version__", ""),
    }


def note_chain(*, op_name: str, dur_ns: Optional[float] = None) -> None:
    """Armed-only chain tap for host code that runs whole programs rather
    than eager ops (the serving engine's plan/dispatch/unpack phases).
    Call with a literal ``op_name=`` keyword: :func:`dispatch_sites`
    resolves it to the enclosing function like a ``core.dispatch`` op.
    One list index when disarmed."""
    if not chain_armed[0]:
        return
    chain_profiler.note(op_name)
    if dur_ns is not None:
        chain_profiler.note_duration(op_name, dur_ns)


class _Sites(ast.NodeVisitor):
    """Collects ``op_name="<literal>"`` keywords of calls, each with the
    qualified name of the innermost function around it (nested functions
    as ``outer.<locals>.inner``, lambdas as ``outer.<lambda>``)."""

    def __init__(self, modname: str, note):
        self.modname = modname
        self.note = note
        self.stack: List[Tuple[str, bool]] = []     # (name, is_function)

    def _qual(self) -> str:
        parts = []
        for i, (name, is_fn) in enumerate(self.stack):
            parts.append(name)
            if is_fn and i + 1 < len(self.stack) \
                    and self.stack[i + 1][0] != "<lambda>":
                parts.append("<locals>")
        return ".".join(parts)

    def _scope(self, node, name, is_fn):
        self.stack.append((name, is_fn))
        self.generic_visit(node)
        self.stack.pop()

    def visit_ClassDef(self, node):
        self._scope(node, node.name, False)

    def visit_FunctionDef(self, node):
        self._scope(node, node.name, True)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._scope(node, "<lambda>", True)

    def visit_Call(self, node):
        if any(is_fn for _, is_fn in self.stack):
            for kw in node.keywords:
                if (kw.arg == "op_name" and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)):
                    self.note(kw.value.value, f"{self.modname}.{self._qual()}")
        self.generic_visit(node)


@functools.lru_cache(maxsize=1)
def dispatch_sites() -> Dict[str, str]:
    """op name -> ``module.qualname`` of the function dispatching it,
    from one ``ast`` scan of the port's source tree (cached; imports
    nothing). Ops dispatched with a dynamic ``op_name`` (generated
    elementwise families) stay unresolved. Deterministic: among several
    dispatch sites the lexicographically-smallest symbol wins."""
    sites: Dict[str, str] = {}

    def note(op: str, symbol: str) -> None:
        if op not in sites or symbol < sites[op]:
            sites[op] = symbol

    root = _PKG_DIR.parent
    for path in sorted(_PKG_DIR.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
        _Sites(".".join(parts), note).visit(tree)
    return sites


class DispatchChainProfiler:
    """See module docstring. ``note``/``note_duration`` are the hot-path
    taps (lock-free by design — do NOT add a lock here, the dispatcher
    calls them per eager op); ``profile``/``export`` are the cold read
    side."""

    def __init__(self, max_pairs: int = 4096):
        self._max_pairs = max_pairs
        self._pairs: Dict[Tuple[str, str], int] = {}
        self._prev: Dict[int, str] = {}         # thread ident -> last op
        self._dur: Dict[str, List[float]] = {}  # op -> [sum_ns, samples]
        self.dropped_pairs = 0

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return chain_armed[0]

    def arm(self) -> "DispatchChainProfiler":
        # a fresh window must not stitch a phantom transition from the
        # previous armed window's last op to this one's first
        self._prev = {}
        chain_armed[0] = True
        return self

    def disarm(self) -> None:
        chain_armed[0] = False

    def reset(self) -> None:
        self._pairs = {}
        self._prev = {}
        self._dur = {}
        self.dropped_pairs = 0

    # -- recording (armed-only; the dispatcher gates on chain_armed[0]) -----

    def note(self, op_name: str) -> None:
        """One dispatch: count the (previous op -> this op) transition on
        this thread. Bounded: past ``max_pairs`` distinct transitions new
        pairs are dropped (counted), existing pairs keep counting."""
        ident = threading.get_ident()
        prev = self._prev.get(ident)
        self._prev[ident] = op_name
        if prev is None:
            return
        key = (prev, op_name)
        pairs = self._pairs
        n = pairs.get(key)
        if n is None:
            if len(pairs) >= self._max_pairs:
                self.dropped_pairs += 1
                return
            n = 0
        pairs[key] = n + 1

    def note_duration(self, op_name: str, dur_ns: float) -> None:
        """Sampled op wall time (the dispatcher's existing 1/64 sample)."""
        s = self._dur.get(op_name)
        if s is None:
            s = self._dur[op_name] = [0.0, 0]
        s[0] += dur_ns
        s[1] += 1

    # -- profiling ----------------------------------------------------------

    def mean_us(self, op_name: str) -> float:
        s = self._dur.get(op_name)
        return (s[0] / s[1]) / 1e3 if s and s[1] else 0.0

    def chains(self, top_n: int = 10, min_count: int = 2,
               max_len: int = 8, coherence: float = 0.5
               ) -> List[Dict[str, Any]]:
        """Ranked hot chains. Seeds are the hottest transitions; a chain
        extends along the dominant successor while that edge carries at
        least ``coherence`` of the chain's weight (and no op repeats —
        loops truncate). ``count`` is the chain's weakest edge, ``est_us``
        is count × Σ sampled mean op cost. Deterministic: every ordering
        breaks ties lexicographically on op names."""
        pairs = dict(self._pairs)
        consumed: set = set()
        built: List[Dict[str, Any]] = []
        for (a, b), c in sorted(pairs.items(),
                                key=lambda kv: (-kv[1], kv[0])):
            if c < min_count or (a, b) in consumed:
                continue
            ops = [a, b]
            consumed.add((a, b))
            weight = c
            while len(ops) < max_len:
                succs = sorted(
                    ((k[1], n) for k, n in pairs.items()
                     if k[0] == ops[-1] and k not in consumed),
                    key=lambda s: (-s[1], s[0]))
                if not succs:
                    break
                nxt, n = succs[0]
                if n < coherence * weight or nxt in ops:
                    break
                consumed.add((ops[-1], nxt))
                ops.append(nxt)
                weight = min(weight, n)
            built.append({
                "ops": ops,
                "count": weight,
                "est_us": round(weight * sum(self.mean_us(o)
                                             for o in ops), 3),
            })
        built.sort(key=lambda ch: (-ch["est_us"], -ch["count"], ch["ops"]))
        return built[:top_n]

    def profile(self, op_counts: Optional[Dict[str, int]] = None,
                top_n: int = 10, workload: str = "",
                resolve: bool = True) -> Dict[str, Any]:
        """The fusion-pass input document (see module docstring).
        ``op_counts`` defaults to the live dispatch telemetry's counters;
        ``resolve=False`` skips the (one-off ~seconds) static symbol
        resolution for hot-loop callers."""
        if op_counts is None:
            from .runtime import telemetry
            op_counts = telemetry.op_counts
        chains = self.chains(top_n=top_n)
        chain_ops = sorted({o for ch in chains for o in ch["ops"]})
        symbols: Dict[str, Optional[str]] = {}
        if resolve and chain_ops:
            sites = dispatch_sites()
            symbols = {op: sites.get(op) for op in chain_ops}
        return {
            "version": PROFILE_VERSION,
            "schema_version": PROFILE_VERSION,
            "kind": "paddle_tpu.hot_chains",
            "meta": run_metadata(),
            "workload": workload,
            "top_n": top_n,
            "transitions": len(self._pairs),
            "dropped_pairs": self.dropped_pairs,
            "op_totals": {op: int(op_counts[op])
                          for op in sorted(op_counts)},
            "symbols": symbols,
            "chains": chains,
        }

    def export(self, path: Optional[str] = None, **kw) -> Dict[str, Any]:
        """``profile()`` serialised to a stable JSON artifact (sorted
        keys, fixed separators — byte-deterministic for identical
        counters). Returns the document; writes it when ``path`` given."""
        doc = self.profile(**kw)
        if path is not None:
            with open(path, "w") as f:
                f.write(json.dumps(doc, sort_keys=True, indent=1))
        return doc


#: the process-global profiler the dispatcher taps while armed
chain_profiler = DispatchChainProfiler()
