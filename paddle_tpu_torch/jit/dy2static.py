"""dy2static control-flow conversion — counterpart of
``paddle_tpu/jit/dy2static.py`` (the reference's SOT/AST conversion,
SURVEY.md §2.5 dy2static row).

The same AST rewrite turns every ``if``/``while``/``for``/``and``/``or``/
``not`` over tensors into calls of the runtime helpers below, which
dispatch at run time:

* a concrete predicate (a Python value, or any tensor outside a compiled
  program's body) runs the branch or loop exactly as Python would;
* a traced predicate — a Tensor (or torch tensor) inside a compiled
  program's body (``jit.StaticFunction``, ``TrainStep``;
  ``core.tensor.is_tracing``), on any device — takes the reference's
  compiled route, with its diagnostics:

  - ``if``: both branches run and every variable they assign is
    selected with ``torch.where`` on the predicate, the counterpart of
    ``lax.cond`` in a CUDA graph (both branches' kernels are captured);
    the branches must assign the same variables with the same shapes;
  - ``while`` with a traced predicate is a **graph break**: a CUDA graph
    has no data-dependent loop, so the loop runs as Python, reading the
    predicate on the host each trip. The call counts it
    (:data:`graph_breaks`, by source location), emits a
    ``dy2static_graph_break`` event (once per location per process), and
    the program that hit it runs eagerly on its device from then on
    (``jit`` does not capture it). The carried variables keep the
    reference's ``lax.while_loop`` contract (a fixed set of variables of
    fixed shapes), and the results are the reference's;
  - ``for`` over a traced tensor unrolls its leading axis (at most
    ``TRACED_ITER_UNROLL_LIMIT`` rows); ``range`` with a traced bound is
    a converted ``while``.

* anything outside the convertible subset fails with a
  :class:`ConversionError` naming the source line and the rule it broke.

Convertible subset (the reference's documented limits): branch bodies
that assign variables and/or both-return; loop bodies that assign carried
variables. ``break``/``continue``/``return`` inside loops are lowered to
flags; single-branch ``return`` raises ConversionError.
"""

from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import types
import warnings
from typing import Any, Callable, Dict

import torch

from ..core.tensor import Tensor, is_tracing
# A `for` over a traced tensor unrolls shape[0] copies of its body into
# the program; past this many rows the conversion raises the actionable
# error (or falls back to eager) instead. One constant with
# Tensor.__iter__'s guard (which covers wrapped iteration —
# enumerate/zip/reversed — that never reaches check_iterable).
from ..core.tensor import (  # noqa: E402
    TRACED_ITER_UNROLL_LIMIT as _TENSOR_FOR_UNROLL_LIMIT)
from ..observability.events import emit_event

__all__ = ["ConversionError", "convert_ifelse", "convert_while",
           "convert_control_flow", "graph_breaks"]

#: data-dependent ``while`` loops run as graph breaks, by source location
graph_breaks: Dict[str, int] = {}
_break_noted: set = set()


class ConversionError(RuntimeError):
    """Data-dependent control flow that cannot be converted; the message
    names the offending source location and what to change."""


def _raw(v):
    return v._value if isinstance(v, Tensor) else v


def _is_traced(v) -> bool:
    return is_tracing() and isinstance(_raw(v), torch.Tensor)


def _is_leaf(v) -> bool:
    return not isinstance(v, (tuple, list, dict))


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for e in tree for x in _leaves(e)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _structure(tree):
    """The container skeleton of a tree (leaves as ``*``)."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(e) for e in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    return "*"


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, (tuple, list)):
            return type(t)(build(e) for e in t)
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        return next(it)
    return build(template)


def _wrap(v):
    return Tensor._wrap(v, not v.requires_grad)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d tensor beside ``like`` (int32, float32 or
    bool, the reference's x64-off dtypes)."""
    if isinstance(v, bool):
        dt = torch.bool
    elif isinstance(v, int):
        dt = torch.int32
    elif isinstance(v, float):
        dt = torch.float32
    else:
        dt = None
    return torch.as_tensor(v, dtype=dt, device=like.device)


class _Undefined:
    """Placeholder for a name not bound before the branch assigned it."""

    def __repr__(self):
        return "<undefined>"


UNDEFINED = _Undefined()


def check_unconvertible(pred, loc: str, reason: str):
    """Guard for control flow left in Python form: concrete predicates pass
    through (original behaviour); traced ones get the actionable error."""
    if _is_traced(pred):
        raise ConversionError(f"{loc}: {reason}")
    return bool(_raw(pred))


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable, loc: str = "",
                   names=None):
    """Runtime dispatch for a rewritten ``if`` statement.

    Both branch fns take no arguments (they close over the local scope) and
    return the tuple of names assigned in either branch. ``names`` (when
    provided by the rewriter) labels that tuple position-by-position so
    synthetic conversion temporaries can be recognised at runtime.
    """
    if not _is_traced(pred):
        # concrete: behave exactly like the original Python if
        return true_fn() if bool(_raw(pred)) else false_fn()
    pb = _raw(pred)
    if pb.dim() != 0:
        raise ConversionError(
            f"{loc}: tensor predicate of a converted `if` must be a scalar, "
            f"got shape {tuple(pb.shape)}; reduce it (e.g. .all()/.any()) "
            "first")
    try:
        t_out = true_fn()
        f_out = false_fn()
    except NameError as e:
        raise ConversionError(
            f"{loc}: {e} while tracing both branches of a data-dependent "
            "`if` — a variable assigned in only one branch must be "
            "initialised before the `if`") from e
    if names is not None and isinstance(t_out, tuple) \
            and isinstance(f_out, tuple):
        # A synthetic __dy2st_* temporary (a nested conversion's range
        # triple / index var / inner escape flag) that one branch binds
        # and the other leaves UNDEFINED is branch-LOCAL: it is re-
        # initialised before any later use, so its post-if value is dead.
        # Mirror the bound side across instead of demanding both branches
        # bind it. User names keep the strict same-structure error below.
        t_out, f_out = list(t_out), list(f_out)
        for i, name in enumerate(names):
            if not name.startswith("__dy2st_"):
                continue
            if isinstance(t_out[i], _Undefined) and \
                    not isinstance(f_out[i], _Undefined):
                t_out[i] = f_out[i]
            elif isinstance(f_out[i], _Undefined) and \
                    not isinstance(t_out[i], _Undefined):
                f_out[i] = t_out[i]
        t_out, f_out = tuple(t_out), tuple(f_out)
    t_struct, f_struct = _structure(t_out), _structure(f_out)
    if t_struct != f_struct:
        raise ConversionError(
            f"{loc}: the two branches of a converted `if` produced "
            f"different variable structures ({t_struct} vs {f_struct}); "
            "assign the same variables (with the same nesting) in both "
            "branches")
    t_leaves, f_leaves = _leaves(t_out), _leaves(f_out)
    out = []
    for a, b in zip(t_leaves, f_leaves):
        if isinstance(a, _Undefined) or isinstance(b, _Undefined):
            raise ConversionError(
                f"{loc}: a variable assigned in only one branch of a "
                "data-dependent `if` is undefined in the other; initialise "
                "it before the `if`")
        ra, rb = _raw(a), _raw(b)
        ta, tb = isinstance(ra, torch.Tensor), isinstance(rb, torch.Tensor)
        if not ta and not tb:
            if type(ra) is type(rb) and ra == rb:
                out.append(a)
                continue
            if not isinstance(ra, (bool, int, float)) or \
                    not isinstance(rb, (bool, int, float)):
                raise ConversionError(
                    f"{loc}: the branches of a data-dependent `if` bind a "
                    f"non-tensor variable to different values ({ra!r} vs "
                    f"{rb!r}); only tensors and numbers can be selected")
            ra, rb = _as_tensor(ra, pb), _as_tensor(rb, pb)
        elif not ta:
            # one branch assigned a Python scalar while the other carries
            # a () tensor — e.g. the break-lowering's `brk = True` against
            # a carried flag; promote the Python side
            if rb.dim() != 0:
                raise ConversionError(
                    f"{loc}: branch outputs disagree on shape (() vs "
                    f"{tuple(rb.shape)}); both branches must produce "
                    "identical shapes/dtypes")
            ra = torch.as_tensor(ra, dtype=rb.dtype, device=rb.device)
        elif not tb:
            if ra.dim() != 0:
                raise ConversionError(
                    f"{loc}: branch outputs disagree on shape "
                    f"({tuple(ra.shape)} vs ()); both branches must produce "
                    "identical shapes/dtypes")
            rb = torch.as_tensor(rb, dtype=ra.dtype, device=ra.device)
        if ra.shape != rb.shape:
            raise ConversionError(
                f"{loc}: branch outputs disagree on shape "
                f"({tuple(ra.shape)} vs {tuple(rb.shape)}); both branches "
                "must produce identical shapes/dtypes")
        sel = torch.where(pb.to(device=ra.device, dtype=torch.bool), ra, rb)
        out.append(_wrap(sel) if isinstance(a, Tensor) or
                   isinstance(b, Tensor) else sel)
    return _unflatten(t_out, out)


def convert_bool_op(op: str, loc: str, *thunks):
    """Runtime dispatch for ``a and b`` / ``a or b``.

    Operands arrive as thunks so concrete values keep Python's exact
    short-circuit semantics (including returning the operand itself, not a
    bool). The first TRACED operand ends short-circuiting: the remaining
    operands are evaluated and folded with logical_and/or into a boolean
    tensor (the reference's behaviour for tensor predicates), so once an
    operand is traced every later operand runs; exceptions from such an
    operand are annotated with the conversion location."""
    val = thunks[0]()
    for i, t in enumerate(thunks[1:], 1):
        if not _is_traced(val):
            raw = _raw(val)
            if op == "and":
                if not raw:
                    return val
            else:
                if raw:
                    return val
            val = t()
            continue
        acc = _raw(val).bool()
        for t2 in thunks[i:]:
            try:
                v2 = t2()
            except Exception as e:
                e.add_note(
                    f"dy2static {loc}: an earlier operand of this "
                    f"`{op}` is a traced tensor, so short-circuit "
                    "evaluation does not apply — later operands run "
                    "unconditionally under tracing. Guard the "
                    "failing operand (e.g. hoist it above the "
                    "bool-op) if it must be skipped.")
                raise
            v2 = _raw(v2)
            nxt = (v2.bool() if isinstance(v2, torch.Tensor)
                   else torch.as_tensor(bool(v2), device=acc.device))
            acc = (torch.logical_and(acc, nxt) if op == "and"
                   else torch.logical_or(acc, nxt))
        return _wrap(acc)
    return val


def convert_not(value, loc: str = ""):
    """``not x``: Python semantics for concrete x, logical_not for traced."""
    if _is_traced(value):
        return _wrap(torch.logical_not(_raw(value).bool()))
    return not _raw(value)


def convert_range_args(loc: str, *args):
    """Normalize range(...) arguments to a (start, stop, step) triple."""
    vals = [_raw(a) for a in args]
    if len(vals) == 1:
        start, stop, step = 0, vals[0], 1
    elif len(vals) == 2:
        start, stop, step = vals[0], vals[1], 1
    elif len(vals) == 3:
        start, stop, step = vals
    else:
        raise ConversionError(f"{loc}: range() takes 1-3 arguments")
    if not _is_traced(step):
        try:
            if int(step) == 0:
                raise ValueError("range() arg 3 must not be zero")
        except TypeError:
            pass
    return start, stop, step


def convert_range_cont(i, stop, step):
    """The for-range continuation predicate: direction-aware i-vs-stop."""
    vals = [_raw(v) for v in (i, stop, step)]
    traced = [v for v in vals if _is_traced(v)]
    if traced:
        like = traced[0]
        iv, ev, sv = (v if isinstance(v, torch.Tensor) else
                      _as_tensor(v, like) for v in vals)
        return _wrap(torch.where(sv > 0, iv < ev, iv > ev))
    iv, ev, sv = vals
    return (sv > 0 and iv < ev) or (sv < 0 and iv > ev)


def check_iterable(it, loc: str):
    """Dispatch for a ``for`` over a non-range iterable.

    Concrete iterables run the plain Python loop. Traced tensors iterate
    their leading axis with the static trip count ``shape[0]``, unrolling
    the body once per row (the reference's semantics for ``for row in
    traced_array``). 0-d tensors raise the actionable error (Python
    cannot iterate a scalar either)."""
    if _is_traced(it):
        raw = _raw(it)
        if not raw.dim():
            raise ConversionError(
                f"{loc}: iterating a 0-d traced tensor in a `for` loop; "
                "loops need a leading axis (or use a tensor op)")
        n = raw.shape[0]
        if n > _TENSOR_FOR_UNROLL_LIMIT:
            raise ConversionError(
                f"{loc}: iterating a traced tensor with leading axis {n} "
                f"would unroll {n} copies of the loop body (limit "
                f"{_TENSOR_FOR_UNROLL_LIMIT}); loop over `range(n)` and "
                "index, or use a tensor op (scan/vmap)")
        # Tensor indexing preserves the wrapper; raw aliases `it` otherwise.
        return [it[i] for i in range(n)]
    return it


def convert_ret_select(loc, default_fn, *sites):
    """Single-exit return selector planted by the return-in-loop lowering.

    ``sites`` are ``(flag, value_thunk)`` pairs, one per lowered ``return``
    statement, in source order. The guards the lowering plants make the
    flags mutually exclusive (once a return fires, every later flag's code
    is skipped/broken out of), so fold order is irrelevant. Concrete flags
    reproduce Python exactly (only the fired site's thunk runs); any traced
    flag evaluates every thunk and selects with ``torch.where``."""
    if not any(_is_traced(f) for f, _ in sites):
        for f, th in sites:
            if bool(_raw(f)):
                return th()
        return default_fn()
    out = default_fn()
    for f, th in sites:
        val = th()
        out = convert_ifelse(f, lambda v=val: v, lambda o=out: o, loc)
    return out


def _note_graph_break(loc: str) -> None:
    graph_breaks[loc] = graph_breaks.get(loc, 0) + 1
    if loc not in _break_noted:
        _break_noted.add(loc)
        emit_event("dy2static_graph_break", loc=loc,
                   reason="data-dependent while")


def _carry_signature(carry):
    """The structure of a carry and each tensor leaf's shape (a Python
    number stands for a 0-d value, as ``lax.while_loop`` promotes it)."""
    sig = []
    for v in _leaves(carry):
        r = _raw(v)
        if isinstance(r, torch.Tensor):
            sig.append(tuple(r.shape))
        elif isinstance(r, (bool, int, float)):
            sig.append(())
        else:
            sig.append(None)
    return _structure(carry), sig


def convert_while(cond_fn: Callable, body_fn: Callable, carry, loc: str = ""):
    """Runtime dispatch for a rewritten ``while``.

    cond_fn(carry) -> predicate; body_fn(carry) -> new carry (same
    structure). Concrete predicates over a concrete carry run the plain
    Python loop. With a traced carry the loop keeps the reference's carry
    contract (the variables and their shapes stay fixed) and, while its
    predicate is concrete, unrolls into the program; a traced predicate is
    a graph break (module docstring): the loop runs as Python reading the
    predicate on the host each trip."""
    first = cond_fn(carry)
    if not _is_traced(first) and not any(
            _is_traced(v) for v in _leaves(carry)):
        while bool(_raw(first)):
            carry = body_fn(carry)
            first = cond_fn(carry)
        return carry
    if any(isinstance(v, _Undefined) for v in _leaves(carry)):
        # Names assigned in the body but unbound before the loop (a nested
        # loop's per-iteration locals). Their init value is DEAD — the body
        # assigns before reading. A name still UNDEFINED after one trip
        # was never assigned-before-read: that is the real user error.
        probe = _leaves(body_fn(carry))
        if any(isinstance(p, _Undefined) for p in probe):
            raise ConversionError(
                f"{loc}: a loop-carried variable is undefined before a "
                "data-dependent `while` and the body reads it before "
                "assigning; initialise it before the loop")
    struct, shapes = None, None
    noted = False
    while True:
        p = _raw(first)
        if isinstance(p, torch.Tensor):
            if p.numel() != 1:
                raise ConversionError(
                    f"{loc}: the predicate of a data-dependent `while` must "
                    f"be a scalar, got shape {tuple(p.shape)}")
            if not noted:
                _note_graph_break(loc)
                noted = True
            go = bool(p.detach().reshape(()).cpu())
        else:
            go = bool(p)
        if not go:
            return carry
        new = body_fn(carry)
        ns, nshapes = _carry_signature(new)
        if struct is None:
            struct, shapes = _carry_signature(carry)
            shapes = [s if s is not None else n
                      for s, n in zip(shapes, nshapes)]
        if ns != struct:
            raise ConversionError(
                f"{loc}: converted `while` body changed the carried "
                f"variable structure ({struct} -> {ns}); a compiled loop "
                "needs a fixed set of variables")
        if nshapes != shapes:
            raise ConversionError(
                f"{loc}: the loop's carried shapes changed ({shapes} -> "
                f"{nshapes}); carried shapes/dtypes must be identical "
                "every iteration — pad or bucket growing tensors "
                "(paddle_tpu_torch.jit.pad_to_bucket)")
        carry = new
        first = cond_fn(carry)


# ===========================================================================
# AST rewrite
# ===========================================================================
def _store_names(nodes) -> set:
    """VARIABLE names bound by assignment/augassign/for-targets within
    ``nodes``. Does not descend into nested function/class definitions and
    does NOT include def/class names — function/class objects cannot ride a
    converted if/while carry (this also excludes the __dy2st_* helper defs a
    nested rewrite plants)."""
    found = set()

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):  # do not descend, do not carry
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                found.add(node.id)

        def visit_Subscript(self, node):
            # `out[t] = v` / `out[t] += v` rebinds out's VALUE: the base
            # name must ride the carry or the in-place write inside the
            # converted body leaks a traced value into the closed-over object
            if isinstance(node.ctx, (ast.Store, ast.Del)) and \
                    isinstance(node.value, ast.Name):
                found.add(node.value.id)
            self.generic_visit(node)

    for n in nodes:
        V().visit(n)
    return found


def _load_names(node, prune_defs: bool = False) -> set:
    """Names read within ``node``. With ``prune_defs`` nested
    function/class bodies are skipped — a nested def's closure reads of
    __dy2st_* names always follow their assignment in the same iteration
    (the rewriter emits assigns before the defs that read them). Lambdas
    are NEVER pruned: the bool-op conversion hides predicate reads (e.g.
    a loop's break flag) inside thunk lambdas, and those are real reads
    at statement execution time."""
    found = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Load):
                found.add(node.id)

        if prune_defs:
            def visit_FunctionDef(self, node):  # prune
                pass

            visit_AsyncFunctionDef = visit_FunctionDef
            visit_ClassDef = visit_FunctionDef

    V().visit(node)
    return found


def _has(nodes, kinds, prune_loops: bool = False) -> ast.AST:
    """First node of any of ``kinds`` inside ``nodes``, PRUNING nested
    function/class subtrees (a Return inside a nested def — including the
    __dy2st_* branch helpers an inner rewrite plants — does not belong to
    the enclosing statement). ``prune_loops`` additionally skips nested
    While/For subtrees — a Break/Continue inside an inner loop belongs to
    THAT loop (a Return, by contrast, escapes every loop, so Return
    searches must not prune)."""
    hit = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):  # prune
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        if prune_loops:
            def visit_While(self, node):  # inner escapes are theirs
                pass

            visit_For = visit_While
            visit_AsyncFor = visit_While

        def generic_visit(self, node):
            if not hit and isinstance(node, kinds):
                hit.append(node)
            if not hit:
                super().generic_visit(node)

    for n in nodes:
        V().visit(n)
        if hit:
            return hit[0]
    return None


class _ReturnLowering:
    """Single-exit rewrite for ``return`` inside loops — the reference
    dy2static ReturnTransformer's role (python/paddle/jit/dy2static/
    transformers/return_transformer.py:§0), built on the same flag
    machinery as break/continue lowering.

    Every ``return expr`` whose nearest enclosing construct chain reaches
    a While/For becomes ``__ret_flag_N = True; break`` — the break rides
    the existing escape lowering — and ``expr`` is RECORDED, not
    evaluated: because the break exits immediately, the loop-carried
    state at the post-loop program point equals the state at the return
    site, so the expr evaluates identically there (every name a loop
    body assigns is loop-carried by the while conversion). Spine
    statements after a flagging loop are wrapped in ``if not (flags):``
    guards, and the function gains a single trailing
    ``return __dy2st_ret_select(...)`` that picks the fired site's value
    (or the original fall-through return) — see
    :func:`convert_ret_select`.

    Returns inside ``try``/``match`` blocks of a converted loop raise
    ConversionError (→ eager fallback when enabled)."""

    def __init__(self, filename: str):
        self.filename = filename
        self.n = 0

    def _loc(self, node) -> str:
        return f"{self.filename}:{getattr(node, 'lineno', '?')}"

    @staticmethod
    def _flags_or(flags):
        if not flags:
            raise ConversionError(
                "internal: return-lowering produced an empty flag set")
        names = [ast.Name(id=f, ctx=ast.Load()) for f in flags]
        return names[0] if len(names) == 1 else \
            ast.BoolOp(op=ast.Or(), values=names)

    @staticmethod
    def _loop_has_return(stmts) -> bool:
        """Is there a Return nested inside any While/For (pruning defs)?"""
        found = []

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):  # prune
                pass

            visit_AsyncFunctionDef = visit_FunctionDef
            visit_ClassDef = visit_FunctionDef
            visit_Lambda = visit_FunctionDef

            def visit_While(self, node):
                found.append(node)
                self.generic_visit(node)

            visit_For = visit_While
            visit_AsyncFor = visit_While

        for s in stmts:
            V().visit(s)
        return any(_has(lp.body, ast.Return) is not None for lp in found)

    @staticmethod
    def _thunk(expr):
        return ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=expr)

    def run(self, fdef) -> bool:
        """Apply in place; True when the function was rewritten."""
        if not self._loop_has_return(fdef.body):
            return False
        fdef.body = self._transform_block(list(fdef.body), fdef.lineno)
        ast.fix_missing_locations(fdef)
        return True

    def _transform_block(self, stmts, lineno):
        """Bring a function-level block into single-exit form: the first
        statement whose loops carry a lowered ``return`` splits the
        block — everything after it moves into a ``__dy2st_tail_N``
        closure (evaluated only when no lowered return fired, so names
        FIRST bound after the loop stay ordinary locals of the tail) and
        the block ends with ``return __dy2st_ret_select(...)``. Blocks
        with no return-carrying loop are returned unchanged."""
        for i, st in enumerate(stmts):
            sites: list = []
            if isinstance(st, (ast.While, ast.For)) and \
                    _has(st.body, ast.Return) is not None:
                st.body = self._lower_in_loop(st.body, sites) or [ast.Pass()]
            elif isinstance(st, ast.If) and self._loop_has_return([st]):
                # a loop-with-return nested in an if branch: flags set
                # inside propagate out of the converted if (plain stored
                # names); statements after the loop within the branch are
                # guarded by _lower_branch
                st.body = self._lower_branch(list(st.body), sites)
                st.orelse = self._lower_branch(list(st.orelse), sites)
            if not sites:
                continue
            inits = [ast.copy_location(ast.Assign(
                targets=[ast.Name(id=f, ctx=ast.Store())],
                value=ast.Constant(value=False)), st)
                for f, _ in sites]
            remainder = stmts[i + 1:]
            return (stmts[:i] + inits + [st]
                    + self._make_tail_return(remainder, sites, st))
        return stmts

    def _make_tail_return(self, remainder, sites, anchor):
        """Build ``[<preamble>, def __dy2st_tail_N(...), return
        __dy2st_ret_select(loc, tail, *sites)]``. The tail closure holds
        the whole post-loop remainder (recursively transformed), so its
        natural ``return`` stays inside it and new names bind as tail
        locals; stores that shadow pre-loop names are snapshot as default
        arguments (the _make_call pattern) to dodge UnboundLocalError."""
        loc = self._loc(anchor)
        out = []
        if remainder:
            stores = sorted(_store_names(remainder))
            tail_name = f"__dy2st_tail_{self.n}"
            self.n += 1
            tail_body = self._transform_block(remainder, anchor.lineno) \
                or [ast.Pass()]
            tail_def = ast.FunctionDef(
                name=tail_name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=a) for a in stores],
                    kwonlyargs=[], kw_defaults=[],
                    defaults=[ast.Name(id=a, ctx=ast.Load())
                              for a in stores]),
                body=tail_body, decorator_list=[], type_params=[])
            out += _RewriteControlFlow._undef_preamble(stores)
            out.append(tail_def)
            default = ast.Name(id=tail_name, ctx=ast.Load())
        else:
            default = self._thunk(ast.Constant(value=None))
        sel = ast.Return(value=ast.Call(
            func=ast.Name(id="__dy2st_ret_select", ctx=ast.Load()),
            args=[ast.Constant(value=loc), default]
            + [ast.Tuple(elts=[ast.Name(id=f, ctx=ast.Load()),
                               self._thunk(e)], ctx=ast.Load())
               for f, e in sites],
            keywords=[]))
        out.append(sel)
        return [ast.copy_location(s, anchor) for s in out]

    def _lower_branch(self, block, sites):
        """Inside an if-branch on the spine (no ``break`` available, no
        early block exit): lower return-carrying loops; statements after
        one are wrapped in ``if not (<its flags>):`` so they are skipped
        once a return fired. Plain direct Returns stay (the branch
        conversion or the eager fallback owns them)."""
        for i, st in enumerate(block):
            local: list = []
            if isinstance(st, (ast.While, ast.For)) and \
                    _has(st.body, ast.Return) is not None:
                st.body = self._lower_in_loop(st.body, local) or [ast.Pass()]
            elif isinstance(st, ast.If) and self._loop_has_return([st]):
                st.body = self._lower_branch(list(st.body), local)
                st.orelse = self._lower_branch(list(st.orelse), local)
            if not local:
                continue
            sites.extend(local)
            rest = self._lower_branch(block[i + 1:], sites)
            out = block[:i + 1]
            if rest:
                guard = ast.If(
                    test=ast.UnaryOp(
                        op=ast.Not(),
                        operand=self._flags_or([f for f, _ in local])),
                    body=rest, orelse=[])
                out.append(ast.copy_location(guard, st))
            return out
        return block

    def _lower_in_loop(self, block, sites):
        """Inside a loop body: Return -> flag + break (dead code after a
        return in the same block is dropped; the later escape lowering
        guards cross-statement paths)."""
        out = []
        for st in block:
            if isinstance(st, ast.Return):
                flag = f"__ret_flag_{self.n}"
                self.n += 1
                expr = st.value if st.value is not None \
                    else ast.Constant(value=None)
                sites.append((flag, expr))
                out.append(ast.copy_location(ast.Assign(
                    targets=[ast.Name(id=flag, ctx=ast.Store())],
                    value=ast.Constant(value=True)), st))
                out.append(ast.copy_location(ast.Break(), st))
                return out
            if isinstance(st, ast.If) and _has([st], ast.Return) is not None:
                st.body = self._lower_in_loop(st.body, sites) or [ast.Pass()]
                st.orelse = self._lower_in_loop(st.orelse, sites)
                out.append(st)
                continue
            if isinstance(st, (ast.While, ast.For)) and \
                    _has(st.body, ast.Return) is not None:
                inner: list = []
                st.body = self._lower_in_loop(st.body, inner) or [ast.Pass()]
                out.append(st)
                if inner:
                    sites.extend(inner)
                    # the fired return must escape THIS loop too
                    out.append(ast.copy_location(ast.If(
                        test=self._flags_or([f for f, _ in inner]),
                        body=[ast.Break()], orelse=[]), st))
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)) and \
                    _has([st], ast.Return) is not None:
                st.body = self._lower_in_loop(st.body, sites) or [ast.Pass()]
                out.append(st)
                continue
            if isinstance(st, (ast.Try, ast.Match)) and \
                    _has([st], ast.Return) is not None:
                raise ConversionError(
                    f"{self._loc(st)}: `return` inside a "
                    f"{type(st).__name__.lower()} block of a converted "
                    "loop is not supported; move the return out of the "
                    "block")
            out.append(st)
        return out


class _RewriteControlFlow(ast.NodeTransformer):
    """Rewrite If/While statements into convert_ifelse/convert_while calls."""

    def __init__(self, filename: str):
        self.filename = filename
        self.counter = 0

    def _loc(self, node) -> str:
        return f"{self.filename}:{node.lineno}"

    @staticmethod
    def _undef_preamble(names):
        """`try: name / except NameError: name = UNDEFINED` per name, so a
        name bound in only one branch/iteration traces as an UNDEFINED leaf
        instead of crashing with NameError inside the branch closure."""
        out = []
        for a in names:
            out.append(ast.Try(
                body=[ast.Expr(value=ast.Name(id=a, ctx=ast.Load()))],
                handlers=[ast.ExceptHandler(
                    type=ast.Name(id="NameError", ctx=ast.Load()),
                    name=None,
                    body=[ast.Assign(
                        targets=[ast.Name(id=a, ctx=ast.Store())],
                        value=ast.Name(id="__dy2st_UNDEFINED",
                                       ctx=ast.Load()))])],
                orelse=[], finalbody=[]))
        return out

    @staticmethod
    def _undef_cleanup(names):
        """`if name is UNDEFINED: del name` per name — restores the exact
        unbound-variable behaviour after the concrete path leaves a
        placeholder in a variable its taken branch never assigned."""
        out = []
        for a in names:
            out.append(ast.If(
                test=ast.Compare(
                    left=ast.Name(id=a, ctx=ast.Load()),
                    ops=[ast.Is()],
                    comparators=[ast.Name(id="__dy2st_UNDEFINED",
                                          ctx=ast.Load())]),
                body=[ast.Delete(
                    targets=[ast.Name(id=a, ctx=ast.Del())])],
                orelse=[]))
        return out

    def _guard_test(self, node, reason: str):
        """Leave the statement in Python form, but wrap its test so a
        TRACED predicate raises the actionable ConversionError while
        concrete predicates behave exactly as before."""
        node.test = ast.Call(
            func=ast.Name(id="__dy2st_check_unconvertible", ctx=ast.Load()),
            args=[self._convert_bool_expr(node.test, self._loc(node)),
                  ast.Constant(value=self._loc(node)),
                  ast.Constant(value=reason)],
            keywords=[])
        ast.copy_location(node.test, node)
        return node

    # -- if ------------------------------------------------------------------
    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        body, orelse = node.body, node.orelse
        esc = _has(body + orelse, (ast.Break, ast.Continue),
                   prune_loops=True)
        if esc is not None:
            # cannot pull a loop-escape statement into a branch function;
            # keep Python form, diagnose only if the predicate is traced
            return self._guard_test(
                node,
                f"`{type(esc).__name__.lower()}` inside a data-dependent "
                "`if` is not convertible; fold the condition into the "
                "enclosing loop predicate")
        rets = (_has(body, ast.Return), _has(orelse, ast.Return))
        loc = self._loc(node)
        n = self.counter
        self.counter += 1
        if rets[0] or rets[1]:
            # supported: BOTH branches are a single `return <expr>`
            if (len(body) == 1 and isinstance(body[0], ast.Return)
                    and len(orelse) == 1 and isinstance(orelse[0], ast.Return)
                    and body[0].value is not None
                    and orelse[0].value is not None):
                defs, call = self._make_call(
                    node, n, [ast.Return(value=body[0].value)],
                    [ast.Return(value=orelse[0].value)], returning=True)
                return [ast.copy_location(s, node)
                        for s in defs + [ast.Return(value=call)]]
            return self._guard_test(
                node,
                "`return` inside a data-dependent `if` is convertible only "
                "as `if p: return a` + `else: return b` (both branches a "
                "single return); restructure, or compute the value with "
                "paddle.where")
        assigned = sorted((_store_names(body) | _store_names(orelse)))
        defs, call = self._make_call(node, n, body, orelse, names=assigned)
        if assigned:
            target = ast.Tuple(
                elts=[ast.Name(id=a, ctx=ast.Store()) for a in assigned],
                ctx=ast.Store())
            stmts = (self._undef_preamble(assigned) + defs
                     + [ast.Assign(targets=[target], value=call)]
                     + self._undef_cleanup(assigned))
        else:
            stmts = defs + [ast.Expr(value=call)]
        return [ast.copy_location(s, node) for s in stmts]

    def _make_call(self, node, n, body, orelse, names=None, returning=False):
        """Build __dy2st_true_N/__dy2st_false_N defs + the convert call."""
        def branch(name, stmts):
            stmts = list(stmts) or [ast.Pass()]
            params, defaults = [], []
            if not returning:
                tup = ast.Tuple(
                    elts=[ast.Name(id=a, ctx=ast.Load()) for a in names],
                    ctx=ast.Load())
                stmts = stmts + [ast.Return(value=tup)]
                # read+assign of the same name inside the branch closure
                # (e.g. `s = s + x`) would shadow the enclosing binding and
                # hit UnboundLocalError; snapshot the pre-if values as
                # default arguments instead (evaluated at def time, after
                # the UNDEFINED preamble, so always bound)
                params = [ast.arg(arg=a) for a in names]
                defaults = [ast.Name(id=a, ctx=ast.Load()) for a in names]
            return ast.FunctionDef(
                name=name, args=ast.arguments(
                    posonlyargs=[], args=params, kwonlyargs=[],
                    kw_defaults=[], defaults=defaults),
                body=stmts, decorator_list=[], type_params=[])

        tfn = branch(f"__dy2st_true_{n}", body)
        ffn = branch(f"__dy2st_false_{n}", orelse)
        kw = []
        if not returning and names:
            kw.append(ast.keyword(
                arg="names",
                value=ast.Tuple(elts=[ast.Constant(value=a) for a in names],
                                ctx=ast.Load())))
        call = ast.Call(
            func=ast.Name(id="__dy2st_convert_ifelse", ctx=ast.Load()),
            args=[self._convert_bool_expr(node.test, self._loc(node)),
                  ast.Name(id=tfn.name, ctx=ast.Load()),
                  ast.Name(id=ffn.name, ctx=ast.Load()),
                  ast.Constant(value=self._loc(node))],
            keywords=kw)
        return [tfn, ffn], call

    # -- break/continue flag lowering ---------------------------------------
    @staticmethod
    def _lower_escapes(stmts, brk: str, cont: str):
        """Rewrite ``break``/``continue`` in a loop body into flag
        assignments (``brk``/``cont`` = True), guarding every statement
        that follows a potential escape with ``if not (brk or cont):``
        (the reference dy2static's break_continue_transformer). Does not
        descend into nested loops or function defs (their escapes are
        theirs). Returns the rewritten statement list."""
        def set_flag(name):
            return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                              value=ast.Constant(value=True))

        def has_escape(nodes):
            return _has(nodes, (ast.Break, ast.Continue),
                        prune_loops=True) is not None

        def guard(rest):
            """if not (brk or cont): <rest>"""
            test = ast.UnaryOp(
                op=ast.Not(),
                operand=ast.BoolOp(op=ast.Or(), values=[
                    ast.Name(id=brk, ctx=ast.Load()),
                    ast.Name(id=cont, ctx=ast.Load())]))
            return ast.If(test=test, body=rest, orelse=[])

        def rewrite(block):
            out = []
            for i, st in enumerate(block):
                if isinstance(st, ast.Break):
                    out.append(set_flag(brk))
                    return out                     # rest of block is dead
                if isinstance(st, ast.Continue):
                    out.append(set_flag(cont))
                    return out
                if isinstance(st, ast.If) and has_escape([st]):
                    new_if = ast.If(test=st.test,
                                    body=rewrite(st.body) or [ast.Pass()],
                                    orelse=rewrite(st.orelse))
                    ast.copy_location(new_if, st)
                    out.append(new_if)
                    rest = rewrite(block[i + 1:])
                    if rest:
                        out.append(ast.copy_location(guard(rest), st))
                    return out
                if isinstance(st, (ast.While, ast.For, ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                    out.append(st)                 # inner escapes are theirs
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)) and \
                        has_escape([st]):
                    # the context manager exits before the escape takes
                    # effect outside it: rewrite the with-body and guard
                    # the statements that follow
                    new_with = type(st)(items=st.items,
                                        body=rewrite(st.body) or [ast.Pass()])
                    ast.copy_location(new_with, st)
                    out.append(new_with)
                    rest = rewrite(block[i + 1:])
                    if rest:
                        out.append(ast.copy_location(guard(rest), st))
                    return out
                if isinstance(st, (ast.Try, ast.Match)) and has_escape([st]):
                    raise ConversionError(
                        f"break/continue inside {type(st).__name__.lower()} "
                        "blocks of a converted loop are not supported")
                out.append(st)
            return out

        return rewrite(list(stmts))

    def _lower_loop_escapes(self, node):
        """If the loop body breaks/continues, lower the escapes to flags,
        fold ``not brk`` into the loop test, and return
        (node, pre_stmts); otherwise (node, []). The synthetic
        ``__dy2st_brk/cont`` flags stay bound after an eager loop — a
        namespaced, harmless residue."""
        esc = _has(node.body, (ast.Break, ast.Continue), prune_loops=True)
        if esc is None:
            return node, []
        n = self.counter
        self.counter += 1
        brk = f"__dy2st_brk_{n}"
        cont = f"__dy2st_cont_{n}"
        body = self._lower_escapes(node.body, brk, cont)
        reset_cont = ast.Assign(
            targets=[ast.Name(id=cont, ctx=ast.Store())],
            value=ast.Constant(value=False))
        node.body = [reset_cont] + body
        node.test = ast.BoolOp(op=ast.And(), values=[
            node.test,
            ast.UnaryOp(op=ast.Not(),
                        operand=ast.Name(id=brk, ctx=ast.Load()))])
        # both flags init False BEFORE the loop: they ride the carry, and
        # a traced while rejects undefined carried variables
        pre = [ast.Assign(
            targets=[ast.Name(id=name, ctx=ast.Store())],
            value=ast.Constant(value=False))
            for name in (brk, cont)]
        for s in pre + [node]:
            ast.copy_location(s, node)
        # synthetic subtrees (flag tests, guards, assigns) need locations
        # before any further visiting reads node.lineno
        ast.fix_missing_locations(node)
        for s in pre:
            ast.fix_missing_locations(s)
        return node, pre

    # -- while ---------------------------------------------------------------
    def visit_While(self, node: ast.While):
        if node.orelse:
            self.generic_visit(node)
            return self._guard_test(
                node, "`while ... else` is not convertible")
        node, pre = self._lower_loop_escapes(node)
        self.generic_visit(node)
        loc = self._loc(node)
        bad = _has(node.body, ast.Return)
        if bad is not None:
            guarded = self._guard_test(
                node,
                f"`return` (line {bad.lineno}) inside a data-dependent "
                "`while` is not convertible to a compiled loop; fold the "
                "exit condition into the loop predicate")
            return pre + [guarded] if pre else guarded
        # carry = names the body assigns; loop-invariant reads (modules,
        # helper fns, constants) stay closure-captured. Synthetic
        # __dy2st_* names (nested-loop temporaries, escape flags) are
        # carried ONLY when their value actually crosses iterations —
        # i.e. they are read in the test or read before being assigned
        # within one pass over the body; everything else (an inner loop's
        # range triple, index var, flags — re-initialised every
        # iteration) stays body-local, since carrying them would demand
        # pre-loop definitions that do not exist.
        stores = _store_names(node.body)
        user = {a for a in stores if not a.startswith("__dy2st_")}
        synth = stores - user
        need = _load_names(node.test, prune_defs=True) & synth
        definite: set = set()
        for st in node.body:
            need |= (_load_names(st, prune_defs=True) & synth) - definite
            definite |= _store_names([st])
        carried = sorted(user | need)
        n = self.counter
        self.counter += 1

        def loads():
            return ast.Tuple(
                elts=[ast.Name(id=a, ctx=ast.Load()) for a in carried],
                ctx=ast.Load())

        carry_tuple_s = ast.Tuple(
            elts=[ast.Name(id=a, ctx=ast.Store()) for a in carried],
            ctx=ast.Store())
        def arg():
            return ast.arguments(
                posonlyargs=[], args=[ast.arg(arg="__dy2st_carry")],
                kwonlyargs=[], kw_defaults=[], defaults=[])

        def unpack():
            return ast.Assign(
                targets=[ast.Tuple(
                    elts=[ast.Name(id=a, ctx=ast.Store()) for a in carried],
                    ctx=ast.Store())],
                value=ast.Name(id="__dy2st_carry", ctx=ast.Load()))

        cond_fn = ast.FunctionDef(
            name=f"__dy2st_cond_{n}", args=arg(),
            body=[unpack(), ast.Return(value=self._convert_bool_expr(
                node.test, loc))],
            decorator_list=[], type_params=[])
        body_fn = ast.FunctionDef(
            name=f"__dy2st_body_{n}", args=arg(),
            body=[unpack()] + list(node.body)
            + [ast.Return(value=loads())],
            decorator_list=[], type_params=[])
        call = ast.Call(
            func=ast.Name(id="__dy2st_convert_while", ctx=ast.Load()),
            args=[ast.Name(id=cond_fn.name, ctx=ast.Load()),
                  ast.Name(id=body_fn.name, ctx=ast.Load()),
                  loads(),
                  ast.Constant(value=loc)],
            keywords=[])
        assign = ast.Assign(targets=[carry_tuple_s], value=call)
        return [ast.copy_location(s, node)
                for s in (pre + self._undef_preamble(carried)
                          + [cond_fn, body_fn, assign]
                          + self._undef_cleanup(carried))]

    # -- for -----------------------------------------------------------------
    def visit_For(self, node: ast.For):
        """``for <target> in range(...)`` desugars to the while form (the
        loop variable advances at body start, so break/continue lowering
        cannot skip the increment) and rides the existing while
        conversion. Non-range iterables stay Python loops with a runtime
        guard that raises the actionable error on traced tensors."""
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords)
        if not is_range or node.orelse or not isinstance(node.target,
                                                         ast.Name):
            self.generic_visit(node)
            guard = ast.Call(
                func=ast.Name(id="__dy2st_check_iterable", ctx=ast.Load()),
                args=[node.iter, ast.Constant(value=self._loc(node))],
                keywords=[])
            node.iter = ast.copy_location(guard, node.iter)
            return node
        n = self.counter
        self.counter += 1
        start, stop, step = (f"__dy2st_start_{n}", f"__dy2st_stop_{n}",
                             f"__dy2st_step_{n}")
        ivar = f"__dy2st_i_{n}"
        unpack = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store())
                      for v in (start, stop, step)], ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__dy2st_range_args", ctx=ast.Load()),
                args=[ast.Constant(value=self._loc(node))]
                + list(node.iter.args), keywords=[]))
        init = ast.Assign(targets=[ast.Name(id=ivar, ctx=ast.Store())],
                          value=ast.Name(id=start, ctx=ast.Load()))
        # pre-bind the loop target (it rides the while carry; Python leaves
        # it unbound on zero trips — here it holds `start`, documented)
        init_target = ast.Assign(
            targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
            value=ast.Name(id=start, ctx=ast.Load()))
        set_target = ast.Assign(
            targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
            value=ast.Name(id=ivar, ctx=ast.Load()))
        advance = ast.Assign(
            targets=[ast.Name(id=ivar, ctx=ast.Store())],
            value=ast.BinOp(left=ast.Name(id=ivar, ctx=ast.Load()),
                            op=ast.Add(),
                            right=ast.Name(id=step, ctx=ast.Load())))
        test = ast.Call(
            func=ast.Name(id="__dy2st_range_cont", ctx=ast.Load()),
            args=[ast.Name(id=ivar, ctx=ast.Load()),
                  ast.Name(id=stop, ctx=ast.Load()),
                  ast.Name(id=step, ctx=ast.Load())],
            keywords=[])
        while_node = ast.While(
            test=test, body=[set_target, advance] + list(node.body),
            orelse=[])
        for s in (unpack, init, init_target, while_node):
            ast.copy_location(s, node)
        ast.fix_missing_locations(while_node)
        converted = self.visit(while_node)
        if not isinstance(converted, list):
            converted = [converted]
        return [unpack, init, init_target] + converted

    # -- boolean operators in PREDICATE position -----------------------------
    def _convert_bool_expr(self, expr, loc: str):
        """Rewrite and/or/not in a test expression. Only boolean CONTEXT
        propagates the rewrite: recursion descends through BoolOp operands
        and Not operands, never into arbitrary sub-expressions — a
        value-position `x or default` keeps exact Python semantics (and
        fails loudly on tracers), because convert_bool_op collapses traced
        operands to a boolean tensor."""
        if isinstance(expr, ast.BoolOp):
            op = "and" if isinstance(expr.op, ast.And) else "or"
            thunks = [ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=self._convert_bool_expr(v, loc)) for v in expr.values]
            call = ast.Call(
                func=ast.Name(id="__dy2st_bool_op", ctx=ast.Load()),
                args=[ast.Constant(value=op), ast.Constant(value=loc)]
                + thunks,
                keywords=[])
            return ast.copy_location(call, expr)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            call = ast.Call(
                func=ast.Name(id="__dy2st_not", ctx=ast.Load()),
                args=[self._convert_bool_expr(expr.operand, loc),
                      ast.Constant(value=loc)],
                keywords=[])
            return ast.copy_location(call, expr)
        return expr


def convert_control_flow(fn: Callable) -> Callable:
    """AST-rewrite ``fn`` so tensor-predicated if/while lower to
    converted selects and loops at trace time (and run unchanged eagerly).

    Returns ``fn`` unmodified (with a warning) when its source is
    unavailable (builtins, C extensions, REPL-defined lambdas).
    """
    if inspect.ismethod(fn):
        conv = convert_control_flow(fn.__func__)
        if conv is fn.__func__:
            return fn
        return types.MethodType(conv, fn.__self__)
    # operate on the innermost function of a wraps-style decorator chain:
    # its source carries the decorator lines, and its closure/globals are
    # the ones the rewritten body must see (ADVICE r3 #5)
    orig = fn
    fn = inspect.unwrap(fn)
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        filename = inspect.getsourcefile(fn) or "<dy2static>"
    except (OSError, TypeError):
        warnings.warn(
            f"dy2static: source of {getattr(fn, '__name__', fn)!r} is "
            "unavailable; data-dependent control flow will fail in a compiled program",
            stacklevel=2)
        return orig
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return orig
    if _has(fdef.body, (ast.If, ast.While, ast.For, ast.BoolOp)) is None:
        return orig  # nothing to rewrite
    # Decorators are NEVER re-executed (re-exec'ing decorator source would
    # re-run registration side effects, recurse through aliased to_static,
    # and NameError on def-time-local arguments). Wrapper behavior from
    # decorators BELOW the conversion entry is preserved instead by
    # re-binding the live wrapper chain's closure cell onto the converted
    # function after the rewrite — see the `orig is not fn` tail
    # (ADVICE r3 #5).
    fdef.decorator_list = []
    try:
        _ReturnLowering(filename).run(fdef)
        new_tree = _RewriteControlFlow(filename).visit(tree)
    except ConversionError as e:
        from ..flags import flag_value
        if flag_value("dy2static_fallback"):
            warnings.warn(
                f"dy2static: conversion of "
                f"{getattr(fn, '__name__', fn)!r} failed ({e}); falling "
                "back to the eager path (set FLAGS_dy2static_fallback=0 "
                "for the strict raise)", stacklevel=2)
            return orig
        raise
    ast.fix_missing_locations(new_tree)
    glb = dict(fn.__globals__)
    glb["__dy2st_convert_ifelse"] = convert_ifelse
    glb["__dy2st_convert_while"] = convert_while
    glb["__dy2st_check_unconvertible"] = check_unconvertible
    glb["__dy2st_UNDEFINED"] = UNDEFINED
    glb["__dy2st_bool_op"] = convert_bool_op
    glb["__dy2st_not"] = convert_not
    glb["__dy2st_range_args"] = convert_range_args
    glb["__dy2st_range_cont"] = convert_range_cont
    glb["__dy2st_check_iterable"] = check_iterable
    glb["__dy2st_ret_select"] = convert_ret_select
    freevars = fn.__code__.co_freevars
    if freevars:
        # re-bind the original closure: wrap the rewritten def in a factory
        # taking the free variables as parameters (their CURRENT cell values
        # are snapshotted at conversion time)
        factory = ast.FunctionDef(
            name="__dy2st_factory",
            args=ast.arguments(
                posonlyargs=[], args=[ast.arg(arg=v) for v in freevars],
                kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=[new_tree.body[0],
                  ast.Return(value=ast.Name(id=fdef.name, ctx=ast.Load()))],
            decorator_list=[], type_params=[])
        new_tree = ast.Module(body=[factory], type_ignores=[])
        ast.fix_missing_locations(new_tree)
        code = compile(new_tree, filename, "exec")
        loc: dict = {}
        exec(code, glb, loc)
        cells = [c.cell_contents for c in (fn.__closure__ or ())]
        new_fn = loc["__dy2st_factory"](*cells)
    else:
        code = compile(new_tree, filename, "exec")
        loc = {}
        exec(code, glb, loc)
        new_fn = loc[fdef.name]
    new_fn = functools.wraps(fn)(new_fn)
    new_fn.__dy2st_source__ = fn
    if orig is not fn:
        # ``orig`` is a live wraps-style wrapper chain around ``fn`` (user
        # decorators below the conversion entry). Preserve their per-call
        # behavior by pointing the wrapper that calls ``fn`` at the
        # converted function: find its closure cell holding ``fn`` and
        # re-bind it. The converted body is semantically identical eagerly,
        # so mutating the shared cell is safe — but NOTE the rebind is
        # PROCESS-WIDE: every other call site of the shared wrapper object
        # switches to the converted body too (including its zero-trip-loop
        # target binding and bool-op eager-eval deviations). Gate:
        # FLAGS_dy2static_rebind_wrappers=0 keeps the wrapper untouched and
        # returns the converted function bare (the wrapper's per-call
        # behavior then only runs on the unconverted object). If no cell
        # holding ``fn`` exists (the decorator stashed it somewhere
        # opaque), warn — never drop silently (ADVICE r3 #5, r4 #2).
        from ..flags import flag_value
        if not flag_value("dy2static_rebind_wrappers"):
            warnings.warn(
                f"dy2static: FLAGS_dy2static_rebind_wrappers=0 — the "
                f"decorator wrapping {getattr(orig, '__name__', orig)!r} "
                "is left untouched and its per-call behavior is dropped "
                "from the converted path", stacklevel=2)
            return new_fn
        import logging
        logging.getLogger(__name__).debug(
            "dy2static: re-binding the wrapper chain of %r onto the "
            "converted function (process-wide effect on the shared "
            "wrapper; FLAGS_dy2static_rebind_wrappers=0 disables)",
            getattr(orig, "__name__", orig))
        link = orig
        while link is not None and link is not fn:
            for cell in (getattr(link, "__closure__", None) or ()):
                try:
                    held = cell.cell_contents
                except ValueError:   # empty cell
                    continue
                # match the raw fn OR a previous conversion of it, so
                # converting the same decorated function twice stays
                # idempotent instead of spuriously warning
                if held is fn or getattr(held, "__dy2st_source__",
                                         None) is fn:
                    cell.cell_contents = new_fn
                    return orig
            link = getattr(link, "__wrapped__", None)
        warnings.warn(
            f"dy2static: {getattr(orig, '__name__', orig)!r} is wrapped by "
            "a decorator whose reference to the original function cannot "
            "be re-bound; the decorator's per-call behavior is dropped "
            "from the converted path (the original object keeps it)",
            stacklevel=2)
    return new_fn
