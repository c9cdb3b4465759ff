"""Activation recomputation — counterpart of
``paddle_tpu/distributed/fleet/recompute.py``.

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint`` (non-reentrant): the activations inside are
not kept, and the backward runs the function again to rebuild them.
Non-reentrant checkpointing records the parameters of every ``Layer``
the function reaches (itself, a bound ``self``, ``functools.partial``
arguments, closure cells), so their gradients flow without lifting
them into the region as the reference must.

The key stream. Dropout draws from the port's own Threefry stream
(``paddle_tpu_torch.random``), which torch's ``preserve_rng_state``
does not cover: a recomputed forward calling ``next_key()`` again would
draw other masks, and the gradients would be wrong without an error.
The reference's ``jax.checkpoint`` replays the traced keys. Here the
forward records the stream's position (counter, base key and, inside a
compiled program's body, the body's key); the recomputation runs from
that position and then puts the stream back where it was, so the
recomputed masks are the forward's and the backward draws nothing: the
stream advances once per call, as the reference's does (measured:
``paddle_tpu.random``'s counter moves as far with and without
recompute).

Side channels. A value a sublayer writes onto itself during the call
(``l_aux``, the MoE gate's auxiliary loss) is the forward's after the
backward too: the recomputation's writes are undone.
"""

from __future__ import annotations

import functools
from typing import Callable, List

from torch.utils.checkpoint import checkpoint

from ...core.tensor import Tensor


def _find_layers(function) -> List:
    """The Layers reachable from ``function``: itself, its bound self,
    partial args, and any Layer captured in its closure (the ``lambda x:
    self.block(x)`` pattern)."""
    from ...nn.layer import Layer

    found = []

    def add(obj):
        if isinstance(obj, Layer) and all(obj is not l for l in found):
            found.append(obj)

    add(function)
    add(getattr(function, "__self__", None))
    if isinstance(function, functools.partial):
        for a in list(function.args) + list(function.keywords.values()):
            add(a)
        add(getattr(function.func, "__self__", None))
    closure = getattr(function, "__closure__", None)
    if closure:
        for cell in closure:
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            add(v)
            add(getattr(v, "__self__", None))
    return found


def _aux_values(layers):
    return {id(sub): (sub, sub.l_aux)
            for layer in layers
            for _, sub in layer.named_sublayers(include_self=True)
            if isinstance(getattr(sub, "l_aux", None), Tensor)}


class _Forward:
    """The forward's scope: records the key stream's position at entry
    and the layers' side-channel values at exit."""

    def __init__(self, rec: dict, layers):
        self.rec, self.layers = rec, layers

    def __enter__(self):
        from ... import random as R
        s = R._state
        self.rec["stream"] = (s.counter, s.base_key, s.traced_key)
        return self

    def __exit__(self, *exc):
        self.rec["aux"] = _aux_values(self.layers)
        return False


class _Recompute:
    """The recomputation's scope: runs from the forward's stream
    position, then restores the stream and the side-channel values."""

    def __init__(self, rec: dict):
        self.rec = rec

    def __enter__(self):
        from ... import random as R
        s = R._state
        self.prev = (s.counter, s.base_key, s.traced_key)
        s.counter, s.base_key, s.traced_key = self.rec["stream"]
        return self

    def __exit__(self, *exc):
        from ... import random as R
        s = R._state
        s.counter, s.base_key, s.traced_key = self.prev
        for sub, value in self.rec.get("aux", {}).values():
            sub.l_aux = value
        return False


def _recompute(function: Callable, args, kwargs, layers,
               preserve_rng_state: bool = True):
    rec: dict = {}
    pos = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
    stops = [args[i]._sg for i in pos]

    def run(*vals):
        # the Tensor arguments pass as their torch values, so that
        # checkpoint keeps the forward's values for the recomputation
        full = list(args)
        for i, v, sg in zip(pos, vals, stops):
            full[i] = Tensor._wrap(v, sg)
        return function(*full, **kwargs)

    return checkpoint(run, *[args[i]._value for i in pos],
                      use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=lambda: (_Forward(rec, layers),
                                          _Recompute(rec)))


def recompute(function: Callable, *args, use_reentrant=True,
              preserve_rng_state=True, **kwargs):
    """Run ``function(*args, **kwargs)`` under rematerialisation (module
    docstring). ``use_reentrant`` is accepted; the port always
    checkpoints non-reentrantly."""
    return _recompute(function, args, kwargs, _find_layers(function),
                      preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Checkpoint a Sequential (or a list of callables) segment by
    segment: ``n // ctx["segments"]`` callables a segment (a remainder
    makes one more), each segment one recomputed region."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    n = len(funcs)
    seg_size = max(n // max(segments, 1), 1)
    x = args[0] if len(args) == 1 else args

    def run_segment(seg, y):
        for f in seg:
            y = f(y)
        return y

    for i in range(0, n, seg_size):
        seg = funcs[i:i + seg_size]
        layers = [l for f in seg for l in _find_layers(f)]
        x = _recompute(functools.partial(run_segment, seg), (x,), {},
                       layers)
    return x


def recompute_hybrid(ctx, function, *args, **kwargs):
    """mp-aware recompute: the key stream replays as in
    :func:`recompute`; the reference's offload and per-mp-rank seeds
    change nothing more at one mp rank."""
    return recompute(function, *args, **kwargs)
