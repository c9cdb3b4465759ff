"""Per-group RNG state tracker — counterpart of
``paddle_tpu/distributed/meta_parallel/random_state.py``.

Each named state is a key of the port's Threefry stream (the
reference's ``jax.random.key(seed)``); ``rng_state(name)`` folds the
state's call counter and the name's hash into it and makes the result
the key stream's key for the body of the ``with`` (``random.
traced_key_scope``), so the draws there are the reference's bit for
bit. In manual-parallel mode with an active mp axis the key also folds
in this process's mp coordinate (the reference folds the device's mp
axis index inside ``shard_map``), so dropout differs across mp ranks.
"""

from __future__ import annotations

import contextlib
from typing import Dict

from ...inference import prng
from ...parallel import pcontext

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _stable_hash(name: str) -> int:
    h = 0
    for c in name:
        h = (h * 131 + ord(c)) % (2 ** 31 - 1)
    return h


def _mp_rank() -> int:
    from ..topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_rank() if hcg is not None else 0


class RNGStatesTracker:
    def __init__(self):
        self.states: Dict[str, object] = {}
        self.seeds = set()
        self._counters: Dict[str, int] = {}

    def reset(self):
        self.states = {}
        self.seeds = set()
        self._counters = {}

    def add(self, name: str, seed: int):
        if seed in self.seeds:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states:
            raise ValueError(f"state {name} already exists")
        self.seeds.add(seed)
        self.states[name] = prng.prng_key(seed)
        self._counters[name] = 0

    def get_states_tracker(self):
        return dict(self.states), dict(self._counters)

    def set_states_tracker(self, states):
        self.states, self._counters = dict(states[0]), dict(states[1])

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """Inside this context, framework RNG draws come from the named
        state (module docstring). Inside a compiled program's body the
        key derives from the body's own key, so every call draws fresh
        masks."""
        if name not in self.states:
            # lazily seeded, as the reference seeds it
            self.add(name, 2718 + len(self.states))
        from ... import random as _random

        self._counters[name] += 1
        ambient = _random._state.traced_key
        base = ambient if ambient is not None else self.states[name]
        key = prng.fold_in(base, self._counters[name])
        key = prng.fold_in(key, _stable_hash(name))
        if pcontext.in_manual_mode() and pcontext.manual_axis("mp") is not None:
            key = prng.fold_in(key, _mp_rank())
        with _random.traced_key_scope(key):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 2718):
    _tracker.reset()
    _tracker.add(MODEL_PARALLEL_RNG, seed)
