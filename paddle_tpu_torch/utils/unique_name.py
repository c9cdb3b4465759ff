"""Unique-name generator — counterpart of
``paddle_tpu/utils/unique_name.py``: a counter per prefix, and the
``guard`` context manager for a fresh scope."""

from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "switch", "guard"]


class _Generator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, prefix: str) -> str:
        n = self.ids[prefix]
        self.ids[prefix] += 1
        return f"{prefix}_{n}"


_generator = _Generator()


def generate(key: str) -> str:
    """Next unique name for ``key`` ("fc" -> "fc_0", "fc_1", …)."""
    return _generator(key)


def switch(new_generator=None):
    """Swap the global generator; returns the previous one."""
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None else _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Fresh name scope within the context (reference guard)."""
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
