"""Manual-parallel execution context — counterpart of
``paddle_tpu/parallel/pcontext.py``.

The reference enters manual mode inside ``shard_map``, where layers
issue explicit collectives over named mesh axes. Here every rank is a
process and a collective is always explicit; the context says which
parallel dimensions are active (``manual_axis``), which the RNG
tracker's mp fold-in reads.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

_state = {
    "manual": False,          # True inside manual_parallel
    "axes": {},               # parallelism name -> mesh axis name
}


def in_manual_mode() -> bool:
    return _state["manual"]


def manual_axis(kind: str) -> Optional[str]:
    """Mesh axis name for 'mp' / 'dp' / 'pp' / 'sharding' / 'sep' /
    'expert', or None if that dimension is not active (degree 1)."""
    return _state["axes"].get(kind)


@contextlib.contextmanager
def manual_parallel(axes: Dict[str, str]):
    prev = dict(_state)
    _state["manual"] = True
    _state["axes"] = dict(axes)
    try:
        yield
    finally:
        _state.update(prev)
