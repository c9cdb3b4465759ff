"""Per-step timing: host/device breakdown, tokens/sec, MFU estimate —
counterpart of ``paddle_tpu/observability/step_timer.py``.

``StepTimer`` wraps one unit of work per iteration (a training step, a
serving engine round). The host/device split uses the dispatch–fence
structure of the runtime: the step function *returns* when the host has
finished dispatching (host time); materialising the result blocks until
the device finishes (device time). Callers mark the boundary with
:meth:`host_done`; without it the whole step counts as host time.

MFU — model FLOPs utilization — is ``achieved_flops / peak_flops``:
supply ``flops_per_step`` (e.g. ``6 * params * tokens`` for a dense
transformer step) and ``peak_flops_per_s`` for the chip; both optional
(without them :meth:`summary` reports ``mfu = None``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..core.histogram import Histogram


class StepTimer:
    def __init__(self, flops_per_step: Optional[float] = None,
                 peak_flops_per_s: Optional[float] = None):
        self.flops_per_step = flops_per_step
        self.peak_flops_per_s = peak_flops_per_s
        self.step_ms = Histogram()
        self.host_ms = Histogram()
        self.device_ms = Histogram()
        self.steps = 0
        self.tokens = 0
        self.total_s = 0.0
        self._t0: Optional[int] = None
        self._t_host: Optional[int] = None

    # -- one step -----------------------------------------------------------

    def begin(self) -> None:
        self._t0 = time.perf_counter_ns()
        self._t_host = None

    def host_done(self) -> None:
        """Host finished dispatching; the remainder until :meth:`end` is
        device wait (the fence)."""
        if self._t0 is not None:
            self._t_host = time.perf_counter_ns()

    def end(self, tokens: int = 0) -> Optional[float]:
        """Close the step; returns its wall seconds (None if begin() was
        never called — tolerated so error paths need no bookkeeping)."""
        if self._t0 is None:
            return None
        t1 = time.perf_counter_ns()
        step_s = (t1 - self._t0) / 1e9
        host_s = ((self._t_host or t1) - self._t0) / 1e9
        self.step_ms.record(step_s * 1e3)
        self.host_ms.record(host_s * 1e3)
        self.device_ms.record((step_s - host_s) * 1e3)
        self.steps += 1
        self.tokens += int(tokens)
        self.total_s += step_s
        self._t0 = None
        self._t_host = None
        return step_s

    def step(self, tokens: int = 0):
        """``with timer.step(tokens=n): ...`` convenience wrapper."""
        return _StepCtx(self, tokens)

    # -- derived rates ------------------------------------------------------

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.total_s if self.total_s else 0.0

    def mfu(self) -> Optional[float]:
        """Mean MFU over the recorded steps (None without flops config)."""
        if (not self.steps or not self.total_s
                or self.flops_per_step is None
                or not self.peak_flops_per_s):
            return None
        achieved = self.flops_per_step * self.steps / self.total_s
        return achieved / self.peak_flops_per_s

    def summary(self) -> Dict[str, object]:
        return {
            "steps": self.steps,
            "step_ms": self.step_ms.summary(),
            "host_ms": self.host_ms.summary(),
            "device_ms": self.device_ms.summary(),
            "tokens": self.tokens,
            "tokens_per_s": self.tokens_per_s,
            "mfu": self.mfu(),
        }


class _StepCtx:
    def __init__(self, timer: StepTimer, tokens: int):
        self._timer = timer
        self._tokens = tokens

    def __enter__(self) -> StepTimer:
        self._timer.begin()
        return self._timer

    def __exit__(self, *exc) -> bool:
        self._timer.end(tokens=self._tokens)
        return False
