"""Per-request incremental token delivery —
counterpart of ``paddle_tpu/serving/stream.py``.

A :class:`TokenStream` is the consumer-facing half of a serving request:
tokens surface as each engine decode chunk completes (pushed by the
scheduler via the engine's ``token_callback``), not at ``collect()`` time.

Consumption models, all safe to mix:

* **callback** — ``submit(..., on_token=fn)``: ``fn(token)`` fires
  synchronously as the chunk is unpacked (lowest latency, runs on the
  scheduler thread — keep it cheap).
* **polling / same-thread driving** — ``stream.drain()`` returns the
  tokens that arrived since the previous drain; natural when one thread
  alternates ``scheduler.step(params)`` / ``stream.drain()``.
* **blocking iteration** — ``for tok in stream:`` from another thread
  blocks until tokens arrive and stops at end-of-stream.

End of stream carries a reason (``"complete"``, ``"cancelled"``,
``"shed:queue_full"``, ``"shed:deadline"``, ``"failed"``) and, for
failures, a structured :class:`ServingError`.

A consumer blocked in ``get()``/iteration must never hang forever on a
producer that died without closing the stream (an engine crash that
skips the finish callback, a router torn down by a fatal error).
:meth:`TokenStream.attach_producer` binds a liveness predicate: blocking
waits poll it, and the moment it reports the producer dead the stream
self-closes with a terminal ``ServingError("producer_dead")`` instead of
blocking indefinitely — no consumer-side timeout needed.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, List, Optional


class ServingError(RuntimeError):
    """Structured serving-layer error (shed / engine failure).

    ``code`` is machine-readable (``"shed_queue_full"``,
    ``"shed_deadline"``, ``"cancelled"``, ``"engine_failure"``); ``rid``
    is the serving request id the error applies to (None for
    scheduler-wide failures)."""

    def __init__(self, code: str, message: str, rid: Optional[int] = None):
        super().__init__(message)
        self.code = code
        self.rid = rid

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ServingError(code={self.code!r}, rid={self.rid}, " \
               f"message={self.args[0]!r})"


class TokenStream:
    """Thread-safe incremental token channel for one request."""

    def __init__(self, rid: int,
                 on_token: Optional[Callable[[int], None]] = None):
        self.rid = rid
        self._on_token = on_token
        self._cond = threading.Condition()
        self._tokens: List[int] = []      # everything delivered so far
        self._cursor = 0                  # drain()/iterator position
        self.finished = False
        self.finish_reason: Optional[str] = None
        self.error: Optional[ServingError] = None
        self._alive_fn: Optional[Callable[[], bool]] = None
        self._poll_s = 0.05

    def attach_producer(self, alive_fn: Callable[[], bool],
                        poll_s: float = 0.05) -> None:
        """Bind a producer-liveness predicate (see module docstring):
        while it returns True, blocking consumers wait normally; once it
        returns False and the stream is still open, the next blocked (or
        blocking) consumer closes it with a terminal
        ``ServingError("producer_dead")`` and unblocks everyone."""
        with self._cond:
            self._alive_fn = alive_fn
            self._poll_s = float(poll_s)
            self._cond.notify_all()

    # -- producer side (scheduler) ------------------------------------------

    def push(self, token: int) -> None:
        with self._cond:
            if self.finished:
                return
            self._tokens.append(token)
            self._cond.notify_all()
        if self._on_token is not None:
            self._on_token(token)

    def close(self, reason: str, error: Optional[ServingError] = None
              ) -> None:
        with self._cond:
            self._close_locked(reason, error)

    def _close_locked(self, reason: str,
                      error: Optional[ServingError]) -> None:
        if self.finished:
            return
        self.finished = True
        self.finish_reason = reason
        self.error = error
        self._cond.notify_all()

    def _producer_died_locked(self) -> bool:
        """Under the lock: terminally close an open stream whose bound
        producer reports dead. Returns True when the stream is (now)
        closed because of it."""
        if self._alive_fn is None or self.finished:
            return False
        try:
            alive = self._alive_fn()
        except Exception:
            alive = False            # a torn liveness probe IS death
        if alive:
            return False
        self._close_locked(
            "failed",
            ServingError("producer_dead",
                         f"producer for request {self.rid} died without "
                         "finishing the stream", rid=self.rid))
        return True

    # -- consumer side ------------------------------------------------------

    @property
    def tokens(self) -> List[int]:
        """Snapshot of every token delivered so far."""
        with self._cond:
            return list(self._tokens)

    def drain(self) -> List[int]:
        """Non-blocking: tokens that arrived since the previous drain."""
        with self._cond:
            new = self._tokens[self._cursor:]
            self._cursor = len(self._tokens)
            return new

    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        """Blocking: next undrained token, or None at end-of-stream (or
        on timeout, or when a bound producer died — the stream then
        carries a terminal ``producer_dead`` error)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while self._cursor >= len(self._tokens):
                if self.finished:
                    return None
                if self._producer_died_locked():
                    return None
                if deadline is None:
                    wait_t = self._poll_s if self._alive_fn is not None \
                        else None
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait_t = (remaining if self._alive_fn is None
                              else min(remaining, self._poll_s))
                self._cond.wait(wait_t)
            tok = self._tokens[self._cursor]
            self._cursor += 1
            return tok

    def __iter__(self) -> Iterator[int]:
        while True:
            tok = self.get()
            if tok is None:
                if self.finished:
                    return
                continue  # pragma: no cover - spurious wakeup only
            yield tok

    def result(self) -> List[int]:
        """All tokens, raising the stream's ServingError if it failed.
        Non-blocking — call after the scheduler has drained."""
        if self.error is not None:
            raise self.error
        return self.tokens
