"""Black-box journal: the fleet's nondeterminism frontier as a bounded,
versioned JSONL ring — every debug bundle becomes a runnable incident
(counterpart of ``paddle_tpu/observability/journal.py``).

The repo's signature discipline is byte-identical behavior under chaos
(failover, migration, disagg handoff, autoscale), but a flight bundle
was read-only: metrics, events and traces you can *look at*. This
module captures the complete set of inputs that make a fleet step loop
deterministic, so :mod:`.replay` can re-execute any bundle offline and
localize the first divergence to a (step, replica, component):

=========  ================================================================
frame      records
=========  ================================================================
``head``   schema version, model geometry (``model_spec``), fleet
           topology (``FleetRouter.journal_topology``: router kind +
           config, per-replica engine/scheduler/health knobs)
``step``   one router step: its 1-based counter and the injected-clock
           sample at step entry
``arrival`` one ``FleetRouter.submit``: router rid, prompt tokens +
           crc32, priority/deadline/budget, the RESOLVED sampler seed
           (pinned at the fleet boundary) and grammar fingerprint
``fault``  one consumed :class:`~paddle_tpu_torch.resilience.faults.Fault`
           (stable id + resolved scope) at the moment it fired
``health`` one replica breaker transition (healthy → suspect →
           ejected → half_open …), diffed at end of router step
``scale``  one autoscale ``ScaleRecord`` ref (seq/action/reason)
``wire``   one serialized wire message's digest (kind, crc32, nbytes)
           — disagg handoffs and multihost transfers
``handoff`` one prefill→decode KV handoff (src/dst/pages/outcome)
``admit``  one scheduler admission (scheduler rid → engine rid, per
           replica namespace)
``outcome`` one terminal request outcome: state/outcome/replica/
           failovers, the full stream tokens + crc32, and the engine's
           own terminal checksum
=========  ================================================================

Armed-gating follows ``flight``/``dispatch``: hot paths check the
module cell ``journal_armed`` (one list index, zero overhead disarmed
— guarded by ``benchmarks/bench_obs_overhead.py``). Every frame line
carries a crc32 of its canonical JSON; :func:`decode_journal` rejects
truncation, version skew, per-line corruption and sequence gaps with
structured :class:`JournalError` codes exactly like ``serving/wire.py``
rejects torn wire frames. Only stdlib + numpy here: ``serving/wire.py``
and ``resilience/faults.py`` tap into this module and must stay
importable without JAX.
"""

from __future__ import annotations

import json
import threading
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

import numpy as np

#: the current journal wire format; decode rejects anything else
JOURNAL_VERSION = 1

#: the one cell hot paths check before building a frame (mutable list so
#: callers read a stable module attribute, not a rebindable name)
journal_armed = [False]

#: structured decode-rejection codes (mirrors ``serving.wire.WireError``)
JOURNAL_ERROR_CODES = ("truncated", "version_skew", "checksum_mismatch",
                       "schema", "gap")


class JournalError(Exception):
    """Structured journal decode failure; ``code`` is one of
    :data:`JOURNAL_ERROR_CODES`."""

    def __init__(self, code: str, detail: str = ""):
        assert code in JOURNAL_ERROR_CODES, code
        self.code = code
        self.detail = detail
        super().__init__(f"journal {code}: {detail}")

    def as_dict(self) -> Dict[str, str]:
        return {"error": "journal", "code": self.code,
                "detail": self.detail}


def token_checksum(tokens) -> int:
    """crc32 over the int32 little-endian bytes of a token sequence —
    the stream/terminal checksum every ``outcome`` frame carries and
    the engine stamps at ``_retire``."""
    a = np.asarray(list(tokens) if not isinstance(tokens, np.ndarray)
                   else tokens, np.int32)
    return zlib.crc32(a.astype("<i4").tobytes()) & 0xFFFFFFFF


def canonical_frame(frame: Dict[str, Any]) -> Dict[str, Any]:
    """A frame minus its transport fields (``seq``, ``crc``) — the
    payload two journals are compared on."""
    return {k: v for k, v in frame.items() if k not in ("seq", "crc")}


def _sign(frame: Dict[str, Any]) -> str:
    """One JSONL line: the frame plus a crc32 of its canonical JSON
    (sorted keys, no crc) — per-line corruption is detectable without
    trusting any other line."""
    body = {k: v for k, v in frame.items() if k != "crc"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(canon.encode("utf-8")) & 0xFFFFFFFF
    return json.dumps({**body, "crc": crc}, sort_keys=True,
                      separators=(",", ":"))


def encode_frames(head: Dict[str, Any],
                  frames: List[Dict[str, Any]]) -> bytes:
    """Serialize a head payload + frame list to journal JSONL. Public
    so tests can re-sign a doctored journal (planted divergences)."""
    lines = [_sign({"t": "head", "seq": 0,
                    "journal_version": JOURNAL_VERSION, **head})]
    lines.extend(_sign(f) for f in frames)
    return ("\n".join(lines) + "\n").encode("utf-8")


@dataclass
class DecodedJournal:
    """A structurally verified journal: the head payload, the frame
    list (transport fields still attached) and how many leading frames
    the bounded ring dropped before the dump."""

    head: Dict[str, Any]
    frames: List[Dict[str, Any]]
    dropped: int


def decode_journal(data: bytes) -> DecodedJournal:
    """Verify + parse journal JSONL. Raises :class:`JournalError`:

    * ``truncated`` — empty input, missing trailing newline, or an
      unparseable LAST line (a torn write); also emits a
      ``journal_truncated`` event
    * ``version_skew`` — head ``journal_version`` != ours
    * ``checksum_mismatch`` — a line's crc32 does not match its body
    * ``schema`` — unparseable interior line / missing required fields
    * ``gap`` — non-contiguous ``seq`` after the first frame (a ring
      drop may only appear between head and first frame; it is
      reported as ``dropped``, not an error)
    """
    try:
        return _decode_inner(data)
    except JournalError as e:
        if e.code == "truncated":
            try:
                from .events import emit_event
                emit_event("journal_truncated", detail=e.detail,
                           nbytes=len(data))
            except Exception:
                pass
        raise


def _decode_inner(data: bytes) -> DecodedJournal:
    if not data:
        raise JournalError("truncated", "empty journal")
    text = data.decode("utf-8", errors="replace")
    if not text.endswith("\n"):
        raise JournalError("truncated",
                           "no trailing newline (torn final write)")
    lines = text.splitlines()
    frames: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        last = i == len(lines) - 1
        try:
            obj = json.loads(line)
        except Exception:
            if last:
                raise JournalError("truncated",
                                   f"line {i} unparseable (torn write)")
            raise JournalError("schema", f"line {i} is not JSON")
        if not isinstance(obj, dict) or "crc" not in obj:
            raise JournalError("schema", f"line {i} has no crc")
        crc = obj["crc"]
        body = {k: v for k, v in obj.items() if k != "crc"}
        canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
        if (zlib.crc32(canon.encode("utf-8")) & 0xFFFFFFFF) != crc:
            raise JournalError("checksum_mismatch",
                               f"line {i} crc mismatch")
        if "t" not in obj or "seq" not in obj:
            raise JournalError("schema", f"line {i} missing t/seq")
        frames.append(obj)
    head = frames[0]
    if head.get("t") != "head":
        raise JournalError("schema", "first frame is not a head frame")
    ver = head.get("journal_version")
    if ver != JOURNAL_VERSION:
        raise JournalError(
            "version_skew",
            f"journal_version={ver!r}, decoder speaks {JOURNAL_VERSION}")
    body_frames = frames[1:]
    dropped = 0
    if body_frames:
        first = int(body_frames[0]["seq"])
        if first < 1:
            raise JournalError("schema", f"first frame seq={first}")
        dropped = first - 1     # ring rotation before the dump
        prev = first
        for f in body_frames[1:]:
            s = int(f["seq"])
            if s != prev + 1:
                raise JournalError(
                    "gap", f"seq jumps {prev} -> {s} mid-journal")
            prev = s
    head_payload = {k: v for k, v in head.items()
                    if k not in ("t", "seq", "crc", "journal_version")}
    return DecodedJournal(head=head_payload, frames=body_frames,
                          dropped=dropped)


# -- divergence localization -------------------------------------------------

@dataclass
class Divergence:
    """The first point where a journaled run and its re-execution
    disagree — the replay report's one actionable line."""

    index: int                      # frame position (post-head)
    step: Optional[int]             # router step the frame belongs to
    replica: Optional[int]          # replica scope, when the frame has one
    component: str                  # frame type: outcome/health/fault/...
    journaled: Optional[Dict[str, Any]]
    observed: Optional[Dict[str, Any]]

    def as_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "step": self.step,
                "replica": self.replica, "component": self.component,
                "journaled": self.journaled, "observed": self.observed}


def _frame_scope(frame: Optional[Dict[str, Any]]):
    if frame is None:
        return None, None, "missing"
    return (frame.get("step"), frame.get("replica"),
            str(frame.get("t", "unknown")))


def first_divergence(journaled: List[Dict[str, Any]],
                     observed: List[Dict[str, Any]],
                     ) -> Optional[Divergence]:
    """Compare two frame sequences canonically (transport fields
    ignored) and return the FIRST mismatch, or None. ``observed`` being
    a strict extension of ``journaled`` is NOT a divergence: a bundle
    dumped mid-incident (e.g. at ejection) journals a prefix of the
    run, and replay completes the step that was in flight."""
    for i, jf in enumerate(journaled):
        of = observed[i] if i < len(observed) else None
        if of is None or canonical_frame(jf) != canonical_frame(of):
            step, replica, component = _frame_scope(jf)
            if of is not None and (replica is None
                                   or jf.get("t") != of.get("t")):
                # scope off the observed side when it names one and the
                # journaled frame doesn't (e.g. a dropped chaos frame
                # shifts the whole tail)
                if replica is None:
                    replica = of.get("replica")
            return Divergence(
                index=i, step=step, replica=replica, component=component,
                journaled=canonical_frame(jf),
                observed=None if of is None else canonical_frame(of))
    return None


# -- the recorder ------------------------------------------------------------

class JournalRecorder:
    """Bounded, lock-guarded frame ring. Hot paths gate on
    ``journal_armed[0]`` before calling any ``note_*``; the recorder
    itself never raises into a caller (frame payloads are plain JSON
    scalars/lists built by the call sites)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._frames: Deque[Dict[str, Any]] = deque(maxlen=self._capacity)
        self._head: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._dropped = 0
        self._step = 0
        self.frames_total = 0
        self._c_frames = None
        self._c_dropped = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return journal_armed[0]

    def arm(self, capacity: Optional[int] = None) -> "JournalRecorder":
        with self._lock:
            if capacity is not None and int(capacity) != self._capacity:
                self._capacity = int(capacity)
                self._frames = deque(self._frames, maxlen=self._capacity)
            journal_armed[0] = True
        return self

    def disarm(self) -> None:
        journal_armed[0] = False

    def clear(self) -> None:
        with self._lock:
            self._frames.clear()
            self._head = None
            self._seq = 0
            self._dropped = 0
            self._step = 0

    def _counters(self):
        if self._c_frames is None:
            from .registry import get_registry
            reg = get_registry()
            self._c_frames = reg.counter(
                "paddle_journal_frames_total",
                "black-box journal frames recorded, by frame type",
                labels=("type",))
            self._c_dropped = reg.counter(
                "paddle_journal_dropped_total",
                "journal frames evicted by the bounded ring before a "
                "dump — a replay of this window will refuse (rotated)")
        return self._c_frames, self._c_dropped

    # -- recording ----------------------------------------------------------

    def record_head(self, **payload) -> None:
        """Start a capture: the head frame (model geometry + fleet
        topology) resets the ring — one journal is ONE incident
        window."""
        with self._lock:
            self._frames.clear()
            self._seq = 0
            self._dropped = 0
            self._step = 0
            self._head = dict(payload)

    @property
    def head(self) -> Optional[Dict[str, Any]]:
        return self._head

    def note(self, type_: str, **payload) -> None:
        """Append one frame. ``step`` is stamped from the last
        :meth:`note_step`, so every frame is addressable as (step,
        replica, component)."""
        c_frames, c_dropped = self._counters()
        with self._lock:
            self._seq += 1
            frame = {"t": type_, "seq": self._seq, "step": self._step,
                     **payload}
            if len(self._frames) == self._capacity:
                self._dropped += 1
                c_dropped.inc()
            self._frames.append(frame)
            self.frames_total += 1
        c_frames.inc(type=type_)

    # typed conveniences — call sites stay one line and payload shapes
    # stay uniform across the tree

    def note_step(self, step: int, clock: float) -> None:
        with self._lock:
            self._step = int(step)
        self.note("step", clock=float(clock))

    def note_arrival(self, rid: int, clock: float, prompt: List[int],
                     prompt_crc: int, priority: int,
                     deadline_ms: Optional[float], budget: int,
                     sampler: Optional[Dict[str, Any]] = None,
                     grammar: Optional[Dict[str, Any]] = None) -> None:
        self.note("arrival", rid=int(rid), clock=float(clock),
                  prompt=prompt, prompt_crc=int(prompt_crc),
                  priority=int(priority),
                  deadline_ms=(None if deadline_ms is None
                               else float(deadline_ms)),
                  budget=int(budget), sampler=sampler, grammar=grammar)

    def note_fault(self, record: Dict[str, Any]) -> None:
        # nested under "fault": the record's own "step" is the fault's
        # SCHEDULED step, distinct from the frame's journal step stamp
        self.note("fault", fault=dict(record))

    def note_health(self, replica: int, prev: Optional[str],
                    state: str) -> None:
        self.note("health", replica=int(replica), prev=prev,
                  state=str(state))

    def note_scale(self, seq: int, action: str, reason: str,
                   replica: Optional[int], role: Optional[str]) -> None:
        self.note("scale", scale_seq=int(seq), action=str(action),
                  reason=str(reason), replica=replica, role=role)

    def note_wire(self, kind: str, crc: int, nbytes: int) -> None:
        self.note("wire", kind=str(kind), wire_crc=int(crc),
                  nbytes=int(nbytes))

    def note_handoff(self, rid: int, src: int, dst: int, pages: int,
                     outcome: str) -> None:
        self.note("handoff", rid=int(rid), src=int(src), dst=int(dst),
                  pages=int(pages), outcome=str(outcome))

    def note_admit(self, srid: int, engine_rid: int, ns: str) -> None:
        self.note("admit", srid=int(srid), engine_rid=int(engine_rid),
                  ns=str(ns))

    def note_outcome(self, rid: int, state: str, outcome: str,
                     replica: Optional[int], failovers: int,
                     tokens: List[int], stream_crc: int,
                     engine_crc: Optional[int]) -> None:
        self.note("outcome", rid=int(rid), state=str(state),
                  outcome=str(outcome), replica=replica,
                  failovers=int(failovers), tokens=tokens,
                  stream_crc=int(stream_crc), engine_crc=engine_crc)

    # -- reading ------------------------------------------------------------

    def frames(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._frames)

    def tail(self, n: int = 64) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._frames)[-int(n):]

    @property
    def dropped(self) -> int:
        return self._dropped

    def snapshot_status(self) -> Dict[str, Any]:
        with self._lock:
            return {"armed": journal_armed[0],
                    "journal_version": JOURNAL_VERSION,
                    "capacity": self._capacity,
                    "frames": len(self._frames),
                    "frames_total": self.frames_total,
                    "dropped": self._dropped,
                    "step": self._step,
                    "head": self._head is not None}

    def encode(self) -> bytes:
        """The journal as versioned, crc-per-line JSONL — the
        ``journal.jsonl`` member of every flight bundle."""
        with self._lock:
            head = dict(self._head or {})
            frames = list(self._frames)
        return encode_frames(head, frames)


#: the process-global journal every tap writes into
journal = JournalRecorder()


# -- head-frame helpers ------------------------------------------------------

def model_spec(cfg, params_seed: int,
               vocab: Optional[List[str]] = None) -> Dict[str, Any]:
    """Serialize a model config dataclass for the head frame. ``dtype``
    is stored by numpy name (this module stays JAX-free); replay
    resolves it back. ``vocab`` is required only when grammar-
    constrained arrivals must be re-compiled at replay."""
    import dataclasses
    d = dataclasses.asdict(cfg)
    if "dtype" in d:
        try:
            d["dtype"] = np.dtype(d["dtype"]).name
        except Exception:
            d["dtype"] = str(d["dtype"])
    return {"arch": type(cfg).__name__, "config": d,
            "params_seed": int(params_seed), "vocab": vocab}
