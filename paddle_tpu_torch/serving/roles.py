"""Disaggregated prefill/decode fleet: replica roles + KV page handoff —
counterpart of ``paddle_tpu/serving/roles.py``.

A hybrid replica interleaves prompt prefill chunks with decode steps on
the same slots, so a prompt-heavy burst inflates every in-flight
stream's inter-token latency — the admission work and the decode work
fight for the same step budget. The paper's remedy (and the reason the
page-table KV layout exists) is to
split the fleet by phase: **PREFILL** replicas take fresh prompts and
run prompt-heavy admission; once a request has produced its first
token, its finished KV pages are *handed off* to a **DECODE** replica,
which never admits fresh prompts and therefore decodes at a steady
cadence. **HYBRID** replicas do both (the pre-roles behaviour — a fleet
of hybrids is exactly a plain :class:`~.router.FleetRouter`).

The handoff rides the refcounted page export/import path of cross-host
migration, wire-framed even in-process so every transfer is CRC-checked
end to end:

1. export every *settled* full page at the source
   (``mgr.sequence_pages`` / ``mgr.export_page`` — stops one token
   short of the committed length, exactly like
   ``HostServer._cmd_export_flight``);
2. round-trip through :func:`~.wire.encode_pages` /
   :func:`~.wire.decode_message` (versioned frame, CRC verified before
   content, dtype checked against the destination pool);
3. adopt into the destination's prefix cache
   (``PrefixCache.import_prefix`` — all-or-nothing, rolls back on
   failure) and **audit**: ``check_conservation()`` on both pools and a
   memory-ledger re-balance after every import;
4. re-dispatch the continuation to the destination — the router's
   standard failover continuation already carries the trace id, the
   sampler seed pinned at router submit, and the streamed tokens as
   ``grammar_prefix``, so the resumed stream is **byte-identical** to a
   hybrid-replica run (greedy, sampled-seeded and grammar-constrained
   alike); the destination prefills only the un-exported tail (at most
   one page plus the unsettled token), and the continuation's
   ``decoded`` count flags the streamed tokens of that tail, so they
   take the attention route they were decoded on at the source (the
   tokens inside the imported pages are cache hits, never prefilled);
5. cancel at the source, freeing its copy of the pages.

A handoff that fails at ANY point is not an outage: export/import are
non-destructive (the destination rolls back, conservation re-checked),
so the request simply keeps decoding where it is — a hybrid-style
completion, still byte-identical.

Role flips are the autoscaler's actuation surface (:mod:`.autoscale`):
``set_role`` retags a replica and emits a ``role_changed`` event; the
controller wraps it in drain → retag → undrain so a flip never races
live admissions.

Telemetry: ``paddle_router_replica_role{replica}`` (0 hybrid /
1 prefill / 2 decode), ``paddle_handoff_requests_total{outcome}``,
``paddle_handoff_pages_total`` / ``paddle_handoff_bytes_total`` /
``paddle_handoff_seconds``, one ``kv_handoff`` event and a
``router.kv_handoff`` span per transfer. :attr:`DisaggRouter.handoff_phases`
keeps the newest successful transfers' wall seconds split into export
(device -> host), wire (frame, CRC, decode) and import (host -> pool,
conservation audits) on the host's ``perf_counter``.

On the card the destination prefills the un-exported tail that the
source would have decoded; at bf16 that tail's attention tiles and GEMM
row counts round differently, so the byte identity below holds for fp32
and is measured for bf16.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

from ..core.host_arrays import dtype_name
from ..observability.events import emit_event
from ..observability.journal import journal, journal_armed
from ..observability.memory import memory_armed, memory_ledger
from ..observability.registry import get_registry
from ..profiler.record import emit_span, spans_armed
from .health import ReplicaState
from .replica import ReplicaHandle
from .router import FleetRouter, RouterRequest
from .stream import ServingError
from .wire import WireError, decode_message, decode_pages, encode_pages


class ReplicaRole:
    """Replica phase assignment (string constants, like RequestState)."""

    PREFILL = "prefill"
    DECODE = "decode"
    HYBRID = "hybrid"


#: gauge encoding for ``paddle_router_replica_role``
ROLE_CODE = {ReplicaRole.HYBRID: 0, ReplicaRole.PREFILL: 1,
             ReplicaRole.DECODE: 2}

_ROLES = frozenset(ROLE_CODE)


class DisaggRouter(FleetRouter):
    """A :class:`FleetRouter` whose replicas carry roles. See module
    docstring. ``roles`` maps replica id -> role (unlisted replicas are
    HYBRID); ``handoff_min_streamed`` is how many tokens a request must
    have streamed on a PREFILL replica before its pages hand off (1 =
    hand off at prompt completion, the first decoded token proving the
    prefill settled)."""

    def __init__(self, replicas: Sequence[ReplicaHandle],
                 roles: Optional[Dict[int, str]] = None,
                 handoff_min_streamed: int = 1, **kw):
        super().__init__(replicas, **kw)
        self.roles: Dict[int, str] = {rid: ReplicaRole.HYBRID
                                      for rid in self.replicas}
        for rid, role in (roles or {}).items():
            if rid not in self.replicas:
                raise KeyError(f"no replica {rid} in the fleet")
            if role not in _ROLES:
                raise ValueError(f"unknown role {role!r}")
            self.roles[rid] = role
        self._handoff_min = max(1, int(handoff_min_streamed))
        self._handed: Set[int] = set()      # router rids already handed off
        # local mirrors (tests stay independent of registry resets)
        self.handoffs_ok = 0
        self.handoffs_failed = 0
        self.handoff_pages_total = 0
        self.handoff_phases: Deque[Dict[str, float]] = deque(maxlen=1024)
        reg = get_registry()
        self._g_role = reg.gauge(
            "paddle_router_replica_role",
            "replica role: 0 hybrid / 1 prefill / 2 decode",
            labels=("replica",))
        self._c_handoff_reqs = reg.counter(
            "paddle_handoff_requests_total",
            "prefill->decode KV handoffs by outcome",
            labels=("outcome",))
        self._c_handoff_pages = reg.counter(
            "paddle_handoff_pages_total",
            "KV pages handed from prefill to decode replicas")
        self._c_handoff_bytes = reg.counter(
            "paddle_handoff_bytes_total",
            "KV bytes handed from prefill to decode replicas")
        self._h_handoff_s = reg.histogram(
            "paddle_handoff_seconds",
            "per-request handoff latency (export -> import -> redispatch)")
        for rid in self.replicas:
            self._g_role.set(ROLE_CODE[self.roles[rid]], replica=str(rid))

    # -- roles ---------------------------------------------------------------

    def role(self, replica_id: int) -> str:
        return self.roles[replica_id]

    def set_role(self, replica_id: int, role: str,
                 reason: str = "operator") -> None:
        """Retag a replica. Emits ``role_changed``; callers that must
        not race live admissions (the autoscaler) wrap this in drain →
        retag → undrain."""
        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r}")
        old = self.roles[replica_id]
        if old == role:
            return
        self.roles[replica_id] = role
        self._g_role.set(ROLE_CODE[role], replica=str(replica_id))
        emit_event("role_changed", replica=replica_id, role=role,
                   previous=old, reason=reason)

    def add_replica(self, handle: ReplicaHandle,
                    role: str = ReplicaRole.HYBRID) -> None:
        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r}")
        super().add_replica(handle)
        self.roles[handle.replica_id] = role
        self._g_role.set(ROLE_CODE[role], replica=str(handle.replica_id))

    def remove_replica(self, replica_id: int) -> None:
        super().remove_replica(replica_id)
        self.roles.pop(replica_id, None)

    # -- role-aware routing --------------------------------------------------

    def _pick(self, prompt, exclude: Set[int]):
        """Fresh admissions (and failover continuations) avoid DECODE
        replicas — those receive work only via handoff. Two carve-outs
        keep the fleet live: a HALF_OPEN decode replica still takes its
        recovery probe (the breaker cannot close without one), and when
        NO prefill-capable replica is routable, availability beats role
        purity — traffic spills to the decode side rather than parking
        while healthy capacity idles."""
        blocked = {rid for rid, role in self.roles.items()
                   if role == ReplicaRole.DECODE
                   and rid in self.replicas
                   and self.replicas[rid].health.state
                   != ReplicaState.HALF_OPEN}
        rid, affinity, probe = super()._pick(prompt,
                                             set(exclude) | blocked)
        if rid is None and blocked:
            return super()._pick(prompt, exclude)
        return rid, affinity, probe

    # -- the handoff ---------------------------------------------------------

    def _step_inner(self, params) -> None:
        super()._step_inner(params)
        self._handoff_scan()

    def _pick_decode(self, exclude: Set[int]) -> Optional[int]:
        """Least-loaded accepting DECODE replica (HYBRID as fallback);
        None when nothing can take the pages."""
        for want in ((ReplicaRole.DECODE,), (ReplicaRole.HYBRID,)):
            cands = [rid for rid in sorted(self.replicas)
                     if rid not in exclude
                     and self.roles.get(rid) in want
                     and not self.replicas[rid].draining
                     and not self.replicas[rid].degraded
                     and self.replicas[rid].health.accepting]
            if cands:
                return min(cands,
                           key=lambda c: (self._load(self.replicas[c]), c))
        return None

    def _handoff_scan(self) -> None:
        for req in list(self._requests.values()):
            if req.done or req.rid in self._handed:
                continue
            src = req.replica_id
            if (src is None or req.handle is None
                    or self.roles.get(src) != ReplicaRole.PREFILL):
                continue
            if req.handle.done:
                continue            # terminal at the replica: scan closes it
            toks = req.stream.tokens
            if len(toks) < self._handoff_min:
                continue            # prompt not proven settled yet
            eos = self.replicas[src].engine.config.eos_token_id
            if len(toks) >= req.budget or (eos is not None and toks
                                           and toks[-1] == eos):
                continue            # finishing at src; nothing left to move
            dst = self._pick_decode(exclude={src})
            if dst is None:
                continue            # no decode capacity: finish hybrid-style
            self._handoff(req, src, dst)

    def _handoff(self, req: RouterRequest, src: int, dst: int) -> bool:
        """Move one request's settled KV pages src -> dst and re-bind
        its stream there (module docstring, steps 1-5). Never raises:
        a failed handoff leaves the request decoding at src."""
        r, d = self.replicas[src], self.replicas[dst]
        t0 = self._clock()
        w0 = time.perf_counter()
        trace = spans_armed()
        ns0 = time.perf_counter_ns() if trace else 0
        self._handed.add(req.rid)
        cancelled = False
        try:
            tokens = [int(t) for t in req.prompt] + \
                [int(t) for t in req.stream.tokens]
            mgr = r.engine.mgr
            ks: Any = ()
            vs: Any = ()
            erid = req.handle.engine_rid
            if erid is not None:
                # settled full pages only: the newest token's KV is the
                # next step's input and may not be written yet
                table = mgr.sequence_pages(erid)
                settled = min(len(tokens), mgr.sequence_len(erid))
                n_full = min(max(settled - 1, 0) // mgr.page_size,
                             len(table))
                if n_full > 0:
                    ks, vs = zip(*(mgr.export_page(p)
                                   for p in table[:n_full]))
            w1 = time.perf_counter()
            # wire round-trip even in-process: the CRC + schema check is
            # the same trust boundary the cross-host path crosses
            buf = encode_pages(
                "kv_handoff",
                {"tokens": tokens,
                 "kv_dtype": dtype_name(mgr.k_pages.dtype)},
                list(ks), list(vs))
            _kind, meta, arrays = decode_message(buf)
            ks2, vs2 = decode_pages(meta, arrays)
            w2 = time.perf_counter()
            nbytes = int(sum(a.nbytes for a in ks2)
                         + sum(a.nbytes for a in vs2))
            if ks2:
                dst_dtype = dtype_name(d.engine.mgr.k_pages.dtype)
                if meta["kv_dtype"] != dst_dtype:
                    raise WireError(
                        "schema",
                        f"kv dtype {meta['kv_dtype']} does not match "
                        f"replica {dst}'s {d.engine.mgr.k_pages.dtype}")
                if d.engine.cache is None:
                    raise ServingError(
                        "no_prefix_cache",
                        f"replica {dst} has no prefix cache to import "
                        "into", rid=req.rid)
                imported = d.engine.cache.import_prefix(
                    meta["tokens"], ks2, vs2)
            else:
                imported = {"imported_pages": 0, "skipped_pages": 0,
                            "imported_bytes": 0, "evicted_pages": 0}
            # the page-exact audit: byte conservation after EVERY import
            d.engine.mgr.check_conservation()
            if memory_armed[0]:
                memory_ledger.observe(d.engine.mgr)
            w3 = time.perf_counter()
            # pages now live at dst: teach the affinity index, free the
            # src copy, land the continuation where the KV is
            self._index_insert(dst, tokens)
            try:
                r.cancel(req.handle.rid)
            except Exception:
                pass
            cancelled = True
            r.engine.mgr.check_conservation()
            self._dispatch(req, dst, None)
            dt = self._clock() - t0
            if trace:
                emit_span("router.kv_handoff", ns0,
                          time.perf_counter_ns(), trace_id=req.trace_id,
                          args={"request_id": req.rid, "src": src,
                                "dst": dst, "pages": len(ks2),
                                "bytes": nbytes})
            self.handoffs_ok += 1
            self.handoff_pages_total += len(ks2)
            self.handoff_phases.append(
                {"export_s": w1 - w0, "wire_s": w2 - w1,
                 "import_s": w3 - w2, "pages": len(ks2), "bytes": nbytes})
            self._c_handoff_reqs.inc(outcome="ok")
            self._c_handoff_pages.inc(len(ks2))
            self._c_handoff_bytes.inc(nbytes)
            self._h_handoff_s.observe(dt)
            emit_event("kv_handoff", request_id=req.rid,
                       trace_id=req.trace_id, src=src, dst=dst,
                       pages=len(ks2), bytes=nbytes,
                       imported_pages=imported["imported_pages"],
                       skipped_pages=imported["skipped_pages"],
                       seconds=round(dt, 6), outcome="ok")
            if journal_armed[0]:
                # like scale frames: a disaggregated handoff moved KV
                # between replicas, which single-fleet replay cannot
                # re-drive — the frame marks the bundle replay-refused
                journal.note_handoff(rid=req.rid, src=src, dst=dst,
                                     pages=len(ks2), outcome="ok")
            return True
        except Exception as e:  # noqa: BLE001 - per-request fallback
            dt = self._clock() - t0
            self.handoffs_failed += 1
            self._c_handoff_reqs.inc(outcome="failed")
            self._h_handoff_s.observe(dt)
            emit_event("kv_handoff", request_id=req.rid,
                       trace_id=req.trace_id, src=src, dst=dst,
                       pages=0, bytes=0, seconds=round(dt, 6),
                       outcome="failed", error=repr(e))
            if journal_armed[0]:
                journal.note_handoff(rid=req.rid, src=src, dst=dst,
                                     pages=0, outcome="failed")
            if cancelled:
                # src already gave the request up: the standard failover
                # continuation recomputes the prefix somewhere routable
                try:
                    self._route(req)
                except ServingError:
                    pass        # parked; the step loop keeps retrying
            return False

    # -- observability -------------------------------------------------------

    def statusz(self) -> Dict[str, Any]:
        out = super().statusz()
        out["roles"] = {str(rid): self.roles[rid]
                        for rid in sorted(self.roles)}
        out["handoffs"] = {"ok": self.handoffs_ok,
                           "failed": self.handoffs_failed,
                           "pages": self.handoff_pages_total}
        return out
