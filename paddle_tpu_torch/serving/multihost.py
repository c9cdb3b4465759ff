"""Multi-host serving — counterpart of ``paddle_tpu/serving/multihost.py``:
engine *processes* behind one router, with page migration between them,
heartbeat health and cross-host failover.

The fleet tier (:mod:`.router`) fronts N in-process engine replicas; a
real deployment fronts N engine **hosts** — separate processes (in prod,
separate machines) that can die without taking the router with them, and
whose KV pages can *move*: a graceful drain migrates each live request's
pages to a sibling so the continuation prefills only the tail instead of
recomputing the whole prefix. This module is that tier:

* :class:`HostServer` — runs *inside* the engine process: one
  ``ContinuousBatchingEngine`` (+ prefix cache) under a
  ``ServingScheduler``, answering wire-framed commands (:mod:`.wire`):
  ``hello`` / ``submit`` / ``step`` / ``cancel`` / ``export_flight`` /
  ``import_prefix`` / ``statusz`` / ``telemetry`` / ``shutdown``.
* :class:`PipeTransport` — a real child process (``multiprocessing``
  spawn + pipe; a forked child could not use CUDA); :class:`LocalTransport`
  — the same server in-process, still round-tripping every frame through
  the encoder so wire coverage is identical while tests stay
  single-process and fake-clocked.
* :class:`HostEndpoint` — the client half: per-call timeout, bounded
  retry with exponential backoff, stale-reply discard (message ids),
  injectable link latency, and a liveness probe
  (:meth:`HostEndpoint.alive`) that consumer ``TokenStream``\\ s poll so
  a blocked reader of a dead host terminates with a structured
  ``ServingError("producer_dead")`` instead of hanging.
* :class:`HostHandle` — duck-types :class:`~.replica.ReplicaHandle` so
  :class:`HostFleetRouter` IS a :class:`~.router.FleetRouter`: the
  ``step`` RPC doubles as the heartbeat (a missed beat is a recorded
  failure; consecutive misses walk the ``HealthTracker`` HEALTHY →
  SUSPECT → EJECTED exactly like in-process replicas), and per-request
  mirrors replay the child's token stream into the router's.
* :class:`HostFleetRouter` — adds :meth:`migrate_host` (graceful drain
  WITH pages: export at src → checksummed wire frame → import into the
  dst prefix cache → continuation dispatched to dst, so only the
  un-filled tail prefills), host-scoped chaos (``host_die`` kills the
  real process; ``host_stall`` / ``link_slow`` degrade the transport),
  ``host_lost`` forensics and the migration observability surface:
  ``paddle_migration_{bytes,pages,requests}_total``,
  ``paddle_migration_seconds``, ``paddle_host_state`` and
  ``page_migration`` events, with per-transfer byte accounting fed to
  the memory ledger (``note_migration``).

The frames are the reference's, byte for byte: the KV dtype travels by
its numpy name (``core.host_arrays.dtype_name``, so a bf16 pool reads
``bfloat16`` from either stack), and a continuation's ``decoded`` count
rides the ``submit`` frame only when it is nonzero. That count is the
port's extra (keyword-only): the engine prefills those streamed tokens
on the attention route they were decoded on, so a bf16 stream moved to
another host continues bit for bit.

Failure atomicity: an import that dies partway rolls back inside
``PrefixCache.import_prefix`` (staged pages returned to the free list,
``check_conservation`` re-run), the wire CRC rejects truncated or
corrupted transfers *before* any bytes touch a pool, and a failed
migration falls back to the plain failover path — the continuation
recomputes its prefix, correct just slower. Host loss without a prior
drain replays only the un-migrated pages: whatever earlier migrations
already planted in a sibling's prefix cache is hit, not recomputed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.host_arrays import dtype_name
from ..observability.events import emit_event
from ..observability.federation import (FederationHub, collect_telemetry,
                                        federation_armed)
from ..observability.flight import flight_recorder
from ..observability.memory import memory_armed, memory_ledger
from ..observability.registry import get_registry
from ..observability.timeline import timeline_armed
from ..profiler.record import emit_span, spans_armed
from .health import HealthConfig, HealthTracker
from .metrics import ServingMetrics
from .router import FleetRouter, RouterConfig
from .scheduler import RequestState, SchedulerConfig, ServingScheduler
from .stream import ServingError, TokenStream
from .wire import (WireError, decode_message, decode_pages, encode_message,
                   grammar_from_wire, grammar_to_wire, telemetry_from_wire,
                   telemetry_to_wire)


class HostFault(RuntimeError):
    """Transport-level failure talking to an engine host: timeout, dead
    process, broken pipe, stalled link. The router treats it like any
    replica step failure (breaker food), never as a caller error."""


# ---------------------------------------------------------------------------
# child side: the engine process
# ---------------------------------------------------------------------------

def llama_tiny_host(seed: int = 3, max_new_tokens: int = 8,
                    num_slots: int = 2, page_size: int = 4,
                    max_seq_len: int = 48, chunk: int = 2,
                    num_hidden_layers: int = 2,
                    eos_token_id: Optional[int] = None,
                    grammar_states: int = 0, *, device=None,
                    num_attention_heads: Optional[int] = None):
    """Default host factory (``module:function`` target for
    :class:`PipeTransport`): a seeded tiny-llama engine WITH a prefix
    cache — page import lands there, so migrated continuations prefill
    only their tail. Returns ``(engine, params)``; every host built from
    the same kwargs is bit-identical, which is what makes cross-host
    continuation byte-exact. The weights are the port's own seeded draw
    (``models.llama.init_params``), not the JAX package's. ``device=None``
    means the card (raises without one); pass ``device="cpu"`` through
    ``factory_kwargs`` to run a host on the CPU. ``num_attention_heads``
    (and as many KV heads) splits the 64-wide model other than the
    reference's 4 heads of 16: the card's attention kernels take a head
    dim of 64 or 128, so a host on the card passes 1."""
    from ..inference.decoding import (ContinuousBatchingEngine,
                                      GenerationConfig)
    from ..models import llama as L
    heads = {} if num_attention_heads is None else dict(
        num_attention_heads=num_attention_heads,
        num_key_value_heads=num_attention_heads)
    cfg = L.llama_tiny(num_hidden_layers=num_hidden_layers, **heads)
    params = L.init_params(cfg, seed, device=device)
    engine = ContinuousBatchingEngine(
        cfg, GenerationConfig(max_new_tokens=max_new_tokens, seed=seed,
                              eos_token_id=eos_token_id),
        num_slots=num_slots, page_size=page_size, max_seq_len=max_seq_len,
        chunk=chunk, prefix_cache=True, grammar_states=grammar_states,
        device=device)
    return engine, params


class HostServer:
    """Wire-command handler around one engine + scheduler — the whole
    child-process brain. Parent request ids (``rid`` in every command)
    are the identity; retried ``submit`` frames dedup on them, and
    terminal request states keep being re-reported every ``step`` until
    the parent acks them, so a lost reply can never strand a mirror."""

    def __init__(self, engine, params, host_id: int = 0,
                 scheduler_config: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.params = params
        self.host_id = int(host_id)
        self._scheduler = ServingScheduler(
            engine, scheduler_config,
            metrics=ServingMetrics(namespace=f"paddle_host_h{host_id}"))
        self._reqs: Dict[int, Any] = {}     # parent rid -> ServingRequest
        self._sent: Dict[int, int] = {}     # parent rid -> tokens reported
        self._span_marks: Dict[str, int] = {}   # telemetry watermarks
        self._telemetry_seq = 0
        self.shutdown_requested = False

    # -- framing ------------------------------------------------------------

    def handle_bytes(self, buf: bytes) -> bytes:
        """Decode one command frame, run it, encode the reply. Every
        failure mode becomes a structured reply — the child never lets
        an exception escape to kill the serving loop."""
        mid = -1
        try:
            kind, meta, arrays = decode_message(buf)
            mid = meta.get("__mid", -1)
            fn = getattr(self, f"_cmd_{kind}", None)
            if fn is None:
                raise WireError("schema", f"unknown command {kind!r}")
            out_meta, out_arrays = fn(meta, arrays)
            out_meta["__mid"] = mid
            out_meta["ok"] = True
            return encode_message("reply", out_meta, out_arrays)
        except WireError as e:
            err = {"type": "WireError", "code": e.code, "msg": e.detail}
        except ServingError as e:
            err = {"type": "ServingError", "code": e.code, "msg": str(e)}
        except (ValueError, KeyError, MemoryError) as e:
            err = {"type": type(e).__name__, "msg": str(e)}
        except Exception as e:    # noqa: BLE001 - reply, don't die
            err = {"type": type(e).__name__, "msg": repr(e)}
        return encode_message("reply",
                              {"__mid": mid, "ok": False, "error": err}, {})

    # -- commands -----------------------------------------------------------

    def _cmd_hello(self, meta, arrays) -> Tuple[dict, dict]:
        eng, mgr = self.engine, self.engine.mgr
        return ({"host_id": self.host_id,
                 "page_size": int(mgr.page_size),
                 "usable_pages": int(mgr.usable_pages),
                 "page_nbytes": int(mgr.page_nbytes),
                 "max_seq_len": int(eng.max_seq_len),
                 "eos_token_id": eng.config.eos_token_id,
                 "default_max_new_tokens": int(eng.config.max_new_tokens),
                 "kv_dtype": dtype_name(mgr.k_pages.dtype),
                 "prefix_cache": eng.cache is not None}, {})

    def _cmd_submit(self, meta, arrays) -> Tuple[dict, dict]:
        rid = int(meta["rid"])
        if rid in self._reqs:           # retried frame: first one won
            return ({"rid": rid}, {})
        sampler = None
        if meta.get("sampler") is not None:
            from ..inference.sampling import SamplerConfig
            sampler = SamplerConfig(**meta["sampler"])
        grammar = None
        if meta.get("grammar") is not None:
            grammar = grammar_from_wire(meta["grammar"], arrays)
        req = self._scheduler.submit(
            np.asarray(meta["prompt"], np.int32),
            priority=int(meta.get("priority", 0)),
            deadline_ms=meta.get("deadline_ms"),
            max_new_tokens=meta.get("max_new_tokens"),
            defer_s=meta.get("defer_s"),
            no_shed=bool(meta.get("no_shed", False)),
            trace_id=meta.get("trace_id"),
            sampler=sampler, grammar=grammar,
            grammar_prefix=meta.get("grammar_prefix"),
            decoded=int(meta.get("decoded", 0)))
        self._reqs[rid] = req
        self._sent[rid] = 0
        return ({"rid": rid}, {})

    def _cmd_cancel(self, meta, arrays) -> Tuple[dict, dict]:
        req = self._reqs.pop(int(meta["rid"]), None)
        self._sent.pop(int(meta["rid"]), None)
        ok = False if req is None else self._scheduler.cancel(req.rid)
        return ({"cancelled": bool(ok)}, {})

    def _cmd_step(self, meta, arrays) -> Tuple[dict, dict]:
        for rid in meta.get("ack", ()):
            self._reqs.pop(int(rid), None)
            self._sent.pop(int(rid), None)
        sch = self._scheduler
        sch.step(self.params)
        updates: Dict[str, dict] = {}
        for rid, req in self._reqs.items():
            toks = req.stream.tokens
            new = toks[self._sent[rid]:]
            self._sent[rid] = len(toks)
            u: Dict[str, Any] = {"state": req.state}
            if new:
                u["new"] = [int(t) for t in new]
            if req.done:
                u["finish_reason"] = req.stream.finish_reason
                if req.stream.error is not None:
                    u["error"] = {"code": req.stream.error.code,
                                  "msg": str(req.stream.error)}
            updates[str(rid)] = u
        return ({"updates": updates,
                 "pending": sch.pending, "active": sch.active,
                 "inflight": sch.inflight,
                 "queue_depth": sch.queue_depth,
                 "degraded": sch.degraded}, {})

    def _cmd_export_flight(self, meta, arrays) -> Tuple[dict, dict]:
        """Snapshot one live request for migration: its full token
        stream (child-authoritative — the parent mirror may trail by a
        chunk) plus the KV pages of every *settled* full block. The last
        token's KV may not be written yet (it is the next step's input),
        so the export stops one token short of the committed length —
        the importer's continuation prefills the remainder."""
        rid = int(meta["rid"])
        req = self._reqs.get(rid)
        if req is None:
            raise KeyError(f"no live request {rid} on host {self.host_id}")
        mgr = self.engine.mgr
        tokens = [int(t) for t in req.prompt] + \
            [int(t) for t in req.stream.tokens]
        out: Dict[str, Any] = {"tokens": tokens, "state": req.state,
                               "n_pages": 0,
                               "kv_dtype": dtype_name(mgr.k_pages.dtype)}
        out_arrays: Dict[str, np.ndarray] = {}
        if req.engine_rid is not None:
            table = mgr.sequence_pages(req.engine_rid)
            settled = min(len(tokens), mgr.sequence_len(req.engine_rid))
            n_full = min(max(settled - 1, 0) // mgr.page_size, len(table))
            if n_full > 0:
                ks, vs = zip(*(mgr.export_page(p)
                               for p in table[:n_full]))
                out["n_pages"] = n_full
                out_arrays = {"k_slabs": np.stack(ks),
                              "v_slabs": np.stack(vs)}
        return (out, out_arrays)

    def _cmd_import_prefix(self, meta, arrays) -> Tuple[dict, dict]:
        """Land migrated pages in the prefix cache, then audit: pool
        conservation runs inside ``import_prefix`` (and on its rollback
        path), and the memory ledger re-balances the byte books while
        armed — a partial transfer can only ever leave this host exactly
        as it was."""
        if self.engine.cache is None:
            raise ServingError(
                "no_prefix_cache",
                f"host {self.host_id} has no prefix cache to import into")
        if meta.get("kv_dtype") and \
                meta["kv_dtype"] != dtype_name(self.engine.mgr.k_pages.dtype):
            raise WireError(
                "schema", f"kv dtype {meta['kv_dtype']} does not match "
                f"this pool's {self.engine.mgr.k_pages.dtype}")
        ks, vs = decode_pages(meta, arrays)
        res = self.engine.cache.import_prefix(meta["tokens"], ks, vs)
        if memory_armed[0]:
            memory_ledger.observe(self.engine.mgr)
        return (dict(res), {})

    def _cmd_statusz(self, meta, arrays) -> Tuple[dict, dict]:
        out = self._scheduler.statusz()
        out["host_id"] = self.host_id
        return ({"statusz": out}, {})

    def _cmd_telemetry(self, meta, arrays) -> Tuple[dict, dict]:
        """One federation beat: build a versioned telemetry frame —
        registry exposition, serving gauges, new completed spans since
        the previous frame (``_span_marks`` watermarks), event tail,
        memory class bytes. ``meta["arm"]`` arms the host-side span
        collector on first contact, so a child process starts recording
        the moment the parent federation wants spans."""
        if meta.get("arm") and not timeline_armed[0]:
            timeline_armed[0] = True
        seq = self._telemetry_seq
        self._telemetry_seq += 1
        frame = collect_telemetry(
            self.host_id, self._span_marks, seq,
            gauges=self._scheduler.metrics.gauges)
        return telemetry_to_wire(frame)

    def _cmd_shutdown(self, meta, arrays) -> Tuple[dict, dict]:
        self.shutdown_requested = True
        return ({}, {})


def _host_child_main(conn, factory: str, factory_kwargs: dict,
                     host_id: int) -> None:
    """Child-process entry (module-level: spawn pickles the reference).
    ``factory`` is a ``"module:function"`` spec returning ``(engine,
    params)`` — hosts rebuild their engine from seeds, nothing traced
    crosses the process boundary."""
    import importlib
    mod_name, fn_name = factory.split(":")
    build = getattr(importlib.import_module(mod_name), fn_name)
    engine, params = build(**(factory_kwargs or {}))
    server = HostServer(engine, params, host_id=host_id)
    while True:
        try:
            buf = conn.recv_bytes()
        except (EOFError, OSError):
            break
        reply = server.handle_bytes(buf)
        try:
            conn.send_bytes(reply)
        except (BrokenPipeError, OSError):
            break
        if server.shutdown_requested:
            break
    conn.close()


# ---------------------------------------------------------------------------
# parent side: transports
# ---------------------------------------------------------------------------

class PipeTransport:
    """A real engine process on the other end of a duplex pipe. The
    pipe is the DCN stand-in: every frame that crosses it is a
    length-prefixed byte string, so the wire format is exercised exactly
    as it would be over a socket (transport framing is the pipe's;
    integrity is the frame's own CRC)."""

    def __init__(self, factory: str = "paddle_tpu_torch.serving.multihost:"
                                      "llama_tiny_host",
                 factory_kwargs: Optional[dict] = None, host_id: int = 0):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_host_child_main,
            args=(child_conn, factory, dict(factory_kwargs or {}),
                  int(host_id)),
            daemon=True)
        self._proc.start()
        child_conn.close()      # parent keeps one end only

    def send(self, buf: bytes) -> None:
        try:
            self._conn.send_bytes(buf)
        except (BrokenPipeError, OSError, EOFError) as e:
            raise HostFault(f"send failed: {e!r}")

    def recv(self, timeout_s: float) -> bytes:
        try:
            if not self._conn.poll(timeout_s):
                raise HostFault(f"no reply within {timeout_s}s")
            return self._conn.recv_bytes()
        except (EOFError, OSError) as e:
            raise HostFault(f"recv failed: {e!r}")

    def alive(self) -> bool:
        return self._proc.is_alive()

    def kill(self) -> None:
        self._proc.kill()

    def close(self) -> None:
        """Graceful teardown: best-effort shutdown command, then join,
        then kill — never leaves a zombie child behind a test run."""
        try:
            self.send(encode_message("shutdown", {"__mid": -1}, {}))
        except HostFault:
            pass
        self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=5)


class LocalTransport:
    """The same :class:`HostServer` in-process, every frame still
    round-tripping through encode/decode — identical wire coverage,
    deterministic fake-clock time, and a ``dead`` switch standing in
    for a killed process."""

    def __init__(self, server: HostServer):
        self.server = server
        self._replies: List[bytes] = []
        self.dead = False

    def send(self, buf: bytes) -> None:
        if self.dead:
            raise HostFault("host process is dead")
        self._replies.append(self.server.handle_bytes(buf))

    def recv(self, timeout_s: float) -> bytes:
        if self.dead:
            raise HostFault("host process is dead")
        if not self._replies:
            raise HostFault(f"no reply within {timeout_s}s")
        return self._replies.pop(0)

    def alive(self) -> bool:
        return not self.dead

    def kill(self) -> None:
        self.dead = True

    def close(self) -> None:
        self.dead = True


class HostEndpoint:
    """Client half of one host link: request/reply over a transport
    with per-call timeout, bounded exponential-backoff retry, message-id
    matching (a late reply to a timed-out attempt is discarded, never
    mis-delivered), injectable link latency (``link_slow`` chaos) and a
    parent-side stall window (``host_stall`` chaos — calls fail fast as
    if the host stopped answering). Non-idempotent commands stay safe
    under retry because the server dedups on parent request ids."""

    def __init__(self, transport, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 timeout_s: float = 120.0, retries: int = 2,
                 backoff_s: float = 0.05):
        self.transport = transport
        self._clock = clock
        self._sleep = sleep
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._mid = 0
        self._dead = False
        self._stall_until = 0.0
        self._slow_until = 0.0
        self._slow_delay = 0.0
        self.calls = 0
        self.retried = 0
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- chaos levers (parent-side mirrors of the replica surface) ----------

    def kill(self) -> None:
        self._dead = True
        try:
            self.transport.kill()
        except Exception:       # a dead transport cannot veto its death
            pass

    def stall(self, duration_s: float) -> None:
        self._stall_until = self._clock() + float(duration_s)

    def slow_link(self, duration_s: float, delay_s: float) -> None:
        self._slow_until = self._clock() + float(duration_s)
        self._slow_delay = float(delay_s)

    def alive(self) -> bool:
        """Producer-liveness probe for consumer token streams: False
        once the process is gone (a stalled or slow host is alive —
        slow is not dead)."""
        return not self._dead and self.transport.alive()

    # -- the one call path --------------------------------------------------

    def call(self, kind: str, meta: Optional[dict] = None,
             arrays: Optional[Dict[str, np.ndarray]] = None,
             timeout_s: Optional[float] = None,
             retries: Optional[int] = None
             ) -> Tuple[dict, Dict[str, np.ndarray]]:
        if self._dead:
            raise HostFault("host endpoint is dead")
        now = self._clock()
        if now < self._stall_until:
            raise HostFault("host is stalled (no heartbeat reply)")
        if now < self._slow_until:
            self._sleep(self._slow_delay)       # injected DCN latency
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        retries = self.retries if retries is None else int(retries)
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            if attempt:
                self.retried += 1
                self._sleep(self.backoff_s * (2 ** (attempt - 1)))
            mid = self._mid = self._mid + 1
            frame = encode_message(kind, dict(meta or {}, __mid=mid),
                                   arrays)
            try:
                self.calls += 1
                self.bytes_sent += len(frame)
                self.transport.send(frame)
                r_meta, r_arrays = self._recv_reply(mid, timeout_s)
            except (HostFault, WireError) as e:
                last = e
                continue
            err = r_meta.get("error")
            if err is not None:
                raise _raise_remote(err)
            return r_meta, r_arrays
        raise HostFault(f"{kind} failed after {retries + 1} attempts: "
                        f"{last!r}")

    def _recv_reply(self, mid: int, timeout_s: float
                    ) -> Tuple[dict, Dict[str, np.ndarray]]:
        deadline = self._clock() + timeout_s
        while True:
            remaining = max(deadline - self._clock(), 0.0)
            buf = self.transport.recv(remaining)
            self.bytes_received += len(buf)
            _kind, meta, arrays = decode_message(buf)
            if meta.get("__mid") == mid:
                return meta, arrays
            # stale reply from a timed-out earlier attempt: drop it
            if self._clock() >= deadline:
                raise HostFault(f"no matching reply within {timeout_s}s")

    def stats(self) -> Dict[str, Any]:
        return {"calls": self.calls, "retried": self.retried,
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received,
                "alive": self.alive()}

    def close(self) -> None:
        try:
            self.transport.close()
        except Exception:
            pass
        self._dead = True


def _raise_remote(err: dict) -> Exception:
    """Rehydrate a structured child-side error for the caller: the
    types the router's control flow dispatches on come back as
    themselves, everything else as :class:`HostFault`."""
    t = err.get("type")
    msg = err.get("msg", "")
    if t == "ServingError":
        return ServingError(err.get("code", "engine_failure"), msg)
    if t == "WireError":
        return WireError(err.get("code", "schema"), msg)
    if t == "ValueError":
        return ValueError(msg)
    if t == "MemoryError":
        return MemoryError(msg)
    if t == "KeyError":
        return KeyError(msg)
    return HostFault(f"{t}: {msg}")


# ---------------------------------------------------------------------------
# parent side: the ReplicaHandle-shaped host
# ---------------------------------------------------------------------------

class _FacadeMgr:
    """Enough of a page pool for the router's admission math."""

    def __init__(self, page_size: int, usable_pages: int):
        self.page_size = int(page_size)
        self.usable_pages = int(usable_pages)

    def pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size


class _FacadeConfig:
    def __init__(self, eos_token_id, max_new_tokens: int):
        self.eos_token_id = eos_token_id
        self.max_new_tokens = int(max_new_tokens)


class _EngineFacade:
    """Parent-side stand-in for ``handle.engine`` built from the
    ``hello`` reply — the router reads geometry and limits off it
    without ever holding the remote engine."""

    def __init__(self, hello: dict):
        self.page_size = int(hello["page_size"])
        self.max_seq_len = int(hello["max_seq_len"])
        self.mgr = _FacadeMgr(hello["page_size"], hello["usable_pages"])
        self.config = _FacadeConfig(hello["eos_token_id"],
                                    hello["default_max_new_tokens"])
        self.page_nbytes = int(hello["page_nbytes"])
        self.kv_dtype = hello.get("kv_dtype", "")
        self.has_prefix_cache = bool(hello.get("prefix_cache", False))


@dataclass
class RemoteRequest:
    """Parent-side mirror of one request living on a host: state and
    tokens arrive via ``step`` replies; the stream is the same
    ``TokenStream`` contract the router consumes on in-process
    replicas, with the endpoint's liveness probe attached so a consumer
    of a dead host's stream terminates instead of hanging."""

    rid: int
    prompt: np.ndarray
    stream: TokenStream = None
    state: str = RequestState.QUEUED
    _closed: bool = field(default=False, repr=False)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED,
                              RequestState.SHED, RequestState.FAILED)

    def _apply(self, update: dict) -> int:
        """Fold one step-reply entry into the mirror; returns the number
        of new tokens delivered."""
        new = update.get("new", ())
        for tok in new:
            self.stream.push(int(tok))
        self.state = update.get("state", self.state)
        if self.done and not self._closed:
            self._closed = True
            err = update.get("error")
            self.stream.close(
                update.get("finish_reason") or "complete",
                None if err is None else ServingError(
                    err.get("code", "engine_failure"),
                    err.get("msg", ""), rid=self.rid))
        return len(new)


class HostHandle:
    """One engine host, duck-typing :class:`~.replica.ReplicaHandle`
    (same surface, checked by the router tests): ``step`` is the
    heartbeat RPC — a transport failure raises and the router's
    ``HealthTracker`` walks SUSPECT → EJECTED on consecutive missed
    beats; ``kill``/``stall``/``slow`` map host chaos onto the process
    (a real ``SIGKILL`` under :class:`PipeTransport`) and the link."""

    def __init__(self, host_id: int, endpoint: HostEndpoint,
                 health_config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 step_timeout_s: float = 120.0):
        self.replica_id = int(host_id)
        self.endpoint = endpoint
        self._clock = clock
        self._sleep = sleep
        self.step_timeout_s = float(step_timeout_s)
        hello, _ = endpoint.call("hello", retries=1)
        self.engine = _EngineFacade(hello)
        self.health = HealthTracker(health_config, clock=clock)
        self.draining = False
        self.drained_event_sent = False
        self._mirrors: Dict[int, RemoteRequest] = {}
        self._next_rid = 0
        self._ack: List[int] = []
        self._tokens_total = 0
        self._completed_total = 0
        self._last: Dict[str, Any] = {"pending": 0, "active": 0,
                                      "inflight": 0, "queue_depth": 0,
                                      "degraded": False}
        #: set by HostFleetRouter — the parent-side telemetry sink this
        #: handle's heartbeat feeds while ``federation_armed``
        self.federation: Optional[FederationHub] = None
        self._statusz_cache: Dict[str, Any] = {}
        self._statusz_last_success: Optional[float] = None
        reg = get_registry()
        self._c_statusz_err = reg.counter(
            "paddle_host_statusz_errors_total",
            "statusz endpoint round-trips that failed "
            "(the host view is served from cache, marked stale)",
            labels=("host",))
        self._h_rtt = reg.histogram(
            "paddle_host_heartbeat_rtt_seconds",
            "telemetry-beat RPC round-trip time per host (the samples "
            "the clock-offset estimator consumes)",
            labels=("host",),
            bounds=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt, priority: int = 0,
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               defer_s: Optional[float] = None,
               no_shed: bool = False,
               trace_id: Optional[str] = None,
               sampler: Any = None,
               grammar: Any = None,
               grammar_prefix: Any = None, *,
               decoded: int = 0) -> RemoteRequest:
        rid = self._next_rid
        self._next_rid += 1
        prompt = np.asarray(prompt, np.int32)
        meta: Dict[str, Any] = {
            "rid": rid, "prompt": [int(t) for t in prompt],
            "priority": int(priority), "deadline_ms": deadline_ms,
            "max_new_tokens": max_new_tokens, "defer_s": defer_s,
            "no_shed": bool(no_shed), "trace_id": trace_id}
        arrays: Dict[str, np.ndarray] = {}
        if sampler is not None:
            meta["sampler"] = {"temperature": sampler.temperature,
                               "top_k": sampler.top_k,
                               "top_p": sampler.top_p,
                               "seed": sampler.seed}
        if grammar is not None:
            g_meta, g_arrays = grammar_to_wire(grammar)
            meta["grammar"] = g_meta
            arrays.update(g_arrays)
        if grammar_prefix:
            meta["grammar_prefix"] = [int(t) for t in grammar_prefix]
        if decoded:
            # only when nonzero: a fresh submit's frame stays the
            # reference's, byte for byte
            meta["decoded"] = int(decoded)
        try:
            self.endpoint.call("submit", meta, arrays)
        except HostFault as e:
            # the router's routing loop dispatches on ServingError:
            # "this host refused/failed" -> breaker food + next sibling
            raise ServingError("host_unreachable",
                               f"host {self.replica_id}: {e}", rid=rid)
        mirror = RemoteRequest(rid=rid, prompt=prompt,
                               stream=TokenStream(rid, on_token=on_token))
        mirror.stream.attach_producer(self.endpoint.alive)
        self._mirrors[rid] = mirror
        return mirror

    def cancel(self, rid: int) -> bool:
        mirror = self._mirrors.pop(rid, None)
        if mirror is not None and not mirror.done:
            mirror.state = RequestState.CANCELLED
            mirror._closed = True
            mirror.stream.close("cancelled", None)
        try:
            meta, _ = self.endpoint.call("cancel", {"rid": rid}, retries=0)
            return bool(meta.get("cancelled", False))
        except (HostFault, ServingError, WireError):
            return False        # a dead host cannot veto a cancel

    def step(self, params) -> int:
        """One heartbeat: step the remote scheduler and fold its reply
        into the mirrors. ``params`` is unused (the host owns its own) —
        kept for the ReplicaHandle signature. No retry: a missed beat
        must surface to the breaker, not be papered over."""
        ack, self._ack = self._ack, []
        try:
            meta, _ = self.endpoint.call(
                "step", {"ack": ack}, retries=0,
                timeout_s=self.step_timeout_s)
        except (HostFault, WireError):
            self._ack = ack + self._ack     # re-ack next beat
            raise
        for rid_s, update in meta.get("updates", {}).items():
            mirror = self._mirrors.get(int(rid_s))
            if mirror is None:
                self._ack.append(int(rid_s))    # cancelled under us
                continue
            was_done = mirror.done
            self._tokens_total += mirror._apply(update)
            if mirror.done and not was_done:
                self._ack.append(int(rid_s))
                if mirror.state == RequestState.DONE:
                    self._completed_total += 1
        for k in ("pending", "active", "inflight", "queue_depth",
                  "degraded"):
            self._last[k] = meta.get(k, self._last[k])
        if federation_armed[0] and self.federation is not None:
            self._telemetry_beat()
        return int(meta.get("pending", 0))

    def _telemetry_beat(self) -> None:
        """Pull one telemetry frame after a successful heartbeat. The
        round-trip is stamped with ``perf_counter_ns`` on both ends —
        the same samples feed the RTT histogram AND the hub's clock
        estimator. A failed beat marks the mirror stale; it is never
        breaker food (the heartbeat proper owns health)."""
        hub = self.federation
        t0 = time.perf_counter_ns()
        try:
            meta, arrays = self.endpoint.call(
                "telemetry", {"arm": timeline_armed[0]}, retries=0,
                timeout_s=self.step_timeout_s)
            t1 = time.perf_counter_ns()
            frame = telemetry_from_wire(meta, arrays)
        except (HostFault, ServingError, WireError) as e:
            hub.mark_stale(self.replica_id, repr(e))
            return
        self._h_rtt.observe((t1 - t0) / 1e9, host=f"h{self.replica_id}")
        hub.ingest(self.replica_id, frame, t0, t1)

    # -- page migration RPCs ------------------------------------------------

    def export_flight(self, mirror: RemoteRequest
                      ) -> Tuple[List[int], List[np.ndarray],
                                 List[np.ndarray]]:
        """Pull one live request's flight state: authoritative token
        list + settled KV pages. Tokens the child generated but had not
        yet heart-beaten to us are folded into the mirror here, so the
        router's stream is caught up before the continuation
        dispatches."""
        meta, arrays = self.endpoint.call(
            "export_flight", {"rid": mirror.rid}, retries=1)
        tokens = [int(t) for t in meta["tokens"]]
        known = len(mirror.prompt) + len(mirror.stream.tokens)
        if len(tokens) > known:
            self._tokens_total += mirror._apply(
                {"new": tokens[known:], "state": mirror.state})
        ks, vs = decode_pages(meta, arrays)
        return tokens, ks, vs

    def import_prefix(self, tokens: Sequence[int],
                      k_slabs: Sequence[np.ndarray],
                      v_slabs: Sequence[np.ndarray]) -> Dict[str, int]:
        """Push migrated pages into this host's prefix cache."""
        meta: Dict[str, Any] = {"tokens": [int(t) for t in tokens],
                                "n_pages": len(k_slabs)}
        arrays: Dict[str, np.ndarray] = {}
        if k_slabs:
            ks, vs = np.stack(k_slabs), np.stack(v_slabs)
            meta["kv_dtype"] = dtype_name(ks.dtype)
            arrays = {"k_slabs": ks, "v_slabs": vs}
        meta_r, _ = self.endpoint.call("import_prefix", meta, arrays,
                                       retries=1)
        return {k: v for k, v in meta_r.items()
                if k in ("imported_pages", "skipped_pages",
                         "imported_bytes", "evicted_pages")}

    # -- router-facing state ------------------------------------------------

    @property
    def default_max_new_tokens(self) -> int:
        return self.engine.config.max_new_tokens

    @property
    def pending(self) -> int:
        return int(self._last["pending"])

    @property
    def active(self) -> int:
        """Live mirrors — parent-side truth, so the watchdog arms the
        moment a submit lands even before the first heartbeat reply."""
        return sum(1 for m in self._mirrors.values() if not m.done)

    @property
    def inflight(self) -> int:
        return int(self._last["inflight"])

    @property
    def queue_depth(self) -> int:
        return int(self._last["queue_depth"])

    @property
    def degraded(self) -> bool:
        return bool(self._last["degraded"])

    @property
    def progress_marker(self) -> tuple:
        return (self._tokens_total, self._completed_total, self.active)

    @property
    def slo_monitor(self):
        return None             # per-host SLOs live host-side; the
        # router's fleet monitor covers the outcome objective

    def statusz(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "replica_id": self.replica_id,
            "health": self.health.snapshot(),
            "draining": self.draining,
            "transport": self.endpoint.stats(),
            "mirrors": len(self._mirrors),
            "last_heartbeat": dict(self._last)}
        try:
            meta, _ = self.endpoint.call("statusz", retries=0,
                                         timeout_s=2.0)
        except (HostFault, ServingError, WireError) as e:
            # an unreachable endpoint must not look healthy: serve the
            # last good view, visibly STALE, and count the failure
            self._c_statusz_err.inc(host=f"h{self.replica_id}")
            view = dict(self._statusz_cache)
            view["stale"] = True
            view["stale_error"] = repr(e)
            view["last_success_t"] = self._statusz_last_success
            out["host"] = view
        else:
            self._statusz_cache = dict(meta.get("statusz", {}))
            self._statusz_last_success = self._clock()
            view = dict(self._statusz_cache)
            view["stale"] = False
            out["host"] = view
        return out

    # -- chaos surface ------------------------------------------------------

    def kill(self) -> None:
        """Host death — under :class:`PipeTransport` a real process
        kill, mid-decode state and all."""
        self.endpoint.kill()

    def stall(self, duration_s: float) -> None:
        self.endpoint.stall(duration_s)

    def slow(self, duration_s: float, delay_s: float) -> None:
        self.endpoint.slow_link(duration_s, delay_s)

    def close(self) -> None:
        self.endpoint.close()


# ---------------------------------------------------------------------------
# the multi-host router
# ---------------------------------------------------------------------------

MAX_MIGRATION_LOG = 64


class HostFleetRouter(FleetRouter):
    """A :class:`~.router.FleetRouter` whose replicas are engine
    processes: everything the fleet tier proved — prefix-affinity
    routing, breaker-driven ejection, byte-identical mid-stream
    failover, drain, probes — applies unchanged, because
    :class:`HostHandle` speaks the replica surface. This subclass adds
    what only exists once replicas are processes: host-scoped chaos,
    :meth:`migrate_host` (drain WITH the KV pages), ``host_lost``
    forensics, and the migration metric families."""

    def __init__(self, hosts: Sequence[HostHandle],
                 config: Optional[RouterConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 fault_injector=None):
        super().__init__(hosts, config=config, clock=clock, sleep=sleep,
                         fault_injector=fault_injector)
        self._migration_log: List[dict] = []
        reg = get_registry()
        self._c_mig_bytes = reg.counter(
            "paddle_migration_bytes_total",
            "KV bytes moved across host boundaries (wire payload)")
        self._c_mig_pages = reg.counter(
            "paddle_migration_pages_total",
            "KV pages moved across host boundaries")
        self._c_mig_reqs = reg.counter(
            "paddle_migration_requests_total",
            "live requests migrated between hosts, by outcome",
            labels=("outcome",))
        self._h_mig_s = reg.histogram(
            "paddle_migration_seconds",
            "end-to-end per-request migration latency "
            "(export -> import -> redispatch)")
        self._g_host = reg.gauge(
            "paddle_host_state",
            "host breaker state: 0 healthy / 1 suspect / 2 ejected / "
            "3 half-open / 4 draining / 5 drained",
            labels=("host",))
        #: parent-side telemetry federation: every handle's heartbeat
        #: feeds it while armed; bundles embed its snapshot
        self.federation = FederationHub()
        for h in self.replicas.values():
            if isinstance(h, HostHandle):
                h.federation = self.federation
        # host-loss bundles embed the migration timeline + host states
        flight_recorder.attach_multihost(self)

    # -- the fleet loop -----------------------------------------------------

    def _step_inner(self, params) -> None:
        cfg = self.config
        if self.injector is not None \
                and hasattr(self.injector, "fire_host"):
            # host chaos fires before the base loop (1-based step ids,
            # aligned with the base replica events)
            step = self._steps + 1
            for hid, h in self.replicas.items():
                if self.injector.fire_host("host_die", step,
                                           host=hid) is not None:
                    h.kill()
                if self.injector.fire_host("host_stall", step,
                                           host=hid) is not None:
                    h.stall(cfg.stall_s)
                f = self.injector.fire_host("link_slow", step, host=hid)
                if f is not None:
                    h.slow(cfg.slow_s, f.delay_s if f.delay_s is not None
                           else cfg.slow_delay_s)
        super()._step_inner(params)
        for hid, h in self.replicas.items():
            self._g_host.set(self._state_code(h), host=str(hid))

    # -- host loss ----------------------------------------------------------

    def _eject(self, rid: int, r, reason: str) -> None:
        live = [req for req in self._requests.values()
                if req.replica_id == rid and req.handle is not None
                and not req.done]
        process_dead = isinstance(r, HostHandle) \
            and not r.endpoint.alive()
        emit_event("host_lost", host=rid, error=reason,
                   inflight=len(live), process_dead=process_dead,
                   migrations=len(self._migration_log))
        if process_dead:
            # freeze the dead host's telemetry mirror as its last-known
            # state — the host_lost bundle embeds it (host_telemetry.json)
            self.federation.mark_lost(rid)
            # the pages died with the process: a surviving affinity
            # slice would route same-prefix traffic at a cold (or
            # never-returning) host on re-admission
            self.invalidate_index(rid)
        else:
            self.federation.mark_stale(rid, reason)
        super()._eject(rid, r, reason)

    # -- live migration -----------------------------------------------------

    def migrate_host(self, src: int, dst: Optional[int] = None
                     ) -> Dict[str, Any]:
        """Gracefully move host ``src``'s work to ``dst`` (least-loaded
        accepting sibling when None), pages included: per live request
        — export at src, import into dst's prefix cache, redispatch the
        continuation to dst (its prefill hits the imported blocks and
        computes only the tail), then cancel at src to free the pages.
        A request whose transfer fails (dead src, corrupt frame, full
        dst pool after rollback) falls back to plain failover routing —
        recomputed, not lost. Returns a per-migration summary; totals
        land in the ``paddle_migration_*`` families, the memory
        ledger's migration timeline and one ``page_migration`` event
        per request."""
        r = self.replicas[src]
        if dst is None:
            cands = [hid for hid in sorted(self.replicas)
                     if hid != src
                     and not self.replicas[hid].draining
                     and not self.replicas[hid].degraded
                     and self.replicas[hid].health.accepting]
            if not cands:
                raise ServingError(
                    "no_migration_target",
                    f"no accepting sibling to migrate host {src} to")
            dst = min(cands,
                      key=lambda c: (self._load(self.replicas[c]), c))
        if dst == src:
            raise ValueError(f"cannot migrate host {src} onto itself")
        d = self.replicas[dst]
        self.drain(src)         # queued work hands off page-free
        live = [req for req in self._requests.values()
                if req.replica_id == src and req.handle is not None
                and not req.done]
        summary = {"src": src, "dst": dst, "requests": 0, "pages": 0,
                   "bytes": 0, "skipped_pages": 0, "failed": 0,
                   "seconds": 0.0}
        for req in live:
            t0 = self._clock()
            trace = spans_armed()
            mig_ns0 = time.perf_counter_ns() if trace else 0
            mirror = req.handle
            try:
                tokens, ks, vs = r.export_flight(mirror)
                nbytes = int(sum(a.nbytes for a in ks)
                             + sum(a.nbytes for a in vs))
                imported = (d.import_prefix(tokens, ks, vs) if ks
                            else {"imported_pages": 0, "skipped_pages": 0,
                                  "imported_bytes": 0, "evicted_pages": 0})
                dcn_ns1 = time.perf_counter_ns() if trace else 0
                # pages now live at dst: teach the affinity index, free
                # the src copy, land the continuation where the KV is
                self._index_insert(dst, tokens)
                try:
                    r.cancel(mirror.rid)
                except Exception:
                    pass
                self._dispatch(req, dst, None)
                dt = self._clock() - t0
                if trace:
                    # the DCN window (export -> import) nests inside the
                    # whole-migration span, so the exclusive sweep grows
                    # dcn_transfer + migration segments that still tile
                    # the root request envelope
                    emit_span("router.dcn_transfer", mig_ns0, dcn_ns1,
                              trace_id=req.trace_id,
                              args={"request_id": req.rid,
                                    "bytes": nbytes, "pages": len(ks)})
                    emit_span("router.migration", mig_ns0,
                              time.perf_counter_ns(),
                              trace_id=req.trace_id,
                              args={"request_id": req.rid, "src": src,
                                    "dst": dst, "pages": len(ks),
                                    "bytes": nbytes})
                self._c_mig_bytes.inc(nbytes)
                self._c_mig_pages.inc(len(ks))
                self._c_mig_reqs.inc(outcome="ok")
                self._h_mig_s.observe(dt)
                self._c_requests.inc(replica=str(src), outcome="migrated")
                if memory_armed[0]:
                    memory_ledger.note_migration(
                        nbytes=nbytes, pages=len(ks), seconds=dt,
                        src_host=src, dst_host=dst, outcome="ok")
                entry = {"request_id": req.rid, "src": src, "dst": dst,
                         "pages": len(ks), "bytes": nbytes,
                         "imported_pages": imported["imported_pages"],
                         "skipped_pages": imported["skipped_pages"],
                         "seconds": round(dt, 6), "outcome": "ok"}
                emit_event("page_migration", trace_id=req.trace_id,
                           **entry)
                summary["requests"] += 1
                summary["pages"] += len(ks)
                summary["bytes"] += nbytes
                summary["skipped_pages"] += imported["skipped_pages"]
                summary["seconds"] += dt
            except Exception as e:  # noqa: BLE001 - per-request fallback
                dt = self._clock() - t0
                self._c_mig_reqs.inc(outcome="failed")
                self._h_mig_s.observe(dt)
                if memory_armed[0]:
                    memory_ledger.note_migration(
                        nbytes=0, pages=0, seconds=dt, src_host=src,
                        dst_host=dst, outcome="failed")
                entry = {"request_id": req.rid, "src": src, "dst": dst,
                         "pages": 0, "bytes": 0, "seconds": round(dt, 6),
                         "outcome": "failed", "error": repr(e)}
                emit_event("page_migration", trace_id=req.trace_id,
                           **entry)
                summary["failed"] += 1
                # destination rolled back (import_prefix's except path);
                # the request itself survives via the plain
                # recompute-the-prefix failover route
                try:
                    r.cancel(mirror.rid)
                except Exception:
                    pass
                try:
                    self._route(req, exclude={src})
                except ServingError:
                    pass        # parked; the step loop keeps retrying
            self._migration_log.append(entry)
            del self._migration_log[:-MAX_MIGRATION_LOG]
        return summary

    # -- observability ------------------------------------------------------

    def multihost_snapshot(self) -> Dict[str, Any]:
        """The multi-host slice of a debug bundle (``multihost.json``):
        per-host breaker + transport state and the migration timeline —
        a host-loss bundle answers "what moved where before it died"
        without correlating external logs."""
        return {
            "steps": self._steps,
            "hosts": {str(hid): {
                "state": self._state_code(h),
                "health": h.health.snapshot(),
                "transport": (h.endpoint.stats()
                              if isinstance(h, HostHandle) else {}),
                "draining": h.draining,
            } for hid, h in sorted(self.replicas.items())},
            "migrations": [dict(e) for e in self._migration_log],
        }

    def statusz(self) -> Dict[str, Any]:
        out = super().statusz()
        out["multihost"] = {
            "migrations": len(self._migration_log),
            "migrated_pages": sum(e.get("pages", 0)
                                  for e in self._migration_log),
            "migrated_bytes": sum(e.get("bytes", 0)
                                  for e in self._migration_log),
        }
        return out

    def close(self) -> None:
        """Tear the fleet down: shut every host process/endpoint."""
        self._alive[0] = False
        for h in self.replicas.values():
            if isinstance(h, HostHandle):
                h.close()
