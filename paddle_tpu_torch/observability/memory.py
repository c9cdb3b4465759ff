"""HBM memory ledger: byte-level accounting for the paged serving stack —
counterpart of ``paddle_tpu/observability/memory.py``.

The observability plane answers "where did the time go" (timelines,
sensors) but not "where did the bytes go" — and the paged KV pool is the
dominant device-memory consumer of a paged serving stack (PAPERS.md
"Ragged Paged Attention"). This module is the memory half of the sensor
plane. Byte counts are read off the tensors (``.nbytes``, ``.dtype``,
``.shape``: host metadata, never a device sync); a budget handed to
:func:`plan_capacity` is the caller's (the card's
``torch.cuda.get_device_properties(i).total_memory``, or a pool's own
bytes as the ledger's planner verdict passes them):

* :class:`MemoryLedger` — process-global, registry-integrated accounting
  of device bytes by **class**:

  ========== ==========================================================
  class      what it measures
  ========== ==========================================================
  weights    model parameter pytrees (dtype-aware; fed once per params
             object by the engine / trainer)
  kv_live    paged-pool pages pinned by in-flight sequences (admission
             reservations included, speculative tails excluded)
  kv_spec    speculative tail pages (``grow_to`` growth past each row's
             admission reservation — rolled back on rejection)
  kv_cached  resident-but-unreferenced prefix-cache pages (evictable)
  kv_free    free-list pages
  optimizer  training state (params + optimizer accumulators) via
             ``ResilientTrainer``
  ========== ==========================================================

  with per-class **peak watermarks**, ``paddle_mem_bytes{class}`` /
  ``paddle_mem_peak_bytes{class}`` gauges, and a **byte conservation
  audit** — ``free + live + spec + cached bytes == pool bytes`` — run
  alongside the pool's ``check_conservation`` after every engine step.

* :func:`plan_capacity` — the capacity planner: model geometry +
  page_size + dtype + an HBM budget → page bytes, max pages, max
  concurrent sequences, max total context tokens. ``page_nbytes`` is
  DERIVED from geometry (2 × layers × page_size × kv_heads × head_dim ×
  dtype bytes), so an int8 page pool automatically halves it. Every
  live pool carries a **planner verdict**: the plan recomputed from the pool's own
  geometry and byte size must predict its page capacity exactly.

* **per-request attribution** — pages (cached-vs-fresh bytes) held per
  request, keyed by trace id, surfaced at ``/memz``, in ``/statusz``'s
  ``memory`` section and in every flight bundle's ``memory.json``.

* **OOM forensics** — :func:`note_oom` turns ``allocate``/``grow_to``
  ``MemoryError`` raises and scheduler page-admission rejections into an
  ``oom_pressure`` JSONL event plus a once-per-reason flight-recorder
  ``auto_dump`` whose ``memory.json`` names the exhausting class, the
  per-request page holders and the planner verdict — a self-explaining
  postmortem instead of a bare ``MemoryError``.

Discipline (the telemetry layer's standing contracts):

* **fed, never pulls** — this module never imports the serving stack,
  the engine or the kvcache package (tpu-lint ``layer-deps`` checks this
  file STRICTLY: even lazy function-scope imports of serving/ or
  inference/ fail). Call sites hand it manager objects / pytrees /
  numbers; everything here is duck-typed attribute reads.
* **zero-cost disarmed gate** — hot paths check the module-cell
  ``memory_armed`` (one list index, no allocation) exactly like
  ``flight.flight_armed`` / ``timeseries.history_armed``; armed overhead
  rides under ``benchmarks/bench_obs_overhead.py``'s 3% budget.
* gauges publish decimated (every ``publish_every`` observations);
  peaks, the audit and the snapshot read the host-side books directly,
  so decimation never costs accuracy — only scrape freshness.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .events import emit_event
from .flight import flight_recorder

#: the one cell hot paths check before feeding the ledger (mutable list
#: so callers read a stable module attribute, not a rebindable name)
memory_armed = [False]

#: every accounting class the ledger reports (fixed: dashboards and the
#: MetricHistory rings key on these)
MEM_CLASSES = ("weights", "kv_live", "kv_spec", "kv_cached", "kv_free",
               "optimizer")

#: retained pools (a pool is one engine's paged KV manager); bounded so
#: short-lived test engines cannot grow the process-global ledger forever
MAX_POOLS = 16

#: migration-timeline entries kept in memory (oldest dropped; the
#: cumulative totals are unbounded counters and never lose bytes)
MAX_MIGRATIONS = 64


# ---------------------------------------------------------------------------
# pure helpers (the ONE place these derivations live)
# ---------------------------------------------------------------------------

def page_nbytes(num_layers: int, page_size: int, num_kv_heads: int,
                head_dim: int, dtype_bytes: int) -> int:
    """Device bytes of ONE page across every layer: K and V slabs (the
    factor 2) × layers × page_size tokens × kv_heads × head_dim ×
    element size. Derived from geometry — an int8 page pool
    (``dtype_bytes=1``) halves it with no ledger change."""
    return 2 * num_layers * page_size * num_kv_heads * head_dim * dtype_bytes


def pytree_nbytes(tree: Any) -> int:
    """Total device bytes of a parameter / state pytree (dicts, lists,
    tuples, array leaves with ``.nbytes``) — dtype-aware by construction.
    Non-array leaves (ints, None) count 0."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


def pool_occupancy(mgr) -> Dict[str, float]:
    """THE page-pool occupancy derivation (one source of truth: the
    scheduler's utilization gauges and the signal bus's pool-pressure
    reader both delegate here instead of re-deriving the split by hand).
    Duck-typed over any paged manager: refcounted pools report their
    live/cached split, exclusive pools report owned pages as live."""
    usable = mgr.usable_pages
    free = mgr.num_free_pages
    live = getattr(mgr, "num_live_pages", None)
    if live is None:
        live = usable - free                  # exclusive ownership
    cached = getattr(mgr, "num_cached_pages", 0)
    inv = 1.0 / usable if usable else 0.0
    return {
        "usable": usable, "free": free, "live": live, "cached": cached,
        "pressure": 1.0 - free * inv if usable else 0.0,
        "live_utilization": live * inv,
        "cached_utilization": cached * inv,
    }


def _mgr_page_nbytes(mgr) -> int:
    """A manager's actual per-page byte cost, measured off its device
    arrays (K + V). The planner verdict cross-checks this against the
    geometry-derived :func:`page_nbytes`."""
    pb = getattr(mgr, "page_nbytes", None)
    if pb is not None:
        return int(pb)
    return (int(mgr.k_pages.nbytes) + int(mgr.v_pages.nbytes)) \
        // int(mgr.num_pages)


# ---------------------------------------------------------------------------
# capacity planner
# ---------------------------------------------------------------------------

@dataclass
class CapacityPlan:
    """Output of :func:`plan_capacity` — what a given HBM budget buys.

    ``max_pages`` counts ALLOCATABLE pages (the pool's reserved pad page
    0 is already subtracted), so it compares directly against a live
    pool's ``usable_pages``."""

    page_bytes: int            # bytes of one page (K+V, all layers)
    kv_budget_bytes: int       # HBM left for the pool after weights
    total_pages: int           # pool size including the reserved page
    max_pages: int             # allocatable pages (total - 1)
    max_context_tokens: int    # max_pages * page_size
    max_slots: Optional[int]   # concurrent max_seq_len sequences (None
                               # when no max_seq_len was given)
    pages_per_seq: Optional[int]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "page_bytes": self.page_bytes,
            "kv_budget_bytes": self.kv_budget_bytes,
            "total_pages": self.total_pages,
            "max_pages": self.max_pages,
            "max_context_tokens": self.max_context_tokens,
            "max_slots": self.max_slots,
            "pages_per_seq": self.pages_per_seq,
        }


def plan_capacity(*, num_layers: int, num_kv_heads: int, head_dim: int,
                  page_size: int, dtype_bytes: int, hbm_bytes: int,
                  weight_bytes: int = 0,
                  max_seq_len: Optional[int] = None) -> CapacityPlan:
    """Model geometry + page size + dtype + HBM budget → pool capacity.

    ``hbm_bytes`` is the device budget; ``weight_bytes`` (resident model
    parameters) is carved out first and the remainder becomes the paged
    KV pool. With ``max_seq_len`` the plan also reports how many
    max-length sequences fit concurrently (the engine's ``num_slots``
    ceiling for a worst-case admission policy)."""
    if page_size <= 0 or num_layers <= 0:
        raise ValueError("geometry must be positive")
    pb = page_nbytes(num_layers, page_size, num_kv_heads, head_dim,
                     dtype_bytes)
    kv_budget = max(0, int(hbm_bytes) - int(weight_bytes))
    total = kv_budget // pb
    usable = max(0, total - 1)            # page 0 is the reserved pad page
    pages_per_seq = None
    max_slots = None
    if max_seq_len is not None:
        pages_per_seq = -(-int(max_seq_len) // page_size)   # ceil div
        max_slots = usable // pages_per_seq if pages_per_seq else 0
    return CapacityPlan(
        page_bytes=pb, kv_budget_bytes=kv_budget, total_pages=total,
        max_pages=usable, max_context_tokens=usable * page_size,
        max_slots=max_slots, pages_per_seq=pages_per_seq)


def plan_verdict(plan: CapacityPlan, mgr) -> Dict[str, Any]:
    """Validate a plan against a REAL pool: the plan's page bytes must
    match the pool's measured per-page cost and its ``max_pages`` must
    predict the pool's allocatable capacity exactly."""
    actual_pb = _mgr_page_nbytes(mgr)
    actual_pages = int(mgr.usable_pages)
    exact = (plan.page_bytes == actual_pb
             and plan.max_pages == actual_pages)
    return {
        "predicted_page_bytes": plan.page_bytes,
        "actual_page_bytes": actual_pb,
        "predicted_max_pages": plan.max_pages,
        "actual_max_pages": actual_pages,
        "exact": exact,
    }


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class _Pool:
    __slots__ = ("label", "page_bytes", "usable_pages", "num_pages",
                 "page_size", "pool_bytes", "verdict", "split", "held",
                 "tails", "meta", "cache_stats", "observes", "refcounted",
                 "ref", "chips")

    def __init__(self, label: str):
        self.label = label
        self.ref = None                     # weakref to the manager
        self.page_bytes = 0
        self.usable_pages = 0
        self.num_pages = 0
        self.page_size = 0
        self.pool_bytes = 0
        self.refcounted = False
        self.chips = 1                      # TP mesh degree (head-sharded)
        self.verdict: Dict[str, Any] = {}
        self.split: Dict[str, int] = {}     # class -> pages (last observe)
        self.held: Dict[Any, int] = {}      # rid -> pages (last observe)
        self.tails: Dict[Any, int] = {}     # rid -> spec tail pages
        self.meta: Dict[Any, Dict[str, Any]] = {}  # rid -> admission info
        self.cache_stats: Optional[Dict[str, Any]] = None
        self.observes = 0


class MemoryLedger:
    """See module docstring. One process-global instance
    (:data:`memory_ledger`); independent instances constructible for
    tests. Every entry point is cheap host bookkeeping; callers gate on
    ``memory_armed[0]`` so the disarmed cost is one list index."""

    def __init__(self, publish_every: int = 16):
        self._lock = threading.Lock()
        self._pools: "OrderedDict[int, _Pool]" = OrderedDict()
        self._pool_seq = 0          # monotonic: labels never collide
        self._classes: Dict[str, int] = {c: 0 for c in MEM_CLASSES}
        self._peaks: Dict[str, int] = {c: 0 for c in MEM_CLASSES}
        # params-id -> (fingerprint, nbytes); LRU-bounded like _pools
        self._weights: "OrderedDict[int, tuple]" = OrderedDict()
        self._publish_every = max(1, int(publish_every))
        self._since_publish = 0
        self._g_bytes = None
        self._g_peak = None
        self._c_rejects = None
        self._last_reject_key = None
        self.audits = 0
        self.last_oom: Optional[Dict[str, Any]] = None
        # cross-host page-migration books (fed by the multi-host router;
        # NOT a MEM_CLASS — migrated bytes land in kv_* when the
        # destination pool is observed, this tracks the TRANSFERS)
        self._migration: Dict[str, int] = {
            "bytes": 0, "pages": 0, "requests": 0}
        self._migration_log: list = []

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return memory_armed[0]

    def arm(self) -> "MemoryLedger":
        """Arm the memory plane (flips the ``memory_armed`` cell the
        engine/scheduler/trainer feeds gate on) and bind the registry
        families (idempotent: re-arming after a registry reset re-binds
        fresh gauge objects)."""
        from .registry import get_registry
        reg = get_registry()
        with self._lock:
            self._g_bytes = reg.gauge(
                "paddle_mem_bytes",
                "device bytes by accounting class (HBM memory ledger)",
                labels=("class",))
            self._g_peak = reg.gauge(
                "paddle_mem_peak_bytes",
                "peak device bytes by accounting class since arm/reset",
                labels=("class",))
            self._c_rejects = reg.counter(
                "paddle_mem_admission_rejects_total",
                "scheduler admissions deferred for KV pages (per blocked "
                "step; the event carries the byte shortfall)")
        memory_armed[0] = True
        return self

    def disarm(self) -> None:
        memory_armed[0] = False

    def reset(self) -> None:
        """Drop every pool, class total and peak (tests). Metric handles
        are dropped too, so a re-arm (or the next reject) re-binds into
        the CURRENT registry — a ``registry.reset()`` between tests must
        not leave the ledger incrementing orphaned families."""
        with self._lock:
            self._pools.clear()
            self._pool_seq = 0
            self._classes = {c: 0 for c in MEM_CLASSES}
            self._peaks = {c: 0 for c in MEM_CLASSES}
            self._weights.clear()
            self._last_reject_key = None
            self._g_bytes = None
            self._g_peak = None
            self._c_rejects = None
            self.audits = 0
            self.last_oom = None
            self._migration = {"bytes": 0, "pages": 0, "requests": 0}
            self._migration_log = []

    # -- cross-host migration accounting ------------------------------------

    def note_migration(self, *, nbytes: int, pages: int, requests: int = 1,
                       seconds: float = 0.0, src_host=None, dst_host=None,
                       outcome: str = "ok") -> None:
        """Account one request's KV-page transfer across a host boundary
        (the multi-host router feeds this per migrated request): bump
        the cumulative byte/page/request totals and append a bounded
        timeline entry — the byte audit's answer to "how much KV
        actually crossed DCN", next to the per-pool splits the
        destination's next :meth:`observe` re-balances."""
        with self._lock:
            self._migration["bytes"] += int(nbytes)
            self._migration["pages"] += int(pages)
            self._migration["requests"] += int(requests)
            self._migration_log.append({
                "bytes": int(nbytes), "pages": int(pages),
                "seconds": float(seconds), "src_host": src_host,
                "dst_host": dst_host, "outcome": outcome})
            del self._migration_log[:-MAX_MIGRATIONS]

    def migration_snapshot(self) -> Dict[str, Any]:
        """Cumulative migration totals + the bounded transfer timeline
        (embedded in ``memory.json`` / ``/statusz``'s memory section)."""
        with self._lock:
            return {"totals": dict(self._migration),
                    "recent": [dict(e) for e in self._migration_log]}

    # -- class accounting ---------------------------------------------------

    def _set_class_locked(self, cls: str, nbytes: int) -> None:
        self._classes[cls] = int(nbytes)
        if nbytes > self._peaks[cls]:
            self._peaks[cls] = int(nbytes)

    def note_class(self, cls: str, nbytes: int) -> None:
        """Feed one class's current byte count directly (the trainer's
        ``optimizer`` feed; pool classes go through :meth:`observe`)."""
        if cls not in self._classes:
            raise ValueError(f"unknown memory class {cls!r}; "
                             f"one of {MEM_CLASSES}")
        with self._lock:
            self._set_class_locked(cls, nbytes)
            self._publish_locked(force=True)

    def note_weights(self, params: Any) -> int:
        """Account a model parameter pytree (dtype-aware). Cached by the
        pytree object's identity plus a cheap content fingerprint (a
        recycled ``id()`` on a DIFFERENT pytree must re-walk, and the
        ledger never holds a strong reference that would pin dead
        weights on device), so feeding the same params every step costs
        a dict lookup, not a tree walk. Multiple models (fleet replicas
        sharing a process) sum; the table is LRU-bounded so dead models
        age out of the sum."""
        key = id(params)
        fp = self._params_fingerprint(params)
        with self._lock:
            entry = self._weights.get(key)
            if entry is not None and entry[0] == fp:
                self._weights.move_to_end(key)
                return entry[1]
            nb = pytree_nbytes(params)
            self._weights[key] = (fp, nb)
            self._weights.move_to_end(key)
            while len(self._weights) > MAX_POOLS:
                self._weights.popitem(last=False)
            self._set_class_locked(
                "weights", sum(e[1] for e in self._weights.values()))
            self._publish_locked(force=True)
        return nb

    @staticmethod
    def _params_fingerprint(params: Any):
        """id-reuse guard for the weights cache: the identity of the
        first leaf-ish member. A recycled dict id would also need its
        first value's id recycled to collide — and the fallout of that
        double coincidence is one stale byte count for one feed."""
        if isinstance(params, dict):
            for v in params.values():
                return id(v)
        elif isinstance(params, (list, tuple)) and params:
            return id(params[0])
        return None

    def class_bytes(self, cls: str) -> int:
        with self._lock:
            return self._classes.get(cls, 0)

    def peak_bytes(self, cls: str) -> int:
        with self._lock:
            return self._peaks.get(cls, 0)

    # -- pool accounting (the per-step feed) --------------------------------

    def _prune_dead_pools_locked(self) -> None:
        """Drop entries whose manager has been garbage-collected: a dead
        engine's last split must not keep inflating the class totals
        (and /memz) until enough new pools evict it."""
        dead = [k for k, p in self._pools.items()
                if p.ref is not None and p.ref() is None]
        for k in dead:
            del self._pools[k]

    def _pool_locked(self, mgr) -> _Pool:
        key = id(mgr)
        pool = self._pools.get(key)
        if pool is not None and (
                pool.num_pages != int(mgr.num_pages)
                or pool.page_size != int(mgr.page_size)
                or pool.page_bytes != int(mgr.page_nbytes)
                or pool.chips != (int(getattr(mgr, "mesh_chips", 1)) or 1)
                or (pool.ref is not None and pool.ref() is not mgr)):
            # recycled id(): a DIFFERENT manager landed on a dead one's
            # address — a stale entry's cached capacity would turn the
            # byte audit into a false RuntimeError inside engine.step
            del self._pools[key]
            pool = None
        if pool is not None:
            # LRU, not FIFO: the bound exists to shed short-lived test/
            # warmup pools — evicting the long-lived production pool
            # first would drop its attribution and reorder snapshots
            self._pools.move_to_end(key)
        if pool is None:
            self._prune_dead_pools_locked()
            self._pool_seq += 1
            pool = _Pool(label=f"pool{self._pool_seq}")
            try:                    # liveness probe for the prune pass
                pool.ref = weakref.ref(mgr)
            except TypeError:       # non-weakref-able manager: skip it
                pool.ref = None
            pool.refcounted = hasattr(mgr, "num_live_pages")
            # TP-sharded pools split every page's bytes evenly across
            # the mesh (head-sharded: whole GQA groups per chip), so
            # per-chip HBM cost = class bytes / chips — the capacity
            # answer an elastic resize changes
            pool.chips = int(getattr(mgr, "mesh_chips", 1)) or 1
            pool.num_pages = int(mgr.num_pages)
            pool.page_size = int(mgr.page_size)
            pool.usable_pages = int(mgr.usable_pages)
            pool.page_bytes = _mgr_page_nbytes(mgr)
            pool.pool_bytes = (int(mgr.k_pages.nbytes)
                               + int(mgr.v_pages.nbytes))
            # planner verdict: re-derive the plan from the pool's own
            # geometry + byte size; it must predict capacity exactly
            shape = mgr.k_pages.shape      # (L, P, page, kv_heads, dim)
            plan = plan_capacity(
                num_layers=int(shape[0]), num_kv_heads=int(shape[3]),
                head_dim=int(shape[4]), page_size=int(shape[2]),
                dtype_bytes=int(mgr.k_pages.dtype.itemsize),
                hbm_bytes=pool.pool_bytes)
            pool.verdict = plan_verdict(plan, mgr)
            self._pools[key] = pool
            while len(self._pools) > MAX_POOLS:
                self._pools.popitem(last=False)
        return pool

    def note_request(self, mgr, rid, *, prompt_len: int = 0,
                     cached_pages: int = 0, trace_id: str = "") -> None:
        """Record one admission's attribution metadata: how many of the
        request's pages were borrowed from the prefix cache (the rest
        are fresh). Entries for retired sequences are pruned by the next
        :meth:`observe`."""
        with self._lock:
            pool = self._pool_locked(mgr)
            pool.meta[rid] = {"prompt_len": int(prompt_len),
                              "cached_pages": int(cached_pages),
                              "trace_id": trace_id}

    def observe(self, mgr, *, reserved: Optional[Dict[Any, int]] = None,
                cache_stats: Optional[Dict[str, Any]] = None,
                audit: bool = True) -> Dict[str, int]:
        """One accounting round over a paged manager — the engine calls
        this after every step (gated on ``memory_armed``): derive the
        free/live/spec/cached page split, refresh per-request holdings,
        update class totals + peaks, publish gauges (decimated) and run
        the **byte conservation audit**. ``reserved`` maps live seq ids
        to their admission page reservation: pages held beyond it are
        the speculative tail (class ``kv_spec``). Raises ``RuntimeError``
        when the books don't balance.

        Every call is a FULL accounting round — the feeding CADENCE is
        the feeder's choice: invariant-checked engines feed every step
        (the audit is the point), engines that opted out of per-step
        invariant checking decimate their feed instead
        (``ContinuousBatchingEngine._note_memory``)."""
        with self._lock:
            pool = self._pool_locked(mgr)
            pool.observes += 1
            pb = pool.page_bytes
            tables = mgr._tables
            free = int(mgr.num_free_pages)
            # per-request page holdings (ints only on this hot path —
            # the full attribution dicts materialise on the cold
            # snapshot() read) + spec tails past each reservation
            held = {rid: len(t) for rid, t in tables.items()}
            spec_pages = 0
            if reserved:
                tails = {}
                for rid, r in reserved.items():
                    h = held.get(rid, 0)
                    if h > r:
                        tails[rid] = h - int(r)
                        spec_pages += h - int(r)
                pool.tails = tails
            elif pool.tails:
                pool.tails = {}
            pool.held = held
            if pool.refcounted:
                live = int(mgr.num_live_pages)
                cached = int(mgr.num_cached_pages)
            else:
                # exclusive ownership: live pages = block-table holdings
                # (derived INDEPENDENTLY of the free list, so the byte
                # audit below is a real cross-check, not an identity)
                live = sum(held.values())
                cached = 0
            # prune admission meta for retired sequences (meta only
            # grows at admission, so a size mismatch is the trigger)
            if len(pool.meta) != len(held):
                for rid in [r for r in pool.meta if r not in held]:
                    del pool.meta[rid]
            split = {
                "kv_free": free,
                "kv_live": live - spec_pages,
                "kv_spec": spec_pages,
                "kv_cached": cached,
            }
            pool.split = split
            if cache_stats is not None:
                pool.cache_stats = cache_stats    # live reference; the
            # snapshot copies it (small ints, mutated in place upstream)
            # class totals sum across LIVE pools (fleet replicas in-
            # process; a dead engine's last split ages out immediately)
            self._prune_dead_pools_locked()
            for cls in ("kv_free", "kv_live", "kv_spec", "kv_cached"):
                nb = 0
                for p in self._pools.values():
                    nb += p.split.get(cls, 0) * p.page_bytes
                self._set_class_locked(cls, nb)
            if audit:
                self.audits += 1
                total_b = (free + live + cached) * pb
                pool_b = pool.usable_pages * pb
                if total_b != pool_b:
                    raise RuntimeError(
                        f"byte conservation violated on {pool.label}: "
                        f"free {split['kv_free'] * pb} + live "
                        f"{split['kv_live'] * pb} + spec "
                        f"{split['kv_spec'] * pb} + cached "
                        f"{split['kv_cached'] * pb} = {total_b} != "
                        f"{pool_b} pool bytes "
                        f"({pool.usable_pages} usable pages × {pb})")
            # a pool's first observation publishes immediately (a scrape
            # right after arm must not read zeros); later rounds decimate
            self._publish_locked(force=pool.observes == 1)
            return split

    def _publish_locked(self, force: bool = False) -> None:
        """Refresh the registry gauges (decimated: every
        ``publish_every`` observations unless forced). Peaks and the
        snapshot read the host books directly, so decimation only
        affects scrape freshness."""
        if self._g_bytes is None:
            return
        if not force:
            self._since_publish += 1
            if self._since_publish < self._publish_every:
                return
        self._since_publish = 0
        for cls in MEM_CLASSES:
            self._g_bytes.set(self._classes[cls], **{"class": cls})
            self._g_peak.set(self._peaks[cls], **{"class": cls})

    # -- OOM forensics ------------------------------------------------------

    def note_oom(self, source: str, mgr=None, *, need_pages: int = 0,
                 free_pages: int = 0, request_id=None,
                 trace_id: str = "") -> None:
        """Allocation-failure hook (``allocate``/``extend``/``grow_to``
        raise sites, engine infeasibility): emit an ``oom_pressure``
        event naming the byte shortfall and the dominant (exhausting)
        class, then trigger a once-per-reason flight bundle whose
        ``memory.json`` is the full postmortem. Never raises — this sits
        in failure paths."""
        if not memory_armed[0]:
            return
        try:
            with self._lock:
                pb = 0
                if mgr is not None:
                    pool = self._pool_locked(mgr)
                    pb = pool.page_bytes
                short = max(0, int(need_pages) - int(free_pages))
                if mgr is not None:
                    # the FAILING pool's own split (a sibling replica's
                    # healthy pool must not name the exhausting class);
                    # derived live off the manager — the pool may never
                    # have been observed before its first OOM. Spec
                    # tails come from the last observe's reservation
                    # split, so a draft-dominated pool names kv_spec,
                    # not the committed sequences.
                    occ = pool_occupancy(mgr)
                    spec = sum(pool.tails.values()) if pool.tails else 0
                    kv = {"kv_live": max(0, int(occ["live"]) - spec) * pb,
                          "kv_spec": spec * pb,
                          "kv_cached": int(occ["cached"]) * pb}
                else:
                    kv = {c: self._classes[c]
                          for c in ("kv_live", "kv_spec", "kv_cached")}
                exhausting = max(kv, key=kv.get) if any(kv.values()) \
                    else "kv_live"
                self.last_oom = {
                    "source": source,
                    "need_pages": int(need_pages),
                    "free_pages": int(free_pages),
                    "pages_short": short,
                    "bytes_short": short * pb,
                    "exhausting_class": exhausting,
                    "request_id": request_id,
                }
            emit_event("oom_pressure", source=source,
                       need_pages=int(need_pages),
                       free_pages=int(free_pages),
                       bytes_short=short * pb,
                       exhausting_class=exhausting,
                       request_id=request_id, trace_id=trace_id)
            flight_recorder.auto_dump(f"oom_{source}")
        except Exception:       # forensics must never worsen the failure
            pass

    def note_admission_reject(self, mgr, *, request_id, need_pages: int,
                              free_pages: int, trace_id: str = "") -> None:
        """Scheduler page-admission rejection: count every blocked step
        (``paddle_mem_admission_rejects_total`` — the honest autoscaler
        pressure signal) and emit one ``oom_pressure`` event with the
        byte shortfall per distinct blocked request (a head-of-queue
        request is re-judged every step; one event per victim is signal,
        one per step is spam)."""
        c = self._c_rejects
        if c is None:
            # bound lazily but UNCONDITIONALLY of arming: the pressure
            # counter counts whether or not the memory plane is armed —
            # its meaning must not depend on arm history (the event and
            # dump below stay armed-gated). The local `c` is what gets
            # incremented: a concurrent reset() nulling the handle must
            # not turn this into an AttributeError inside the scheduler.
            from .registry import get_registry
            c = get_registry().counter(
                "paddle_mem_admission_rejects_total",
                "scheduler admissions deferred for KV pages (per "
                "blocked step; the event carries the byte shortfall)")
            with self._lock:
                if self._c_rejects is None:
                    self._c_rejects = c
        c.inc()
        if not memory_armed[0]:
            return
        key = (id(mgr), request_id)
        with self._lock:
            if key == self._last_reject_key:
                return
            self._last_reject_key = key
        self.note_oom("admission", mgr, need_pages=need_pages,
                      free_pages=free_pages, request_id=request_id,
                      trace_id=trace_id)

    # -- history integration ------------------------------------------------

    def attach_history(self, history) -> None:
        """Track every class's byte level into a
        :class:`~.timeseries.MetricHistory` ring (``mem.<class>_bytes``
        gauge series) — the sensor plane samples them on its own
        decimated cadence (``SignalBus.attach_scheduler`` wires this)."""
        for cls in MEM_CLASSES:
            history.track_gauge(f"mem.{cls}_bytes",
                                lambda c=cls: float(self.class_bytes(c)))

    # -- reading ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``memory.json`` / ``/memz`` document: class bytes +
        peaks, per-pool geometry + planner verdict + page split +
        per-request holders + prefix-cache stats, and the last OOM."""
        with self._lock:
            self._prune_dead_pools_locked()
            pools = []
            for p in self._pools.values():
                pb = p.page_bytes
                requests = {}
                for rid, held in p.held.items():
                    meta = p.meta.get(rid)
                    cached_p = meta["cached_pages"] if meta else 0
                    requests[str(rid)] = {
                        "pages": held,
                        "bytes": held * pb,
                        "cached_bytes": cached_p * pb,
                        "fresh_bytes": (held - cached_p) * pb,
                        "spec_tail_pages": p.tails.get(rid, 0),
                        "prompt_len": meta["prompt_len"] if meta else 0,
                        "trace_id": meta["trace_id"] if meta else "",
                    }
                pools.append({
                    "label": p.label,
                    "page_bytes": pb,
                    "page_size": p.page_size,
                    "num_pages": p.num_pages,
                    "usable_pages": p.usable_pages,
                    "pool_bytes": p.pool_bytes,
                    "planner": p.verdict,
                    "pages": dict(p.split),
                    "bytes": {cls: pages * pb
                              for cls, pages in p.split.items()},
                    # the per-chip view of a head-sharded pool: every
                    # page's bytes split evenly across the TP mesh
                    "chips": p.chips,
                    "bytes_per_chip": {cls: pages * pb // p.chips
                                       for cls, pages in p.split.items()},
                    "requests": requests,
                    "cache": dict(p.cache_stats)
                    if p.cache_stats is not None else None,
                    "observes": p.observes,
                })
            return {
                "armed": memory_armed[0],
                "classes": dict(self._classes),
                "peaks": dict(self._peaks),
                "audits": self.audits,
                "pools": pools,
                "last_oom": self.last_oom,
                "migration": {"totals": dict(self._migration),
                              "recent": [dict(e)
                                         for e in self._migration_log]},
            }

    def statusz(self) -> Dict[str, Any]:
        """The /statusz ``memory`` section: the class totals + peaks and
        per-pool planner verdicts (the full per-request table lives on
        ``/memz``)."""
        with self._lock:
            self._prune_dead_pools_locked()
            return {
                "armed": memory_armed[0],
                "classes": dict(self._classes),
                "peaks": dict(self._peaks),
                "audits": self.audits,
                "pools": {p.label: {"pages": dict(p.split),
                                    "planner_exact":
                                        p.verdict.get("exact"),
                                    "requests": len(p.held)}
                          for p in self._pools.values()},
                "last_oom": self.last_oom,
                "migration": dict(self._migration),
            }


#: the process-global ledger the engine/scheduler/trainer feed
memory_ledger = MemoryLedger()


def note_oom(source: str, mgr=None, **kw) -> None:
    """Module-level convenience for the pool's raise sites (gated on
    ``memory_armed`` inside — safe to call unconditionally from rare
    failure paths)."""
    memory_ledger.note_oom(source, mgr, **kw)
