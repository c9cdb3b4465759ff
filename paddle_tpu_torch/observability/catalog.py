"""Central telemetry catalog: every registry-owned metric, every
structured event kind and every request-path span name, declared in ONE
place — counterpart of ``paddle_tpu/observability/catalog.py``, with the
same entries (the port emits the reference's names, so one contract
covers both packages).

Motivation: a typo'd metric name or label, or a misspelled
``emit_event`` kind, silently mints a brand-new series — dashboards and
alerts keep watching the old name and see flatlines. This module is the
contract; the JAX package's analyzer checks that package's call sites
against its copy, and the port's tests hold the families and event kinds
the port emits to this one.

Scope notes:

* only *registry-owned* families appear in ``METRICS`` — subsystem sinks
  (``ServingMetrics``, ``ResilienceMetrics``) declare their own families
  in their ``__init__`` and are checked against those declarations;
* label tuples are positional contracts: every call site must pass
  exactly these label names (the registry enforces it at runtime too —
  the contract catches it before the conflicting registration crashes a
  prod scrape).
"""

from __future__ import annotations

#: registry-owned families: name -> (kind, label names)
METRICS = {
    # -- runtime dispatch / compile telemetry (observability/runtime.py) --
    "paddle_runtime_op_duration_us": ("histogram", ()),
    "paddle_runtime_recompiles_total": ("counter", ("fn",)),
    "paddle_runtime_compile_seconds": ("histogram", ("fn",)),
    # -- event log (observability/events.py) ------------------------------
    "paddle_events_dropped_total": ("counter", ()),
    # -- SLO engine (observability/slo.py) ---------------------------------
    "paddle_slo_burn_rate": ("gauge", ("slo", "window")),
    "paddle_slo_budget_remaining": ("gauge", ("slo",)),
    "paddle_slo_breached": ("gauge", ("slo",)),
    "paddle_slo_breaches_total": ("counter", ("slo",)),
    # -- goodput / stragglers (observability/goodput.py) -------------------
    "paddle_goodput_ratio": ("gauge", ()),
    "paddle_stragglers_total": ("counter", ("source",)),
    # -- anomaly detection (observability/anomaly.py) -----------------------
    "paddle_anomaly_events_total": ("counter", ("series", "detector")),
    "paddle_anomaly_score": ("gauge", ("series",)),
    # -- signal bus (observability/signals.py) ------------------------------
    "paddle_signal_value": ("gauge", ("signal",)),
    # -- HBM memory ledger (observability/memory.py) ------------------------
    "paddle_mem_bytes": ("gauge", ("class",)),
    "paddle_mem_peak_bytes": ("gauge", ("class",)),
    "paddle_mem_admission_rejects_total": ("counter", ()),
    # -- profile-guided fusion pass (jit/fusion.py) -------------------------
    "paddle_fusion_admitted_total": ("counter", ("region",)),
    "paddle_fusion_skipped_total": ("counter", ("reason",)),
    "paddle_fusion_active": ("gauge", ("region",)),
    # -- elastic mesh resize (serving/elastic.py) ---------------------------
    "paddle_mesh_chips": ("gauge", ("replica",)),
    "paddle_mesh_resizes_total": ("counter", ("replica",)),
    "paddle_mesh_chip_faults_total": ("counter", ("replica", "kind")),
    # -- fleet router (serving/router.py) ----------------------------------
    "paddle_router_requests_total": ("counter", ("replica", "outcome")),
    "paddle_router_replica_state": ("gauge", ("replica",)),
    "paddle_router_failovers_total": ("counter", ()),
    "paddle_router_prefix_affinity_hits_total": ("counter", ()),
    "paddle_router_parked_age_seconds": ("histogram", ()),
    # -- disaggregated prefill/decode fleet (serving/roles.py) ---------------
    "paddle_router_replica_role": ("gauge", ("replica",)),
    "paddle_handoff_requests_total": ("counter", ("outcome",)),
    "paddle_handoff_pages_total": ("counter", ()),
    "paddle_handoff_bytes_total": ("counter", ()),
    "paddle_handoff_seconds": ("histogram", ()),
    # -- autoscaling control plane (serving/autoscale.py) --------------------
    "paddle_autoscale_decisions_total": ("counter", ("action",)),
    "paddle_autoscale_replicas": ("gauge", ()),
    # -- speculative decoding (inference/speculative.py) -------------------
    "paddle_spec_drafted_tokens_total": ("counter", ("replica",)),
    "paddle_spec_accepted_tokens_total": ("counter", ("replica",)),
    "paddle_spec_rejected_tokens_total": ("counter", ("replica",)),
    "paddle_spec_acceptance_ratio": ("gauge", ("replica",)),
    # -- sampling epilogue / constrained decoding (inference/sampling.py) --
    "paddle_sampling_requests_total": ("counter", ("mode",)),
    "paddle_sampling_tokens_total": ("counter", ("mode",)),
    "paddle_sampling_violations_total": ("counter", ()),
    "paddle_sampling_grammar_states": ("gauge", ()),
    # -- multi-host serving / DCN page migration (serving/multihost.py) -----
    "paddle_migration_bytes_total": ("counter", ()),
    "paddle_migration_pages_total": ("counter", ()),
    "paddle_migration_requests_total": ("counter", ("outcome",)),
    "paddle_migration_seconds": ("histogram", ()),
    "paddle_host_state": ("gauge", ("host",)),
    "paddle_host_statusz_errors_total": ("counter", ("host",)),
    "paddle_host_heartbeat_rtt_seconds": ("histogram", ("host",)),
    # -- telemetry federation (observability/federation.py) ------------------
    "paddle_federation_frames_total": ("counter", ("host",)),
    "paddle_federation_spans_merged_total": ("counter", ("host",)),
    "paddle_federation_clock_offset_seconds": ("gauge", ("host",)),
    "paddle_federation_clock_error_bound_seconds": ("gauge", ("host",)),
    "paddle_federation_stale_mirrors": ("gauge", ()),
    # -- black-box incident journal (observability/journal.py) --------------
    "paddle_journal_frames_total": ("counter", ("type",)),
    "paddle_journal_dropped_total": ("counter", ()),
    # -- prefix cache (kvcache/cache.py) -----------------------------------
    "paddle_kvcache_hits_total": ("counter", ()),
    "paddle_kvcache_misses_total": ("counter", ()),
    "paddle_kvcache_evictions_total": ("counter", ()),
    "paddle_kvcache_cow_copies_total": ("counter", ()),
    "paddle_kvcache_cached_tokens_total": ("counter", ()),
    "paddle_kvcache_pages": ("gauge", ("state",)),
}

#: every structured-event kind the tree may emit (observability/events.py)
EVENT_KINDS = {
    # serving scheduler
    "shed", "cancel", "step_retry", "degraded", "slo_degrade_shed",
    # SLO engine
    "slo_breach", "slo_recovered",
    # anomaly detection (sensor plane)
    "anomaly",
    # HBM memory ledger (allocation failure / page-admission shortfall)
    "oom_pressure",
    # resilience trainer
    "save_failure", "preempt_flush", "rollback", "step_skipped",
    "straggler",
    # runtime compile telemetry
    "recompile",
    # flight recorder
    "debug_dump",
    # incident journal: decode hit a torn/empty tail (power-loss
    # analogue) — the readable prefix is still served, but flagged
    "journal_truncated",
    # fleet router
    "replica_ejected", "replica_recovered", "replica_draining",
    "replica_drained", "failover",
    # elastic mesh resize (chip-level fault -> re-shard -> rejoin)
    "chip_lost", "mesh_resized",
    # multi-host serving: an engine PROCESS died / a live request's KV
    # pages crossed a host boundary (graceful drain or loss recovery)
    "host_lost", "page_migration",
    # fleet router: an unroutable parked request's deadline lapsed
    # before any replica healed (the all-down shed scale-up watches)
    "parked_expired",
    # disaggregated fleet: a replica changed phase role / a finished
    # prefill's KV pages handed off to a decode replica
    "role_changed", "kv_handoff",
    # autoscaling control plane: the fleet changed shape
    "scale_up", "scale_down",
    # prefix cache
    "cache_hit", "cache_evict",
    # speculative decoding (draft rejection -> per-row paged rollback)
    "spec_rollback",
    # constrained decoding: the host-side audit of the in-program grammar
    # mask caught an illegal token (a bug tripwire — the device mask
    # should make this impossible)
    "constraint_violation",
    # profile-guided fusion pass (jit/fusion.py): a hot chain installed
    # as a fused megaregion / skipped with a structured reason (stale
    # artifact symbol-missing, schema-mismatch, no-region, ...)
    "fusion_applied", "fusion_skipped",
}

#: every request-path span the tree may emit (``profiler.record.
#: emit_span`` / ``ServingMetrics.span``): canonical name -> allowed
#: ``args`` fields. Namespaced spans (``<metrics namespace>.<name>``)
#: are declared by their suffix — call sites build the prefix with an
#: f-string whose trailing literal is checked. The timeline collector's
#: critical-path attribution (observability/timeline.py) keys on these
#: names, so a typo'd span silently drops a segment from every request
#: breakdown; the JAX package's ``span-contract`` rule checks both
#: directions there.
SPANS = {
    # scheduler request lifecycle (serving/scheduler.py); the request
    # envelope and admission spans carry the memory ledger's per-request
    # attribution (pages held, cached-vs-fresh bytes) so /tracez answers
    # "what did this request cost in HBM" next to "where did its time go"
    "request": ("request_id", "kv_pages", "cached_bytes", "fresh_bytes"),
    "step": (),
    "queue_wait": ("request_id",),
    "admission": ("request_id", "kv_pages", "cached_bytes",
                  "fresh_bytes"),
    # engine phases (inference/decoding.py)
    "engine.prefill": ("request_id", "slot", "prefill_tokens", "bucket",
                       "prompt_len", "cached_tokens"),
    "engine.decode_chunk": ("request_id", "slot", "chunk"),
    "engine.spec_draft": ("request_id", "slot", "drafted"),
    "engine.spec_round": ("request_id", "slot", "drafted"),
    # fleet router envelope + failover attribution (serving/router.py)
    "router.request": ("request_id", "outcome", "failovers"),
    "router.failover_gap": ("request_id", "to_replica", "attempt"),
    # multi-host page migration (serving/multihost.py): the whole
    # per-request drain and its nested DCN wire window (export ->
    # import) — the timeline sweep's `migration` / `dcn_transfer`
    # segments in cross-host trace trees
    "router.migration": ("request_id", "src", "dst", "pages", "bytes"),
    "router.dcn_transfer": ("request_id", "bytes", "pages"),
    # disaggregated fleet: one prefill->decode KV handoff (export ->
    # wire round-trip -> import -> redispatch), serving/roles.py
    "router.kv_handoff": ("request_id", "src", "dst", "pages", "bytes"),
}


def declared_metric(name: str):
    """(kind, labels) or None — runtime helper mirror of the lint rule."""
    return METRICS.get(name)


def declared_event(kind: str) -> bool:
    return kind in EVENT_KINDS


def declared_span(name: str):
    """Allowed args fields for a span name (suffix-resolved like the
    lint rule) or None — runtime helper mirror of ``span-contract``."""
    if name in SPANS:
        return SPANS[name]
    return SPANS.get(name.rsplit(".", 1)[-1])
