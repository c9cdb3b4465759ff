"""``paddle_tpu_torch.serving`` — the request-serving layer over the
continuous-batching engine (counterpart of ``paddle_tpu/serving``): a
priority/deadline admission scheduler with load shedding and
cancellation (:mod:`.scheduler`), per-request streaming token delivery
(:mod:`.stream`) and TTFT/ITL/utilization metrics exported as Prometheus
text and profiler spans (:mod:`.metrics`); and the fleet tier — a
prefix-aware router over N engine replicas with circuit-breaker failure
detection, graceful drain and mid-stream failover (:mod:`.router`,
:mod:`.replica`, :mod:`.health`), disaggregated prefill/decode roles
with a wire-framed KV page handoff (:mod:`.roles`, :mod:`.wire`) and a
signal-driven autoscaler (:mod:`.autoscale`) and elastic mesh resize
for TP-sharded replicas that survive chip loss (:mod:`.elastic`); and
the host tier — engine processes behind one router, with page migration
between them and telemetry federation (:mod:`.multihost`).

Quick start::

    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.serving import ServingScheduler

    eng = ContinuousBatchingEngine(model_cfg, GenerationConfig(
        max_new_tokens=64), num_slots=8)        # device=None: the card
    sched = ServingScheduler(eng)
    handle = sched.submit(prompt_ids, priority=0, deadline_ms=500,
                          on_token=lambda t: print(t, end=" "))
    while sched.pending:
        sched.step(params)
    tokens = handle.stream.result()
    print(sched.metrics.to_prometheus_text())
"""

from .autoscale import (  # noqa: F401
    AutoscaleConfig, AutoscaleController, AutoscalePolicy, Decision,
    ScaleRecord,
)
from .elastic import (  # noqa: F401
    ElasticServingController, FlightSnapshot, ResizeRecord,
)
from .health import (  # noqa: F401
    HealthConfig, HealthTracker, ReplicaState,
)
from .metrics import Histogram, ServingMetrics  # noqa: F401
from .multihost import (  # noqa: F401
    HostEndpoint, HostFault, HostFleetRouter, HostHandle, HostServer,
    LocalTransport, PipeTransport, RemoteRequest,
)
from .replica import ReplicaFault, ReplicaHandle  # noqa: F401
from .roles import DisaggRouter, ReplicaRole  # noqa: F401
from .router import FleetRouter, RouterConfig, RouterRequest  # noqa: F401
from .scheduler import (  # noqa: F401
    RequestState, SchedulerConfig, ServingRequest, ServingScheduler,
)
from .stream import ServingError, TokenStream  # noqa: F401
from .wire import (  # noqa: F401
    WIRE_VERSION, WireError, decode_message, decode_pages, encode_message,
    encode_pages,
)

__all__ = [
    "Histogram", "ServingMetrics", "RequestState", "SchedulerConfig",
    "ServingRequest", "ServingScheduler", "ServingError", "TokenStream",
    "HealthConfig", "HealthTracker", "ReplicaState", "ReplicaFault",
    "ReplicaHandle", "FleetRouter", "RouterConfig", "RouterRequest",
    "HostEndpoint", "HostFault", "HostFleetRouter", "HostHandle",
    "HostServer", "LocalTransport", "PipeTransport", "RemoteRequest",
    "WIRE_VERSION", "WireError", "encode_message", "decode_message",
    "encode_pages", "decode_pages",
    "DisaggRouter", "ReplicaRole", "AutoscaleConfig", "AutoscaleController",
    "AutoscalePolicy", "Decision", "ScaleRecord",
    "ElasticServingController", "FlightSnapshot", "ResizeRecord",
]
