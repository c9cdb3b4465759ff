"""``paddle_tpu_torch.serving`` — the request-serving layer over the
continuous-batching engine (counterpart of ``paddle_tpu/serving``): a
priority/deadline admission scheduler with load shedding and
cancellation (:mod:`.scheduler`), per-request streaming token delivery
(:mod:`.stream`) and TTFT/ITL/utilization metrics exported as Prometheus
text and profiler spans (:mod:`.metrics`).

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

Not yet ported: the fleet tier (``router``, ``replica``, ``health``,
``elastic``, ``roles``, ``autoscale``, ``wire``, ``multihost``).
"""

from .metrics import Histogram, ServingMetrics  # noqa: F401
from .scheduler import (  # noqa: F401
    RequestState, SchedulerConfig, ServingRequest, ServingScheduler,
)
from .stream import ServingError, TokenStream  # noqa: F401

__all__ = [
    "Histogram", "ServingMetrics", "RequestState", "SchedulerConfig",
    "ServingRequest", "ServingScheduler", "ServingError", "TokenStream",
]
