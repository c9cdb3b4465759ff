"""``paddle_tpu_torch.profiler`` — counterpart of ``paddle_tpu/profiler``:
the host span recorder and ``RecordEvent`` (``record``), the
scheduler-windowed ``Profiler`` with its exporters (``profiler``) and the
summary tables (``statistic``). The device trace of a capture window is
``torch.profiler``'s, with CPU and CUDA activities."""

from .profiler import (  # noqa: F401
    Profiler, ProfilerState, ProfilerTarget, make_scheduler,
    export_chrome_tracing, export_protobuf,
)
from .record import RecordEvent, record_function, host_recorder  # noqa: F401
from .statistic import SortedKeys, summary  # noqa: F401
from . import statistic as profiler_statistic  # noqa: F401
