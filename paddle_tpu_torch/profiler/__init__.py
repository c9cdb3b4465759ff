"""Host span recorder and ``RecordEvent`` annotations (counterpart of
``paddle_tpu/profiler``). Only ``record`` is ported so far; the
``Profiler`` capture window and its statistics come later."""

from .record import RecordEvent, host_recorder, record_function  # noqa: F401
