"""``paddle_tpu_torch.hapi`` — the high-level Model API, counterpart of
``paddle_tpu/hapi``: ``Model``, ``summary``, the callbacks and the
progress bar."""

from .model import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
from .progressbar import ProgressBar  # noqa: F401
