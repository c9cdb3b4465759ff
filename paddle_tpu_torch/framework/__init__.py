"""Framework-plane utilities — counterpart of ``paddle_tpu/framework``:
``save``/``load`` and the default dtype."""

from . import io_save  # noqa: F401
from .io_save import save, load  # noqa: F401
from ..core.dtype import set_default_dtype, get_default_dtype  # noqa: F401
