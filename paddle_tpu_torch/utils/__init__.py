"""``paddle_tpu_torch.utils`` — counterpart of ``paddle_tpu/utils``:
DLPack interchange (``dlpack``), ``unique_name``, ``try_import``,
``deprecated`` and ``run_check``."""

from . import dlpack  # noqa: F401
from . import unique_name  # noqa: F401

import functools
import importlib
import warnings

__all__ = ["dlpack", "unique_name", "try_import", "deprecated",
           "run_check"]


def try_import(module_name: str, err_msg: str = None):
    """Import a module by name, with the reference's friendlier error."""
    try:
        return importlib.import_module(module_name)
    except ImportError:
        if err_msg is None:
            err_msg = (f"Failed to import {module_name!r}; this optional "
                       "dependency is not installed in the environment")
        raise ImportError(err_msg)


def deprecated(update_to: str = "", since: str = "", reason: str = ""):
    """Decorator marking an API deprecated (a DeprecationWarning a call)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"API {fn.__name__!r} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f"; use {update_to!r} instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def run_check():
    """Check the install (paddle.utils.run_check): one matmul on the
    current place (the card unless ``set_device("cpu")``), read back."""
    import torch
    from ..core.place import current_place
    dev = current_place().torch_device()
    x = torch.ones((128, 128), dtype=torch.float32, device=dev)
    y = x @ x
    assert float(y[0, 0]) == 128.0
    print(f"paddle_tpu_torch is installed successfully! device: {dev}")
