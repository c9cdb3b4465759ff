"""Subsystem-neutral building blocks — counterpart of ``paddle_tpu/core``:
the Tensor and its dispatcher (``tensor``, ``dispatch``, ``autograd``,
``dtype``, ``place``), the op tables (``math_ops``, ``extra_ops``,
``op_schema``), ``offload``, and ``histogram`` / ``host_arrays``.

``core/compat.py`` has no counterpart: it wraps JAX-only APIs
(``shard_map``, ``jax.export``).

The re-exports below (``Tensor``, the places, the grad-mode contexts)
load on first use, so the serving stack's ``core.histogram`` imports no
more than it needs.
"""

_EXPORTS = {
    "Tensor": "tensor", "Parameter": "tensor",
    "Place": "place", "CPUPlace": "place", "TPUPlace": "place",
    "XLAPlace": "place", "CUDAPlace": "place", "set_device": "place",
    "get_device": "place", "current_place": "place",
    "is_compiled_with_tpu": "place",
    "no_grad": "autograd", "enable_grad": "autograd",
    "set_grad_enabled": "autograd", "is_grad_enabled": "autograd",
}


def __getattr__(name):
    import importlib
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    if name in ("dtype", "math_ops", "tensor", "dispatch", "autograd",
                "place", "extra_ops", "op_schema", "offload", "histogram",
                "host_arrays"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
