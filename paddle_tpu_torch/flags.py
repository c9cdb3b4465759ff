"""Global flag registry — counterpart of ``paddle_tpu/flags.py``: the same
flags under the same names and defaults, with ``FLAGS_<name>``
environment overrides, :func:`get_flags` and :func:`set_flags`.

``check_nan_inf`` arms the dispatcher's nan/inf scan
(``core.dispatch``), and ``benchmark`` makes it wait for the card after
every op.

The three routing flags ``use_pallas_kernels``, ``use_pallas_rms_norm``
and ``use_pallas_layer_norm`` choose between a TPU kernel and its XLA
fallback in the JAX package. The port has no such switch: a tensor on
the card always launches its kernel, and one on the host always takes
the plain version. They read True, which is what the port does (the
reference's ``use_pallas_layer_norm`` defaults to False), and setting
any of them raises ``ops._common.not_ported`` — a stated difference.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Union

_REGISTRY: Dict[str, "_Flag"] = {}

#: flags whose value is fixed by the port's routing (module docstring)
ROUTING_FLAGS = ("use_pallas_kernels", "use_pallas_rms_norm",
                 "use_pallas_layer_norm")


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name: str, default: Any, typ: type, help_str: str):
        self.name = name
        self.default = default
        self.type = typ
        self.help = help_str
        self.value = self._from_env(default)

    def _from_env(self, default: Any) -> Any:
        raw = os.environ.get("FLAGS_" + self.name)
        if raw is None or self.name in ROUTING_FLAGS:
            return default
        return _parse(raw, self.type)


def _parse(raw: str, typ: type) -> Any:
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return typ(raw)


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    """Register a flag (idempotent; keeps the existing value on re-register)."""
    if name in _REGISTRY:
        return
    _REGISTRY[name] = _Flag(name, default, type(default), help_str)


def _key(n: str) -> str:
    key = n[len("FLAGS_"):] if n.startswith("FLAGS_") else n
    if key not in _REGISTRY:
        raise ValueError(f"Unknown flag: {n}")
    return key


def get_flags(flags: Union[str, Iterable[str], None] = None) -> Dict[str, Any]:
    if flags is None:
        names: List[str] = list(_REGISTRY)
    elif isinstance(flags, str):
        names = [flags]
    else:
        names = list(flags)
    return {n: _REGISTRY[_key(n)].value for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    for n, v in flags.items():
        key = _key(n)
        if key in ROUTING_FLAGS:
            from .ops._common import not_ported
            raise not_ported(
                f"FLAGS_{key} (a switch between a kernel and its plain "
                "version; the port routes by the tensor's device)",
                "kernel-routing")
        f = _REGISTRY[key]
        f.value = _parse(v, f.type) if isinstance(v, str) and f.type is not str else f.type(v)


def flag_value(name: str) -> Any:
    return _REGISTRY[name].value


# ---------------------------------------------------------------------------
# The flag corpus of the JAX package, same names and defaults (the routing
# flags read True: module docstring).
# ---------------------------------------------------------------------------
define_flag("check_nan_inf", False, "Scan op outputs for nan/inf (debug pass).")
define_flag("check_nan_inf_level", 0, "0: report all; higher levels reduce verbosity.")
define_flag("use_pallas_kernels", True, "Kernels for card tensors (fixed: the port routes by device).")
define_flag("use_pallas_rms_norm", True, "The RMSNorm kernel for card tensors (fixed).")
define_flag("use_pallas_layer_norm", True, "The LayerNorm kernels for card tensors (fixed).")
define_flag("deterministic", False, "Force deterministic compilation/reductions where possible.")
define_flag("log_level", 0, "VLOG-style verbosity for framework-internal logging.")
define_flag("benchmark", False, "Wait for the card after every op (eager debugging).")
define_flag("ring_attention_mode", "ring", "Long-context attention mode: 'ring' or 'ulysses'.")
define_flag("serving_a8w8_prefill", True,
            "When serving with int8-quantized weights, run PREFILL matmuls "
            "on the int8xint8->int32 path with per-token activation scales. "
            "Decode keeps weight-only dequant. 0 = weight-only everywhere.")
define_flag("dy2static_fallback", True,
            "On ConversionError under to_static, warn and fall back to the "
            "eager path instead of raising. Set to 0 for the strict raise.")
define_flag("dy2static_rebind_wrappers", True,
            "Allow dy2static conversion to re-bind a wraps-style "
            "decorator's closure cell onto the converted function "
            "(process-wide). Set to 0 to keep the wrapper untouched.")
define_flag("remat_policy", "none", "Default rematerialisation policy: none|dots|everything.")
