"""Launch context — counterpart of ``paddle_tpu/distributed/launch/
context.py``, the part ``spawn`` uses: free ports, the node's address and
the local device count. The CLI's ``Args``, ``parse_args`` and
``Context`` come with the launcher (the context-parallelism, MoE and
launch slice) and raise.
"""

from __future__ import annotations

import os
import socket
from typing import List

from ...ops._common import not_ported

_LATER = ("Args", "parse_args", "Context")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def node_ip() -> str:
    """This node's address: ``POD_IP``, else the address of the route
    the kernel would pick (a UDP ``connect`` sends no packet), else the
    loopback."""
    host = os.environ.get("POD_IP")
    if host:
        return host
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def detect_devices() -> int:
    """Processes to spawn on this node by default: ``PADDLE_NPROC_PER_NODE``,
    else one per CUDA device (one without a card)."""
    env = os.environ.get("PADDLE_NPROC_PER_NODE")
    if env:
        return max(1, int(env))
    import torch
    return max(1, torch.cuda.device_count())


def __getattr__(name):
    if name in _LATER:
        raise not_ported(f"launch.context.{name} (the launch CLI)",
                         "Distributed III")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
