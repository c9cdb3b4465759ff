"""Launch context — counterpart of ``paddle_tpu/distributed/launch/
context.py``: the CLI's arguments (``Args``, ``parse_args``, the
reference's flags), the environment, and the local devices
(``Context``); the helpers ``spawn`` shares (``free_port``,
``free_ports``, ``reserve_ports``, ``node_ip``, ``detect_devices``). Environment variables
keep the reference's ``PADDLE_*`` names so trainer scripts port
unchanged.
"""

from __future__ import annotations

import argparse
import os
import socket
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reserve_ports(n: int) -> Tuple[List[int], List[socket.socket]]:
    """``n`` free local ports, each kept bound by a socket the caller
    holds (``SO_REUSEADDR``, not listening) until it closes them. While
    held, no other process is handed the port, by ``bind(0)`` or as a
    connection's source port, and a trainer's rendezvous server (which
    binds with ``SO_REUSEADDR`` too) can still take it: the window in
    which :func:`free_ports`' ports can be taken by another process
    before the trainer binds is closed."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    except BaseException:
        for s in socks:
            s.close()
        raise
    return ports, socks


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


def _cards() -> int:
    import torch
    return torch.cuda.device_count()


def detect_devices() -> int:
    """Processes to spawn on this node by default: ``PADDLE_NPROC_PER_NODE``,
    else one per CUDA device (one without a card)."""
    env = os.environ.get("PADDLE_NPROC_PER_NODE")
    if env:
        return max(1, int(env))
    return max(1, _cards())


@dataclass
class Args:
    devices: Optional[str] = None
    nnodes: str = "1"
    nproc_per_node: Optional[int] = None
    master: Optional[str] = None
    rank: int = -1
    job_id: str = "default"
    log_dir: str = "log"
    log_level: str = "INFO"
    run_mode: str = "collective"
    max_restart: int = 3
    elastic_level: int = -1
    elastic_timeout: int = 30
    training_script: str = ""
    training_script_args: List[str] = field(default_factory=list)


def parse_args(argv: Optional[List[str]] = None) -> Args:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch distributed training (the PyTorch/CUDA port "
                    "of paddle.distributed.launch)")
    p.add_argument("--devices", "--gpus", "--xpus", dest="devices",
                   default=None,
                   help="comma-separated local card ids (one process each),"
                        " or 'cpu' for --nproc_per_node CPU ranks (gloo)")
    p.add_argument("--nnodes", default=os.environ.get("PADDLE_NNODES", "1"),
                   help="node count, or elastic range 'min:max'")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="processes per node (default: one per local card)")
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="rendezvous endpoint ip:port (TCPStore)")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_RANK", "-1")),
                   help="node rank (optional; else assigned by master)")
    p.add_argument("--job_id",
                   default=os.environ.get("PADDLE_JOB_ID", "default"))
    p.add_argument("--log_dir", default="log")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--run_mode", default="collective",
                   choices=["collective"],
                   help="only collective mode (no parameter server)")
    p.add_argument("--max_restart", type=int,
                   default=int(os.environ.get("PADDLE_ELASTIC_MAX_RESTART",
                                              "3")))
    p.add_argument("--elastic_level", type=int,
                   default=int(os.environ.get("PADDLE_ELASTIC_LEVEL", "-1")),
                   help="-1 off; >=1 restart local pod on worker fault")
    p.add_argument("--elastic_timeout", type=int, default=30)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    ns = p.parse_args(argv)
    return Args(**vars(ns))


class Context:
    """The parsed launch context. ``device`` is ``"cuda"`` (a process a
    card, NCCL) or ``"cpu"`` (``--devices cpu``, or a node without a
    card: gloo ranks); ``local_nproc`` the trainers on this node."""

    def __init__(self, argv: Optional[List[str]] = None):
        self.args = parse_args(argv)
        self.envs = dict(os.environ)
        if ":" in self.args.nnodes:
            lo, hi = self.args.nnodes.split(":", 1)
            self.nnodes_min, self.nnodes_max = int(lo), int(hi)
            if self.args.elastic_level < 0:
                self.args.elastic_level = 1
        else:
            self.nnodes_min = self.nnodes_max = int(self.args.nnodes)
        devices = self.args.devices
        if devices == "cpu" or (not devices and _cards() == 0):
            self.device = "cpu"
            self.local_nproc = self.args.nproc_per_node or 1
            self.args.devices = None
        elif devices:
            self.device = "cuda"
            self.local_nproc = len([d for d in devices.split(",") if d])
        else:
            self.device = "cuda"
            self.local_nproc = self.args.nproc_per_node or detect_devices()
        self.node_ip = node_ip() if self.nnodes_max > 1 else "127.0.0.1"

    @property
    def is_multi_node(self) -> bool:
        return self.nnodes_max > 1
