"""The cross-node rendezvous master — counterpart of
``paddle_tpu/distributed/launch/master.py``. The port's native
``TCPStore`` (``distributed/store.py`` over ``csrc/tcp_store.cc``) plays
both the HTTP master and etcd of Paddle's launcher: node ranks by an
atomic ``add``, the peers' endpoints by set/get, and a generation
counter for elastic re-rendezvous. One node needs no store
(``LocalMaster``).
"""

from __future__ import annotations

import json
import socket
import time
from typing import List, Optional, Tuple

from ..store import TCPStore


def _local_addresses() -> set:
    addrs = {"127.0.0.1", "0.0.0.0", "localhost"}
    try:
        addrs.add(socket.gethostname())
        for info in socket.getaddrinfo(socket.gethostname(), None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return addrs


class LocalMaster:
    """Single-node: everything is local, no store needed."""

    def __init__(self):
        self._gen = 0

    def sync_peers(self, endpoints: List[str], rank: int, nnodes_min: int,
                   nnodes_max: int, gen: int = 0) -> Tuple[int, List[List[str]]]:
        return 0, [endpoints]

    def get_gen(self) -> int:
        return self._gen

    def bump_gen(self) -> int:
        self._gen += 1
        return self._gen

    def close(self):
        pass


class StoreMaster:
    """Multi-node rendezvous over TCPStore.

    Each node publishes its worker endpoints under a generation namespace;
    node ranks are assigned first-come by an atomic counter unless pinned
    with --rank. With an elastic ``min:max`` node range, the first node
    closes membership once >= min nodes have settled (or max arrived).
    """

    def __init__(self, endpoint: str, node_ip: str, rank: int,
                 job_id: str = "default", timeout_s: float = 120.0,
                 settle_s: float = 3.0):
        host, port = endpoint.rsplit(":", 1)
        try:
            resolved = socket.gethostbyname(host)
        except OSError:
            resolved = host
        is_host = (rank == 0) or (
            rank < 0 and (resolved in _local_addresses() or
                          resolved == node_ip or host in _local_addresses()))
        self.store = TCPStore(host=resolved, port=int(port),
                              is_master=is_host, timeout=timeout_s)
        self.prefix = f"launch/{job_id}"
        self.timeout_s = timeout_s
        self.settle_s = settle_s

    def sync_peers(self, endpoints: List[str], rank: int, nnodes_min: int,
                   nnodes_max: int, gen: int = 0
                   ) -> Tuple[int, List[List[str]]]:
        """Register this node; return (node_rank, peers by node rank).

        Membership decision (elastic range): the rank-0 node waits until the
        join counter reaches ``nnodes_max``, or >= ``nnodes_min`` with no new
        arrivals for ``settle_s``, then publishes the agreed world under
        ``{ns}/world``; everyone else blocks on that key.
        """
        ns = f"{self.prefix}/g{gen}"
        # Pinned (--rank) and auto-assigned ranks cannot mix: an auto node
        # could collide with a pinned rank it cannot see. Fail fast — and do
        # it BEFORE joining the membership counter, so an aborting node does
        # not become a phantom member its peers wait on.
        mode = "pinned" if rank >= 0 else "auto"
        other = "auto" if mode == "pinned" else "pinned"
        self.store.add(f"{ns}/mode_{mode}", 1)
        if self.store.add(f"{ns}/mode_{other}", 0) > 0:
            raise RuntimeError(
                "rendezvous: some nodes pinned --rank while others did not; "
                "pin every node's rank or none")
        if rank < 0:
            rank = self.store.add(f"{ns}/node_counter", 1) - 1
        else:
            self.store.add(f"{ns}/node_counter", 1)
        self.store.set(f"{ns}/node/{rank}", json.dumps(endpoints))

        if rank == 0:
            deadline = time.monotonic() + self.timeout_s
            last_n, last_change = 0, time.monotonic()
            while True:
                n = self.store.add(f"{ns}/node_counter", 0)
                now = time.monotonic()
                if n != last_n:
                    last_n, last_change = n, now
                if n >= nnodes_max:
                    break
                if n >= nnodes_min and now - last_change >= self.settle_s:
                    break
                if now > deadline:
                    raise TimeoutError(
                        f"rendezvous: only {n}/{nnodes_min} nodes joined "
                        f"within {self.timeout_s}s")
                time.sleep(0.1)
            world = min(last_n, nnodes_max)
            self.store.set(f"{ns}/world", str(world))
        world = int(self.store.get(f"{ns}/world", timeout=self.timeout_s))
        if rank >= world:
            raise RuntimeError(
                f"node rank {rank} joined after membership closed at "
                f"{world} nodes (gen {gen}); wait for the next generation")
        peers: List[Optional[List[str]]] = [None] * world
        for i in range(world):
            raw = self.store.get(f"{ns}/node/{i}", timeout=self.timeout_s)
            peers[i] = json.loads(raw.decode())
        return rank, peers  # type: ignore[return-value]

    # -- elastic generation (etcd membership-watch equivalent) --------------

    def get_gen(self) -> int:
        return self.store.add(f"{self.prefix}/gen", 0)

    def bump_gen(self) -> int:
        return self.store.add(f"{self.prefix}/gen", 1)

    def close(self):
        self.store.close()


def make_master(master: Optional[str], node_ip: str, rank: int,
                job_id: str, is_multi_node: bool, timeout_s: float = 120.0):
    if not is_multi_node:
        return LocalMaster()
    if not master:
        raise ValueError(
            "--master ip:port is required for multi-node launch "
            "(it hosts the TCPStore rendezvous)")
    return StoreMaster(master, node_ip, rank, job_id=job_id,
                       timeout_s=timeout_s)
