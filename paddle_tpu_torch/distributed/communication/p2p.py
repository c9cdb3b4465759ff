"""Point-to-point communication — counterpart of
``paddle_tpu/distributed/communication/p2p.py``: ``send``/``recv``,
``isend``/``irecv`` and ``batch_isend_irecv`` between processes over
``torch.distributed`` (the reference exchanges through an in-process
mailbox and raises across processes, l.74-86).

``dst``/``src`` are world ranks. ``recv`` writes into the tensor it is
given, in place. The non-blocking calls return a :class:`P2PTask` over
the ``torch.distributed`` work handle; ``batch_isend_irecv`` issues its
operations in list order (on NCCL as one coalesced group, so that
matched pairs cannot deadlock). ``ppermute_exchange`` is the exchange
of the reference's compiled pipeline: ``collective.ppermute`` over a
mesh axis, with its gradient.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ...core.tensor import Tensor
from ..collective import Group, _unwrap


class P2PTask:
    """The handle of a point-to-point operation: ``wait()`` blocks until
    it is done; ``tensor`` is the tensor received, for a receive."""

    def __init__(self, tensor: Optional[Tensor] = None, *, work=None):
        self.tensor = tensor
        self._work = work

    def wait(self) -> bool:
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self) -> bool:
        return self._work is None or bool(self._work.is_completed())


def _dist():
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "point-to-point communication needs a process group: call "
            "paddle_tpu_torch.distributed.init_parallel_env() first")
    return dist


def _pg(group: Optional[Group]):
    return group.pg if group is not None else None


def _buffer(tensor) -> torch.Tensor:
    """The storage a receive writes into (shared with ``tensor``)."""
    return _unwrap(tensor).detach()


def send(tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True, tag: int = 0):
    dist = _dist()
    v = _unwrap(tensor).detach().contiguous()
    if sync_op:
        dist.send(v, int(dst), group=_pg(group), tag=tag)
        return P2PTask()
    return P2PTask(work=dist.isend(v, int(dst), group=_pg(group), tag=tag))


def recv(tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True, tag: int = 0):
    dist = _dist()
    buf = _buffer(tensor)
    if sync_op:
        dist.recv(buf, int(src), group=_pg(group), tag=tag)
        return P2PTask(tensor)
    return P2PTask(tensor, work=dist.irecv(buf, int(src), group=_pg(group),
                                           tag=tag))


def isend(tensor, dst: int = 0, group: Optional[Group] = None, tag: int = 0):
    return send(tensor, dst, group, sync_op=False, tag=tag)


def irecv(tensor, src: int = 0, group: Optional[Group] = None, tag: int = 0):
    return recv(tensor, src, group, sync_op=False, tag=tag)


class P2POp:
    """One batched p2p operation (parity: paddle.distributed.P2POp).

    ``op`` is the isend/irecv function; ``peer`` the remote rank.
    """

    def __init__(self, op, tensor, peer: int, group: Optional[Group] = None,
                 tag: int = 0):
        if op not in (isend, irecv):
            raise ValueError(
                "op must be paddle_tpu_torch.distributed.isend/irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group
        self.tag = tag


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[P2PTask]:
    """Issue the operations in list order and return one task each."""
    if not p2p_op_list:
        return []
    dist = _dist()
    ops = []
    for op in p2p_op_list:
        if op.op is isend:
            ops.append(dist.P2POp(dist.isend,
                                  _unwrap(op.tensor).detach().contiguous(),
                                  int(op.peer), _pg(op.group), op.tag))
        else:
            ops.append(dist.P2POp(dist.irecv, _buffer(op.tensor),
                                  int(op.peer), _pg(op.group), op.tag))
    works = dist.batch_isend_irecv(ops)
    return [P2PTask(op.tensor if op.op is irecv else None, work=w)
            for op, w in zip(p2p_op_list, works)]


def ppermute_exchange(x, axis: str, perm: List[Tuple[int, int]]):
    """In-program batched p2p, as the pipeline schedules use it:
    ``perm`` is ``[(src, dst), ...]`` in group ranks of ``axis``, as in
    ``lax.ppermute`` (see ``collective.ppermute``)."""
    from ..collective import ppermute
    return ppermute(x, axis, perm)
