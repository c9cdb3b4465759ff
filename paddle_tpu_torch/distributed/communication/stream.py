"""``paddle.distributed.communication.stream`` — counterpart of
``paddle_tpu/distributed/communication/stream.py``: the collectives with
the reference's ``use_calc_stream`` parameter, delegating to the eager
ones. ``torch.distributed`` orders each call on the current stream, so
``use_calc_stream`` and ``sync_op`` are accepted and change nothing.
"""

from __future__ import annotations

from .. import collective as _c
from .p2p import send as _send, recv as _recv


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op=op, group=group)


def all_gather(tensor_or_tensor_list, tensor=None, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_tensor_list, tensor, group=group)


def reduce_scatter(tensor, tensor_or_tensor_list=None, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_tensor_list, op=op, group=group)


def broadcast(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.broadcast(tensor, src=src, group=group)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst=dst, op=op, group=group)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_tensor_list, src=src, group=group)


def alltoall(out_tensor_or_list, in_tensor_or_list=None, group=None,
             sync_op=True, use_calc_stream=False):
    return _c.alltoall(out_tensor_or_list, in_tensor_or_list, group=group)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _send(tensor, dst=dst, group=group)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _recv(tensor, src=src, group=group)
