"""Compiled serving programs: the port's counterpart of a ``jax.jit``
cache entry of ``paddle_tpu/inference/decoding.py``.

A :class:`Program` is one fixed-shape body over static buffers. The host
writes a call's inputs into pinned staging tensors (``program.host[name]``
is a numpy view of each); every call copies them into the static device
buffers on the current stream and runs the body over those buffers.

* On the card the first call runs the body eagerly on the engine's
  capture stream (the call's real work; it also compiles the Triton and
  CUDA kernels, fills the model's rope cache and warms cuBLAS), then
  captures the body into a ``torch.cuda.CUDAGraph``. Every later call
  replays the graph. A capture that fails raises: there is no eager
  fallback.
* On the CPU, or on the card with graphs turned off, the body runs on
  every call, over the same buffers.

Launch counts survive replays: capture launches nothing, so the counts
the capture added (``ops._common.launch_counts``) are taken back and
added once per replay. ``launches`` thus counts the kernels the card ran,
by eager calls or by replays.

A capture is thread-local (``capture_error_mode="thread_local"``): the
serving scheduler's step watchdog may capture a new program on its own
thread while the calling thread goes on, and CUDA calls made by other
threads during the capture do not invalidate it.

The graphs of one engine share one memory pool and one capture stream
(:class:`GraphPool`). They never run concurrently, and each program's
outputs stay alive in the program, so no capture reuses another's
outputs; the engine copies what it keeps before the next program runs.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops._common import add_launch_counts, launch_counts


def params_key(params) -> tuple:
    """What a program captured of its params: each tensor's name,
    address, shape and dtype. A graph reads its weights at the captured
    addresses, so other tensors mean a rebuild."""
    return tuple((k, v.data_ptr(), tuple(v.shape), v.dtype)
                 for k, v in params.items())


class GraphPool:
    """The memory pool and capture stream that an engine's graphs
    share."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)


class Program:
    """One compiled program (module docstring).

    ``inputs`` maps each static input's name to ``(shape, dtype)``;
    ``body(**static)`` returns the program's output tensor. ``graphs``
    is the engine's :class:`GraphPool`, or None to run the body on every
    call. ``params_id`` is what the program captured of the params it
    was built over (:func:`params_key`)."""

    def __init__(self, body: Callable[..., torch.Tensor],
                 inputs: Dict[str, Tuple[tuple, torch.dtype]],
                 device: torch.device, graphs: Optional[GraphPool],
                 params_id: tuple = ()):
        pin = device.type == "cuda"
        self.body = body
        self.params_id = params_id
        self.static = {n: torch.zeros(s, dtype=dt, device=device)
                       for n, (s, dt) in inputs.items()}
        self._staging = {n: torch.zeros(s, dtype=dt, pin_memory=pin)
                         for n, (s, dt) in inputs.items()}
        #: numpy views of the staging tensors: the host writes here
        self.host = {n: t.numpy() for n, t in self._staging.items()}
        self._graphs = graphs
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._counts: Dict[tuple, int] = {}
        self.calls = 0
        #: seconds the capture took (0 until captured, and without graphs)
        self.capture_seconds = 0.0
        #: device memory the capture reserved for the graph's
        #: intermediates in the shared pool (bytes; 0 without graphs)
        self.pool_bytes = 0

    @torch.no_grad()
    def __call__(self) -> torch.Tensor:
        for name, buf in self.static.items():
            buf.copy_(self._staging[name], non_blocking=True)
        self.calls += 1
        if self._graph is not None:
            self._graph.replay()
            add_launch_counts(self._counts)
            return self._out
        if self._graphs is None:
            return self.body(**self.static)
        out = self._warm_up()
        self._capture()
        return out

    def _warm_up(self) -> torch.Tensor:
        """The first call's real work, on the capture stream."""
        side = self._graphs.stream
        main = torch.cuda.current_stream(self._graphs.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(**self.static)
        main.wait_stream(side)
        return out

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # a garbage collection inside the capture may free another
        # program's graph (a retired engine's, a dropped replica's), and
        # freeing a graph while a stream captures invalidates the capture:
        # collect before it, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._graphs.pool,
                                  stream=self._graphs.stream,
                                  capture_error_mode="thread_local"):
                # read after the capture's own empty_cache
                reserved = torch.cuda.memory_reserved(self._graphs.device)
                out = self.body(**self.static)
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self._counts = {k: n - before[k] for k, n in after.items()
                        if n != before[k]}
        add_launch_counts(self._counts, -1)     # capture ran nothing
        self._graph, self._out = graph, out
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = (torch.cuda.memory_reserved(self._graphs.device)
                           - reserved)
