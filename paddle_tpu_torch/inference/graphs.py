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
from typing import Any, Callable, Dict, Optional, Tuple

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
        self._captured: Optional[Captured] = None
        self.calls = 0
        #: host-to-device input copies made (one per static input a call)
        self.uploads = 0
        #: seconds the capture took (0 until captured, and without graphs)
        self.capture_seconds = 0.0
        #: device memory the capture reserved for the graph's
        #: intermediates in the shared pool (bytes; 0 without graphs)
        self.pool_bytes = 0

    @torch.no_grad()
    def __call__(self) -> torch.Tensor:
        for name, buf in self.static.items():
            buf.copy_(self._staging[name], non_blocking=True)
        self.uploads += len(self.static)
        self.calls += 1
        if self._captured is not None:
            return self._captured.replay()
        if self._graphs is None:
            return self.body(**self.static)
        run = lambda: self.body(**self.static)        # noqa: E731
        out = warm_up(run, self._graphs.stream, self._graphs.device)
        # a capture that raises leaves the program uncaptured: the next
        # call warms up and captures again
        self._captured = capture(run, self._graphs.stream,
                                 self._graphs.device, self._graphs.pool)
        self.capture_seconds = self._captured.seconds
        self.pool_bytes = self._captured.pool_bytes
        return out


def warm_up(body: Callable[[], Any], stream: torch.cuda.Stream,
            device: torch.device):
    """``body()`` run on ``stream``: a first call's real work, before
    its capture (it also compiles the kernels and warms cuBLAS)."""
    main = torch.cuda.current_stream(device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = body()
    main.wait_stream(stream)
    return out


class Captured:
    """One captured body: its graph, its outputs (the graph's own
    buffers, rewritten by each replay), the kernel launches one replay
    makes, the pinned host constants the graph copies from, the seconds
    the capture took and the memory it reserved in its pool."""

    __slots__ = ("graph", "out", "counts", "keep", "seconds", "pool_bytes")

    def replay(self):
        self.graph.replay()
        add_launch_counts(self.counts)
        return self.out


def capture(body: Callable[[], Any], stream: torch.cuda.Stream,
            device: torch.device, pool=None) -> Captured:
    """Capture ``body()`` into a CUDA graph on ``stream``, in ``pool``
    (a private pool when None). The one capture path of the port's
    compiled programs (this module's and ``jit``'s). A failed capture
    raises; the launch counts it added are taken back either way."""
    from ..core import tensor as _tensor_mod
    t0 = time.perf_counter()
    c = Captured()
    c.keep = []
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    # a garbage collection inside the capture may free another
    # program's graph (a retired engine's, a dropped replica's), and
    # freeing a graph while a stream captures invalidates the capture:
    # collect before it, and not during it
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    # a host constant built in the body is copied from pinned memory
    # that lives as long as the graph (``core.tensor.to_torch``)
    keep = _tensor_mod._capture_keep[0]
    _tensor_mod._capture_keep[0] = c.keep
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            # read after the capture's own empty_cache
            reserved = torch.cuda.memory_reserved(device)
            out = body()
    finally:
        _tensor_mod._capture_keep[0] = keep
        if collecting:
            gc.enable()
        after = launch_counts()
        counts = {k: n - before.get(k, 0) for k, n in after.items()
                  if n != before.get(k, 0)}
        add_launch_counts(counts, -1)       # capture ran nothing
    torch.cuda.current_stream(device).wait_stream(stream)
    c.graph, c.out, c.counts = graph, out, counts
    c.seconds = time.perf_counter() - t0
    c.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    return c
