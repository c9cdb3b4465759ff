"""Shared helpers for the kernel library: device resolution, the
build-at-first-use loader for the hand-written CUDA kernels, and the
registry of the kernel wrappers' launch counters.

Counterpart of ``paddle_tpu/ops/_common.py``. Where the JAX package
picks a backend from the platform and a flag (``use_pallas``), the port
picks it from the tensor: a CPU tensor takes an op's plain PyTorch
version, a CUDA tensor launches the op's kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
#: kernels build into the checkout (``build/`` is git-ignored)
BUILD_DIR = _PKG_DIR.parent / "build" / "paddle_tpu_torch"

#: the one CUDA target: Hopper with its architecture-specific features
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per-source ``nvcc -Xptxas -v`` output (registers, shared memory,
#: spills) of the build this process ran or found, for the smoke report
build_logs: Dict[str, str] = {}
#: set while ``jit.save`` exports a program (``torch.export``): the
#: forwards of rows 1, 5 and 8 then go through their custom ops, so the
#: exported graph names them and a loaded program launches the kernels.
#: Eager calls keep the direct call: the custom op's dispatch costs
#: 10-40 µs a call more on the H100, 28 % of an eager greedy decoding
#: step (``chip_smoke.py`` phase 34 (f))
_exporting = [False]


@contextlib.contextmanager
def exporting():
    """The scope of one ``torch.export`` trace (see ``_exporting``)."""
    prev = _exporting[0]
    _exporting[0] = True
    try:
        yield
    finally:
        _exporting[0] = prev


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as an IEEE division on every device: a CUDA
    division by a Python number multiplies by its reciprocal, which can
    differ from the CPU's (and XLA's) quotient in the last bit."""
    return x / torch.full_like(x, d)


def next_multiple(x: int, m: int) -> int:
    """The least multiple of ``m`` that is at least ``x``."""
    return ((x + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: it resolves to ``cuda`` and raises when
    no GPU is present. The CPU is used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stream_scope(device=None) -> Callable[[], contextlib.AbstractContextManager]:
    """A context factory that makes the CALLING thread's current CUDA
    device and stream current wherever it is entered (another thread's
    current stream is its device's default stream). For a CPU device,
    or None, the context does nothing."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.current_stream(dev)

    def scope() -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(stream.device))
        stack.enter_context(torch.cuda.stream(stream))
        return stack
    return scope


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` names, for the
    wrappers that size a grid by the card."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


#: every kernel wrapper that counts its launches (:func:`count_launches`)
_counted: List[Callable] = []


def count_launches(fn: Callable, routes: Iterable[str] = ()) -> Callable:
    """Give the kernel wrapper ``fn`` its launch counters, all 0:
    ``fn.launches`` and, with ``routes``, ``fn.route_launches[route]``;
    and register it, so that a CUDA graph can count on each replay what
    its capture counted (``inference.graphs``). A counter counts where
    the wrapper launches, never in its plain version."""
    fn.launches = 0
    routes = tuple(routes)
    if routes:
        fn.route_launches = dict.fromkeys(routes, 0)
    _counted.append(fn)
    return fn


def launch_counts() -> Dict[tuple, int]:
    """Every registered counter: ``(fn, None)`` for ``fn.launches``,
    ``(fn, route)`` for ``fn.route_launches[route]``."""
    out = {}
    for fn in _counted:
        out[(fn, None)] = fn.launches
        for r, n in getattr(fn, "route_launches", {}).items():
            out[(fn, r)] = n
    return out


def add_launch_counts(counts: Dict[tuple, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (keyed as :func:`launch_counts`)."""
    for (fn, r), n in counts.items():
        if r is None:
            fn.launches += n * times
        else:
            fn.route_launches[r] += n * times


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error an option of a later slice of the port raises."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice "
        "of the PyTorch/CUDA port")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels); install the CUDA toolkit")
    return path


def _so_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source
    and of every header under ``csrc/`` (any of them may be included),
    so an edited header rebuilds every library."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_cuda_sources(names: Iterable[str]) -> None:
    """Compile ``csrc/<name>.cu`` for every name whose library is not
    built yet: one ``nvcc`` process per source, all started together.
    Each library is keyed by a hash of its source, so an edited kernel
    rebuilds and a stale one is never loaded. nvcc's report is kept
    beside the library (``.log``) and in :data:`build_logs`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            log = so.with_suffix(".log")
            build_logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
               "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load_cuda_library(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built on first use.
    The caller sets ``argtypes``/``restype`` of the functions it calls."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_cuda_sources([name])
            lib = _libs[name] = ctypes.CDLL(str(_so_path(name)))
        return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")


def ptxas_report(name: str) -> Dict[str, dict]:
    """Each entry function of ``csrc/<name>.cu`` (its mangled name) with
    its registers and spill bytes, from nvcc's ``-Xptxas -v`` report of
    the library's build (built first if needed)."""
    build_cuda_sources([name])
    out: Dict[str, dict] = {}
    cur = None
    for line in build_logs.get(name, "").splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def sass_counts(name: str) -> Dict[str, dict]:
    """Each function of the library of ``csrc/<name>.cu`` (its mangled
    name) with its wgmma (``HGMMA``) and atomic instructions in the SASS
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_so_path(name))], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split("\n", 1)[0].strip()
        out[fn] = dict(hgmma=part.count("HGMMA"),
                       atomics=part.count("ATOM") + part.count("RED."))
    return out


def triton_cache_dir() -> str:
    """Triton's compile cache goes into the build directory too, so a
    run reads and writes nothing outside its checkout."""
    path = BUILD_DIR / "triton"
    path.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(path))
    return os.environ["TRITON_CACHE_DIR"]


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes=None,
                      ndim: Optional[int] = None) -> None:
    """Wrapper-side argument checks shared by the kernels."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{[str(d) for d in dtypes]}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
