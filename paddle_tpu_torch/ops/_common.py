"""Shared helpers for the kernel library: device resolution and the
build-at-first-use loader for the hand-written CUDA kernels.

Counterpart of ``paddle_tpu/ops/_common.py``. Where the JAX package
picks a backend from the platform and a flag (``use_pallas``), the port
picks it from the tensor: a CPU tensor takes an op's plain PyTorch
version, a CUDA tensor launches the op's kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

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


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels); install the CUDA toolkit")
    return path


def _so_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
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
