"""The PyTorch port stands alone: no module of ``paddle_tpu_torch`` (nor
``chip_smoke.py``, nor the scripts it runs) imports JAX or anything of
the JAX package, kernels
are built and imported lazily, and the smoke script refuses to run
without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "paddle_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}


def _port_sources():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("*_torch.py"))
             + [REPO / "scripts" / "eager_llama_step.py"])
    assert len(files) >= 10
    assert REPO / "scripts" / "multihost_serve_smoke_torch.py" in files
    return files


def _imported_top_levels(path: Path):
    """Top-level module names a file imports (absolute imports only; a
    relative import stays inside its own package)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    # whole module names: ``paddle_tpu_torch`` is fine, ``paddle_tpu`` is not
    bad = FORBIDDEN.intersection(_imported_top_levels(path))
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scan_catches_a_planted_import(tmp_path):
    planted = tmp_path / "m.py"
    planted.write_text("import paddle_tpu_torch\n"
                       "from paddle_tpu.ops import rope\n"
                       "def f():\n    import jax.numpy as jnp\n")
    assert FORBIDDEN.intersection(_imported_top_levels(planted)) == {
        "paddle_tpu", "jax"}


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_the_port_loads_no_jax_and_no_kernel_toolchain():
    code = ("import sys, paddle_tpu_torch.inference.decoding, "
            "paddle_tpu_torch.ops.rms_norm, "
            "paddle_tpu_torch.ops.paged_attention, "
            "paddle_tpu_torch.ops.flash_attention, "
            "paddle_tpu_torch.ops.layer_norm_fused, "
            "paddle_tpu_torch.models.llama, "
            "paddle_tpu_torch.models.ernie; "
            "bad = [m for m in ('jax', 'paddle_tpu', 'triton') "
            "if m in sys.modules]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_sources_use_a_plain_c_interface():
    """Kernels bind through ctypes (no PyTorch headers: those cost
    minutes of nvcc per build)."""
    sources = list((PORT / "csrc").glob("*.cu"))
    assert sources
    for src in sources:
        text = src.read_text()
        assert 'extern "C"' in text
        assert "torch/" not in text and "ATen/" not in text


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if _cuda_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _cuda_available():
    import torch
    return torch.cuda.is_available()


def probe_host(**kw):
    """A spawned host's factory (``"test_torch_isolation:probe_host"``):
    the port's default host on the CPU, refusing to build, and failing
    every engine step, while the process holds a module of JAX or of the
    JAX package."""
    from paddle_tpu_torch.serving.multihost import llama_tiny_host

    def check():
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in FORBIDDEN)
        if bad:
            raise ImportError(f"the host process imported {bad[:5]}")
    check()
    eng, params = llama_tiny_host(device="cpu", **kw)
    real_step = eng.step

    def step(p):
        out = real_step(p)
        check()
        return out
    eng.step = step
    check()
    return eng, params


def test_a_spawned_host_imports_no_jax():
    """A host process spawned by ``PipeTransport`` (the parent here has
    JAX loaded) builds and serves a request with no module of JAX or of
    the JAX package in its ``sys.modules``."""
    import numpy as np
    from paddle_tpu_torch.serving import (HostEndpoint, HostHandle,
                                          PipeTransport)
    tr = PipeTransport("test_torch_isolation:probe_host",
                       {"max_new_tokens": 4}, host_id=0)
    h = HostHandle(0, HostEndpoint(tr, timeout_s=60.0))
    try:
        mirror = h.submit(np.arange(1, 8, dtype=np.int32))
        deadline = 100
        while not mirror.done:
            h.step(None)
            deadline -= 1
            assert deadline > 0
        assert mirror.state == "done", mirror.stream.error
        assert len(mirror.stream.tokens) == 4
    finally:
        h.close()
    assert not tr.alive()
