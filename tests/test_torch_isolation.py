"""The PyTorch port stands alone: no module of ``paddle_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or anything of the JAX package, kernels
are built and imported lazily, and the smoke script refuses to run
without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "paddle_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 10
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
