"""``paddle_tpu_torch.hub`` — models from a ``hubconf.py``, counterpart
of ``paddle_tpu/hub.py`` (``list``, ``help``, ``load``). The ``local``
source is supported; ``github`` and ``gitee`` need a download and raise
as the reference does."""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import List

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir: str):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {_HUBCONF} under {repo_dir!r}")
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    return mod


def _check_source(source: str):
    if source != "local":
        raise RuntimeError(
            f"hub source {source!r} needs network access (github/gitee "
            "download), unavailable in this environment; clone the repo "
            "and use source='local'")


def list(repo_dir: str, source: str = "local",
         force_reload: bool = False) -> List[str]:  # noqa: A001
    """Entrypoint names exported by the repo's hubconf."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir: str, model: str, source: str = "local",  # noqa: A001
         force_reload: bool = False) -> str:
    """The entrypoint's docstring."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"no callable entrypoint {model!r} in "
                           f"{repo_dir}/{_HUBCONF}")
    return fn.__doc__ or ""


def load(repo_dir: str, model: str, source: str = "local",
         force_reload: bool = False, **kwargs):
    """Call the hubconf entrypoint and return its model."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"no callable entrypoint {model!r} in "
                           f"{repo_dir}/{_HUBCONF}")
    return fn(**kwargs)
