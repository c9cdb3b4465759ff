"""Inference Config (parity: ``paddle.inference.Config``) — counterpart
of ``paddle_tpu/inference/config.py``.

The device defaults to the card (the reference's is ``"tpu"``):
``enable_use_gpu`` selects the card and ``disable_gpu`` the CPU. The
optimisation knobs (IR passes, memory optimisation, TensorRT) are
recorded and not used: a loaded program is already the layer's kernels,
captured as a CUDA graph per input signature.
"""

from __future__ import annotations

from typing import Optional


class Config:
    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        # jit.save triple prefix: model_path may be "<prefix>" or
        # "<prefix>.pdmodel" (the reference passes model+params separately)
        if model_path and model_path.endswith(".pdmodel"):
            model_path = model_path[: -len(".pdmodel")]
        self._prefix = model_path
        self._device = "gpu"
        self._device_id = 0
        self._enable_memory_optim = True
        self._switch_ir_optim = True
        self._cache_dir: Optional[str] = None

    # -- model location ------------------------------------------------------
    def set_prog_file(self, path: str) -> None:
        if path.endswith(".pdmodel"):
            path = path[: -len(".pdmodel")]
        self._prefix = path

    def prog_file(self) -> str:
        return (self._prefix or "") + ".pdmodel"

    def params_file(self) -> str:
        return (self._prefix or "") + ".pdiparams"

    def set_model(self, model_path: str, params_path: Optional[str] = None):
        self.set_prog_file(model_path)

    # -- device --------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        """Run on the card ``device_id``."""
        self._device = "gpu"
        self._device_id = device_id

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def torch_device(self):
        import torch
        if self._device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self._device_id)

    def set_cpu_math_library_num_threads(self, n: int):
        pass

    # -- optimisation knobs (recorded) ---------------------------------------
    def switch_ir_optim(self, flag: bool = True):
        self._switch_ir_optim = flag

    def enable_memory_optim(self, flag: bool = True):
        self._enable_memory_optim = flag

    def enable_tensorrt_engine(self, *args, **kwargs):
        """Accepted for API compatibility: the program runs the port's
        own kernels."""

    def enable_tuned_tensorrt_dynamic_shape(self, *args, **kwargs):
        pass

    def set_optim_cache_dir(self, path: str):
        self._cache_dir = path

    def summary(self) -> str:
        return (f"Config(prefix={self._prefix}, device={self._device}, "
                f"ir_optim={self._switch_ir_optim})")
