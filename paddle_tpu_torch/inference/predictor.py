"""Predictor: run a loaded inference program through named IO handles —
counterpart of ``paddle_tpu/inference/predictor.py`` (the reference's
AnalysisPredictor + ZeroCopyTensor): ``get_input_handle(name).
copy_from_cpu(arr); predictor.run(); out = get_output_handle(name).
copy_to_cpu()``.

The program (``jit.load``) runs on the Config's device: on the card as
one CUDA graph per input signature (``jit.ProgramCache``; the first run
of a signature captures it), on the CPU eagerly. Outputs stay on the
device until ``copy_to_cpu``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..jit import CompileGuard, ProgramCache
from ..jit.save_load import TranslatedLayer, load as _jit_load
from .config import Config


class IOTensor:
    """ZeroCopyTensor parity handle."""

    def __init__(self, name: str):
        self.name = name
        self._value = None

    def copy_from_cpu(self, arr) -> None:
        self._value = np.ascontiguousarray(arr)

    def share_external_data(self, arr) -> None:
        self._value = arr  # no copy: a torch tensor or an array

    def reshape(self, shape) -> None:
        if self._value is not None:
            self._value = self._value.reshape(tuple(shape))

    def copy_to_cpu(self):
        v = self._value
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v

    def shape(self):
        return None if self._value is None else tuple(self._value.shape)


class Predictor:
    def __init__(self, config: Config,
                 program: Optional[TranslatedLayer] = None):
        self._config = config
        self._program = (program or _jit_load(config._prefix)).to(
            config.torch_device())
        n_in = len(self._program.input_spec)
        self._input_names = [f"x{i}" for i in range(n_in)]
        self._inputs: Dict[str, IOTensor] = {
            n: IOTensor(n) for n in self._input_names}
        self._output_names: List[str] = []
        self._outputs: Dict[str, IOTensor] = {}
        self.guard = CompileGuard("Predictor.run")
        self.programs = ProgramCache("Predictor.run")

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> IOTensor:
        return self._inputs[name]

    def run(self, inputs: Optional[List] = None):
        """Execute. Either feed via handles then ``run()``, or pass arrays
        directly (the newer reference API) and get arrays back."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(np.asarray(a))
        args = [self._inputs[n]._value for n in self._input_names]
        if any(a is None for a in args):
            missing = [n for n in self._input_names
                       if self._inputs[n]._value is None]
            raise ValueError(f"inputs not set: {missing}")
        dev = self._program.device
        xs = [(a if isinstance(a, torch.Tensor)
               else torch.from_numpy(np.array(a))).to(dev) for a in args]
        self.guard.check(tuple(xs))
        out = self.programs.run(self.guard.signature(tuple(xs)),
                                self._program.run_tensors, xs, dev)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        self._output_names = [f"out{i}" for i in range(len(outs))]
        self._outputs = {}
        for n, o in zip(self._output_names, outs):
            h = IOTensor(n)
            h._value = o
            self._outputs[n] = h
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs.values()]
        return True

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_output_handle(self, name: str) -> IOTensor:
        return self._outputs[name]

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
