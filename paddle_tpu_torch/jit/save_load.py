"""``paddle.jit.save/load`` parity: serialized inference programs —
counterpart of ``paddle_tpu/jit/save_load.py``.

The reference writes its program as StableHLO through ``jax.export``,
which the port cannot read. The port writes a ``torch.export``
``ExportedProgram`` in ``<path>.pdmodel``, the parameters in
``<path>.pdiparams.npz`` under the reference's ``p::<name>`` /
``b::<name>`` keys, and the same ``<path>.json`` metadata (input shapes
and dtypes, the format). An ``InputSpec``'s ``None`` dimensions become
1, as in the reference.

The forwards of kernel rows 1, 5 and 8 are exported as the port's
custom ops (``paddle_tpu_torch::rms_norm``, ``::flash_attention_fwd``,
``::layer_norm``; ``ops._common.exporting``), so a loaded program on
the card launches the kernels (and counts their launches), and on the
CPU runs their plain versions.

The ``.pdiparams.npz`` crosses in both directions: a loaded program
takes its parameters from it. A ``.pdmodel`` of the reference raises
and names its format.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.host_arrays import BFLOAT16
from ..core.tensor import Tensor
from ..ops._common import exporting
from .functional import tree_unwrap, tree_wrap

from ..static import InputSpec  # noqa: E402  (re-export parity)

#: the ``format`` of the port's metadata (the reference writes
#: ``"stablehlo+npz"``)
FORMAT = "torch.export+npz"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _example(spec, device) -> torch.Tensor:
    """A zero tensor of the spec's shape and dtype on ``device``."""
    if isinstance(spec, InputSpec):
        shape = tuple(1 if d is None or int(d) < 0 else int(d)
                      for d in spec.shape)
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    v = spec._value if isinstance(spec, Tensor) else spec
    if not isinstance(v, torch.Tensor):
        v = Tensor(np.asarray(v))._value
    return torch.zeros(v.shape, dtype=v.dtype, device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()


def _from_host(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BFLOAT16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


class _Forward(torch.nn.Module):
    """The exported module: the layer's forward over torch tensors."""

    def __init__(self, layer, fn):
        super().__init__()
        self.m = layer
        self._fn = fn

    def forward(self, *xs):
        return tree_unwrap(self._fn(*tree_wrap(list(xs))))


def save(layer, path: str, input_spec: Optional[List] = None,
         **config) -> None:
    """Serialize ``layer``'s forward (eval mode) as a ``torch.export``
    program + parameters, traced at ``input_spec`` (InputSpecs or example
    tensors/arrays) on the layer's device. A forward wrapped by
    ``to_static`` is exported from the function it wraps."""
    from ..nn.layer import Layer
    from . import StaticFunction, _layer_device
    if not isinstance(layer, Layer):
        raise TypeError("jit.save expects an nn.Layer")
    if not input_spec:
        raise ValueError("jit.save requires input_spec (shapes to trace)")
    layer.eval()
    fwd = layer.forward
    if isinstance(fwd, StaticFunction):
        fwd = fwd._orig_fn
    device = _layer_device(layer) or torch.device("cpu")
    xs = tuple(_example(s, device) for s in input_spec)
    with torch.no_grad(), exporting():
        ep = torch.export.export(_Forward(layer, fwd), xs, strict=False)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    np.savez(path + ".pdiparams",
             **{f"p::{k}": _host(v) for k, v in layer.named_parameters()},
             **{f"b::{k}": _host(v) for k, v in layer.named_buffers()
                if v is not None})
    meta = {
        "inputs": [{"shape": list(x.shape), "dtype": _dtype_name(x.dtype)}
                   for x in xs],
        "outputs": len(ep.graph_signature.user_outputs),
        "format": FORMAT,
        "version": 1,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _retarget(gm: torch.fx.GraphModule, device: torch.device) -> None:
    """Move a loaded program's tensors (its parameters, buffers and the
    constants it holds as plain attributes) and the device its graph's
    factory ops name to ``device``: a replay then copies nothing from
    the host."""
    gm.to(device)
    for mod in gm.modules():
        for name, val in list(vars(mod).items()):
            if isinstance(val, torch.Tensor) and \
                    not isinstance(val, torch.nn.Parameter) and \
                    val.device != device:
                setattr(mod, name, val.to(device))
    changed = False
    for node in gm.graph.nodes:
        dev = node.kwargs.get("device")
        if isinstance(dev, torch.device) and dev != device:
            node.kwargs = {**node.kwargs, "device": device}
            changed = True
    if changed:
        gm.recompile()


class TranslatedLayer:
    """A loaded inference program (parity: ``paddle.jit.TranslatedLayer``).
    Calls run the program eagerly on its device (the Predictor runs it
    as a CUDA graph per input signature)."""

    def __init__(self, exported, params: Dict[str, Any],
                 buffers: Dict[str, Any], meta: Dict[str, Any]):
        self._exported = exported
        self._params = params
        self._buffers = buffers
        self._meta = meta
        self._module = exported.module()
        state = {f"m.{k}": _from_host(v) for k, v in params.items()}
        state.update({f"m.{k}": _from_host(v) for k, v in buffers.items()})
        own = self._module.state_dict()
        with torch.no_grad():
            for k, v in state.items():
                if k in own:
                    own[k].copy_(v.to(own[k].dtype))
        self.device = next(iter(own.values())).device if own \
            else torch.device("cpu")

    @property
    def input_spec(self) -> List[InputSpec]:
        return [InputSpec(m["shape"], m["dtype"]) for m in self._meta["inputs"]]

    @property
    def n_outputs(self) -> int:
        return int(self._meta.get(
            "outputs", len(self._exported.graph_signature.user_outputs)))

    def to(self, device) -> "TranslatedLayer":
        device = torch.device(device)
        _retarget(self._module, device)
        self.device = device
        return self

    def run_tensors(self, *xs: torch.Tensor):
        """The program over torch tensors on its device."""
        with torch.no_grad():
            return self._module(*xs)

    def __call__(self, *args):
        xs = []
        for a in args:
            v = a._value if isinstance(a, Tensor) else a
            if not isinstance(v, torch.Tensor):
                v = Tensor(np.asarray(v))._value
            xs.append(v.to(self.device))
        out = self.run_tensors(*xs)
        if isinstance(out, (tuple, list)):
            return tuple(Tensor._wrap(o, True) for o in out)
        return Tensor._wrap(out, True)

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is an inference program")


def load(path: str) -> TranslatedLayer:
    """Load a program :func:`save` wrote. A program of the reference
    (StableHLO) raises, naming its format."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path}.pdmodel is a {meta.get('format')!r} program (the JAX "
            f"package's jax.export StableHLO); paddle_tpu_torch.jit.load "
            f"reads {FORMAT!r} programs written by paddle_tpu_torch.jit.save. "
            f"Its parameters ({path}.pdiparams.npz) load into a port layer "
            "by name (p::<name>).")
    with open(path + ".pdmodel", "rb") as f:
        exported = torch.export.load(io.BytesIO(f.read()))
    data = np.load(path + ".pdiparams.npz")
    params = {k[3:]: data[k] for k in data.files if k.startswith("p::")}
    buffers = {k[3:]: data[k] for k in data.files if k.startswith("b::")}
    return TranslatedLayer(exported, params, buffers, meta)
