"""``paddle_tpu_torch.onnx`` — the export surface, counterpart of
``paddle_tpu/onnx.py``. The reference's ``paddle.onnx.export`` wraps the
optional ``paddle2onnx`` package and raises without it; so does this
one, pointing at the port's own deployment format
(``paddle_tpu_torch.jit.save``, a ``torch.export`` program). There is no
bridge to ``torch.onnx``: the reference has no such path."""

from __future__ import annotations

__all__ = ["export"]


def export(layer, path: str, input_spec=None, opset_version: int = 9,
           **configs):
    """paddle.onnx.export: see the module docstring."""
    try:
        import paddle2onnx  # noqa: F401
    except ImportError:
        raise ImportError(
            "paddle.onnx.export needs the optional 'paddle2onnx' package "
            "(the reference has the same requirement), which is not "
            "installed here. For a portable deployment artifact use "
            "paddle_tpu_torch.jit.save(layer, path, input_spec=...), a "
            "torch.export program with its parameters.")
    raise NotImplementedError(
        "a paddle2onnx install was found, but no converter bridge for "
        "this framework exists; use paddle_tpu_torch.jit.save")
