"""``paddle_tpu_torch.nn.quant`` — the reference's quant-op namespace
(``paddle_tpu/nn/quant.py``): ``weight_only_linear``,
``weight_quantize``, ``weight_dequantize`` and ``WeightOnlyLinear``, which
live in :mod:`paddle_tpu_torch.quantization`."""

from ..quantization import (  # noqa: F401
    WeightOnlyLinear, weight_dequantize, weight_only_linear,
    weight_quantize,
)

__all__ = ["weight_only_linear", "weight_quantize", "weight_dequantize",
           "WeightOnlyLinear"]
