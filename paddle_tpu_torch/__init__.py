"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout (``core/``, ``ops/``,
``models/``, ``nn/``, ``incubate/``, ``optimizer/``, ``inference/``,
``serving/``, ``observability/``) so every module has an obvious
counterpart there; the JAX package stays the numerics reference. Plain
tensor code is PyTorch, and every kernel the JAX package wrote in Pallas
for the TPU is a hand-written Hopper kernel here (``csrc/*.cu`` built
with ``nvcc`` for ``sm_90a``, or Triton), each with a plain PyTorch
version beside it.

Backend selection is by tensor device: an op given CPU tensors runs its
plain version, an op given CUDA tensors launches its kernel (or raises).
Entry points run on the card unless the caller passes ``device="cpu"``;
the Paddle-shaped surface makes its tensors on the current place, the
card unless ``set_device("cpu")``.

The top level is the Paddle surface of ``paddle_tpu/__init__.py``:
``Tensor``/``Parameter``, places and dtypes, the math, extra and
schema-generated ops, creation and the random stream (``seed``),
``grad``, ``set_flags``/``get_flags``, ``save``/``load`` and
``in_dynamic_mode``. It loads on first use (``_surface``), so ``import
paddle_tpu_torch`` by itself imports nothing of torch and touches no
card. Names of later slices (``vision``, ``linalg``, ...) raise
``NotImplementedError``.

Ported so far:

- serving: the continuous-batching engine on the unified ragged step
  and on the legacy paged pipeline, the prefix cache (``kvcache``),
  sampling, grammars and speculative decoding, the generate engines,
  the scheduler, the fleet router with failover and roles, multi-host
  serving, and the observability stack (metrics, timelines, flight
  recorder, journal and replay, sensors, federation);
- training: the one-device Llama step, packed ERNIE/BERT MLM with fp32
  master weights, main-grad training, GPT on the fused decoder stack,
  the optimizer families, schedulers, clipping and loss scaling;
- checkpoints and resilient training: ``distributed.checkpoint`` (the
  reference's layout, async saves, ``TrainState``), ``save``/``load``,
  ``resilience`` (durable checkpoints, ``ResilientTrainer``), the
  ``nn.Layer`` base and ``io`` (datasets, samplers, ``DataLoader``);
- the Paddle-shaped eager surface: ``core`` (Tensor, dispatcher with
  its AMP cast hook and nan/inf scan, autograd, the op tables),
  ``creation``, ``random``, ``flags``, ``device``, ``autograd``
  (``PyLayer``, ``jacobian``), ``amp.auto_cast`` and
  ``amp.debugging``; the Tensor-level ``nn.functional``, ``ops`` and
  ``incubate.nn.functional`` entries dispatch through it;
- ``nn`` whole (the layers, ``ParamAttr`` and the initializers drawing
  from the key stream, ``functional``, the Transformer family, the
  recurrent layers, beam-search decoding, ``utils``), ``metric`` and the
  high-level API (``Model``, ``summary``, ``hapi``, ``callbacks``);
- compiled programs: ``jit`` (``to_static``, dy2static, ``TrainStep``,
  bucketing, ``save``/``load`` as ``torch.export`` programs, the fusion
  pass), ``static`` and the inference ``Config``/``Predictor``; a
  compiled program is a CUDA graph per input signature on the card.
"""

__version__ = "0.1.0"

_static_mode = [False]


def in_dynamic_mode() -> bool:
    """True unless enable_static() was called. Execution stays eager
    either way: the flag is a mode query for gated user code."""
    return not _static_mode[0]


def enable_static():
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def device_count() -> int:
    import torch
    return torch.cuda.device_count()


#: subpackages and modules of the port, imported on first use
_SUBMODULES = frozenset((
    "amp", "autograd", "callbacks", "core", "creation", "device",
    "distributed", "flags", "framework", "hapi", "incubate", "inference",
    "io", "jit", "kvcache", "metric", "models", "nn", "observability",
    "ops", "optimizer", "profiler", "random", "regularizer", "resilience",
    "serving", "static", "testing",
))

#: names of ``paddle_tpu``'s top level that later slices of the port bring
_LATER = {}
for _n in ("vision", "parallel", "quantization", "linalg",
           "fft", "sparse", "distribution", "signal", "audio", "text",
           "utils", "onnx", "geometric", "version", "hub"):
    _LATER.setdefault(_n, f"long tail ({_n})")


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LATER:
        from .ops._common import not_ported
        raise not_ported(f"paddle_tpu_torch.{name}", _LATER[name])
    surface = importlib.import_module("._surface", __name__)
    g = globals()
    if "Tensor" not in g:
        g.update({k: v for k, v in vars(surface).items()
                  if not k.startswith("__") and k not in _SUBMODULES})
    if name in g:
        return g[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
