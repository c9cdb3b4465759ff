"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout (``ops/``, ``models/``,
``inference/``) so every module has an obvious counterpart there; the
JAX package stays the numerics reference. Plain tensor code is PyTorch,
and every kernel the JAX package wrote in Pallas for the TPU is a
hand-written Hopper kernel here (``csrc/*.cu`` built with ``nvcc`` for
``sm_90a``, or Triton), each with a plain PyTorch version beside it.

Backend selection is by tensor device: an op given CPU tensors runs its
plain version, an op given CUDA tensors launches its kernel (or raises).
Entry points (the serving engine, the KV-cache manager) run on the card
unless the caller passes ``device="cpu"``.

Ported so far: the unified greedy serving path —
``inference.decoding.ContinuousBatchingEngine`` over
``models.llama.ragged_step``, with the RMSNorm forward and ragged paged
attention kernels.
"""

__version__ = "0.1.0"
