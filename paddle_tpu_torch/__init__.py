"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout (``ops/``, ``models/``,
``nn/``, ``incubate/``, ``optimizer/``, ``inference/``) so every module
has an obvious counterpart there; the JAX package stays the numerics
reference. Plain tensor code is PyTorch,
and every kernel the JAX package wrote in Pallas for the TPU is a
hand-written Hopper kernel here (``csrc/*.cu`` built with ``nvcc`` for
``sm_90a``, or Triton), each with a plain PyTorch version beside it.

Backend selection is by tensor device: an op given CPU tensors runs its
plain version, an op given CUDA tensors launches its kernel (or raises).
Entry points (the serving engine, the KV-cache manager) run on the card
unless the caller passes ``device="cpu"``.

Ported so far:

- the unified greedy serving path —
  ``inference.decoding.ContinuousBatchingEngine`` over
  ``models.llama.ragged_step``, with the RMSNorm forward and ragged
  paged attention kernels;
- the legacy paged serving pipeline — ``ContinuousBatchingEngine(
  unified=False)`` and ``PagedGenerationEngine`` over
  ``models.llama.prefill_paged`` / ``prefill_paged_suffix`` /
  ``decode_step_paged``, with the paged decode attention kernel — and
  the prefix cache (``kvcache``) on both pipelines;
- the decoding options on those engines — per-request sampling
  (``inference.sampling`` over ``inference.prng``, the JAX package's
  threefry bits), grammar-constrained decoding (``inference.constrain``)
  and speculative decoding (``inference.speculative``);
- the one-device Llama training step — ``models.llama.build_train_step``
  (forward, backward with full remat, AdamW) over
  ``models.llama.forward_stacked``, with the RMSNorm forward and
  backward and the flash attention forward, dQ and dK/dV kernels;
- packed ERNIE/BERT MLM pretraining — ``models.ernie.build_mlm_train_step``
  (forward, backward, AdamW with fp32 master weights) over
  ``models.ernie.ErnieForMaskedLM``, with the LayerNorm forward and
  backward kernels and segment ids in the flash attention kernels.
"""

__version__ = "0.1.0"
