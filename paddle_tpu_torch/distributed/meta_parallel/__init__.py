"""Counterpart of ``paddle_tpu/distributed/meta_parallel``: the
tensor-parallel layers at mp degree 1 and the per-group RNG tracker.
The mp-group collectives, ``ParallelCrossEntropy``, the pipeline layers
and engines and ``HybridParallelModel`` come with the Fleet
hybrid-training slice."""

from .random_state import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)

_MP_LAYERS = ("ColumnParallelLinear", "RowParallelLinear",
              "VocabParallelEmbedding")


def __getattr__(name):
    # the layers load on first use: ``mp_layers`` imports ``nn``, whose
    # import chain reaches ``models.llama``, which imports ``mp_layers``
    if name in _MP_LAYERS:
        from . import mp_layers
        return getattr(mp_layers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
