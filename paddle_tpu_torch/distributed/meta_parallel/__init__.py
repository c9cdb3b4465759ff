"""Counterpart of ``paddle_tpu/distributed/meta_parallel``: the
tensor-parallel layers over an mp group, the per-group RNG tracker, the
pipeline layers and engines, and ``HybridParallelModel``."""

from .random_state import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)

_LAZY = {
    "mp_layers": ("ColumnParallelLinear", "RowParallelLinear",
                  "VocabParallelEmbedding", "ParallelCrossEntropy",
                  "mark_as_sequence_parallel_parameter",
                  "mp_all_gather_last_dim", "mp_all_reduce"),
    "pp_layers": ("LayerDesc", "SharedLayerDesc", "PipelineLayer"),
    "pipeline_parallel": ("PipelineParallel",
                          "PipelineParallelWithInterleave"),
    "parallel_wrapper": ("HybridParallelModel",),
}


def __getattr__(name):
    # these load on first use: ``mp_layers`` imports ``nn``, whose import
    # chain reaches ``models.llama``, which imports ``mp_layers``
    import importlib
    for mod, names in _LAZY.items():
        if name in names:
            return getattr(importlib.import_module(f"{__name__}.{mod}"),
                           name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
