"""Serving engines, their compiled programs, the decoding options and
the deployment API (``Config``, ``create_predictor``; counterpart of
``paddle_tpu/inference``)."""

from .decoding import (  # noqa: F401
    ContinuousBatchingEngine, GenerationConfig, GenerationEngine, KVCache,
    PagedGenerationEngine, llama_engine,
)
from .speculative import (  # noqa: F401
    Drafter, DraftModel, NgramDrafter, SpeculationTelemetry,
)
from . import sampling  # noqa: F401
from . import constrain  # noqa: F401
from .sampling import SamplerConfig  # noqa: F401
from .constrain import (  # noqa: F401
    GrammarArena, TokenDFA, compile_regex, json_grammar, json_regex,
)


def __getattr__(name):
    # the deployment API (``Config``, ``create_predictor``) loads on first
    # use: the predictor imports ``jit``, which imports this package
    if name == "Config":
        from .config import Config
        return Config
    if name in ("Predictor", "create_predictor"):
        from . import predictor
        return getattr(predictor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
