from .decoder import ContinuousDecoder
from .hmm import (
    DEFAULT_WORD_PENALTY,
    CompositeHMM,
    WordHMM,
    composite_from_arrays,
    flagship_composite,
    flagship_models,
    from_numpy_models,
    stack_word_models,
    uniform_forward_log_a,
)

__all__ = [
    "DEFAULT_WORD_PENALTY", "CompositeHMM", "ContinuousDecoder", "WordHMM",
    "composite_from_arrays", "flagship_composite", "flagship_models",
    "from_numpy_models", "stack_word_models", "uniform_forward_log_a",
]
