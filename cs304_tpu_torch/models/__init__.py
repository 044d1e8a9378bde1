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
from .stacking import StackedModels, stack_models
from .train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
    HMMTrainMeanFail,
    insert_silence,
)
from .train_kmeans import (
    SegmentalKMeansConfig,
    TrainResult,
    train_digit_models,
    train_digit_models_batched,
    train_word_hmm,
)

__all__ = [
    "DEFAULT_WORD_PENALTY", "CompositeHMM", "ContinuousDecoder",
    "ContinuousTrainConfig", "ContinuousTrainer", "HMMTrainMeanFail",
    "SegmentalKMeansConfig", "StackedModels", "TrainResult", "WordHMM",
    "composite_from_arrays", "flagship_composite", "flagship_models",
    "from_numpy_models", "insert_silence", "stack_models", "stack_word_models",
    "train_digit_models", "train_digit_models_batched", "train_word_hmm",
    "uniform_forward_log_a",
]
