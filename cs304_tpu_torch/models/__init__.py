from .adapt import map_adapt, self_adapt
from .align import AlignResult, ForcedAligner, StateSegment, WordSegment
from .collection import ModelCollection
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
from .stacking import StackedModels, enrollment_batches, stack_models
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
    "DEFAULT_WORD_PENALTY", "AlignResult", "CompositeHMM", "ContinuousDecoder",
    "ContinuousTrainConfig", "ContinuousTrainer", "ForcedAligner",
    "HMMTrainMeanFail", "ModelCollection", "SegmentalKMeansConfig",
    "StackedModels", "StateSegment", "TrainResult", "WordHMM", "WordSegment",
    "composite_from_arrays", "enrollment_batches", "flagship_composite",
    "flagship_models", "from_numpy_models", "insert_silence", "map_adapt",
    "self_adapt", "stack_models", "stack_word_models", "train_digit_models",
    "train_digit_models_batched", "train_word_hmm", "uniform_forward_log_a",
]
