from .batching import PaddedBatch, make_signals, pad_batch, round_up
from .synthetic import SyntheticTIDigits
from .ti_digits import DIGIT_LABELS, DataLoader

__all__ = [
    "DIGIT_LABELS", "DataLoader", "PaddedBatch", "SyntheticTIDigits",
    "make_signals", "pad_batch", "round_up",
]
