from .batching import DIGIT_LABELS, PaddedBatch, make_signals, pad_batch

__all__ = ["DIGIT_LABELS", "PaddedBatch", "make_signals", "pad_batch"]
