"""PyTorch + CUDA port of cs304_tpu for one NVIDIA H100.

The batched continuous decoder (raw audio -> 39-dim MFCC -> full-covariance
Gaussian emissions -> composite Viterbi -> word labels), online serving,
embedded Viterbi and Baum-Welch training (fused, and the legacy
per-transcript oracle), GMMs, the decoder's searches, isolated-word
classification, forced alignment, MAP adaptation, template DTW and the
phone tiers (a lexicon over shared phones, biphones, triphones, tied
triphones and senones, trained and decoded through the same trainer and
decoder) run on tensors. Every kernel the JAX package wrote in Pallas, and the
trellis scans it left to XLA on the hot paths, is hand-written CUDA C++
under ``csrc/`` (the emission kernels, the scan-free team kernel's decode,
stream, sentence and search modes, the dense trellis, the forward-backward
and its E-step, the DTW column recursion), built with nvcc at first use. CPU tensors take each
kernel's plain PyTorch version. The project scripts run as
``python -m cs304_tpu_torch.scripts.<name>`` (``scripts/``), beside the
typed config, profiling, the reference-compatible names (``compat``) and
the reporting tools.

Data parallelism (``parallel/``: ``make_mesh``, ``dp_kmeans_step``,
``dp_composite_decode``, and ``mesh=`` on the trainers and the serving pools)
runs over ``torch.distributed`` ranks, one process each.

This package imports neither ``jax`` nor ``cs304_tpu``; the JAX package is
the reference it is tested against. Its top-level names are the JAX
package's, and ``fp32_exact`` and ``resolve_device`` besides; they resolve
lazily (PEP 562).
"""
import importlib as _importlib

from .device import fp32_exact, resolve_device

# Public name -> defining submodule, resolved on first access.
_EXPORTS = {
    "MFCCConfig": ".ops.mfcc",
    "mfcc_features": ".ops.mfcc",
    "mfcc_batch": ".ops.mfcc",
    "GaussianParams": ".ops.gaussian",
    "gaussian_log_pdf": ".ops.gaussian",
    "make_gaussian_params": ".ops.gaussian",
    "viterbi_banded": ".ops.viterbi",
    "viterbi_composite": ".ops.viterbi",
    "WordHMM": ".models.hmm",
    "CompositeHMM": ".models.hmm",
    "stack_word_models": ".models.hmm",
    "train_word_hmm": ".models.train_kmeans",
    "SegmentalKMeansConfig": ".models.train_kmeans",
    "ContinuousDecoder": ".models.decoder",
    "WordDFA": ".ops.grammar",
    "BatchedStreamingComposite": ".ops.streaming_batch",
    "ServingSessionPool": ".serving",
    "UtteranceResult": ".serving",
    "ForcedAligner": ".models.align",
    "map_adapt": ".models.adapt",
    "self_adapt": ".models.adapt",
    "AlignResult": ".models.align",
    "WordSegment": ".models.align",
    "ModelCollection": ".models.collection",
    "ContinuousTrainer": ".models.train_continuous",
    "insert_silence": ".models.train_continuous",
    "TIDigits": ".data.ti_digits",
    "DataLoader": ".data.ti_digits",
    "TI_DIGITS_LABELS": ".data.ti_digits",
    "SyntheticTIDigits": ".data.synthetic",
    "pad_batch": ".data.batching",
    "SignalSeparation": ".audio.endpointing",
    "Segmentation": ".audio.capture",
    "CSVReader": ".reporting.csvnia",
    "CSVWriter": ".reporting.csvnia",
    "plot_confusion_matrix_from_lists": ".reporting.visualizer",
    "plot_line": ".reporting.visualizer",
    "confusion_matrix": ".reporting.visualizer",
    "DTWRecognizer": ".ops.dtw",
    "forward_backward": ".ops.forward_backward",
    "forward_log_likelihood": ".ops.forward_backward",
    "GMMWordHMM": ".models.gmm_hmm",
    "train_gmm_hmm": ".models.gmm_hmm",
    "train_gmm_hmm_baum_welch": ".models.gmm_hmm",
    "Lattice": ".ops.lattice",
    "nbest_lattice": ".ops.lattice",
    "forward_lattice": ".ops.lattice",
    "word_confidences": ".ops.lattice",
    "word_confidences_batch": ".ops.lattice",
    "spot_keyword": ".ops.lattice",
    "consensus_decode": ".ops.lattice",
    "viterbi_composite_counted": ".ops.viterbi_counted",
    "word_occupancy_posteriors": ".ops.lattice",
    "word_end_log_posteriors": ".ops.lattice",
    "WordBigram": ".ops.lm",
    "train_word_bigram": ".ops.lm",
    "rescore_nbest": ".ops.lm",
    "wer": ".reporting.metrics",
    "corpus_wer": ".reporting.metrics",
    "edit_ops": ".reporting.metrics",
    "GMMContinuousTrainer": ".models.train_continuous_gmm",
    "GMMContinuousTrainConfig": ".models.train_continuous_gmm",
    "promote_to_gmm": ".models.train_continuous_gmm",
    "Lexicon": ".models.lexicon",
    "compose_word_models": ".models.lexicon",
    "uniform_phone_boot": ".models.lexicon",
    "train_phone_models": ".models.lexicon",
    "train_biphone_models": ".models.biphone",
    "compose_word_models_biphone": ".models.biphone",
    "biphone_lexicon": ".models.biphone",
    "train_triphone_models": ".models.triphone",
    "compose_word_models_triphone": ".models.triphone",
    "triphone_lexicon": ".models.triphone",
    "make_word_corpus": ".data.wordvocab",
    "make_lexicon": ".data.wordvocab",
    "save_models": ".utils.checkpoint",
    "load_models": ".utils.checkpoint",
    "save_model": ".utils.checkpoint",
    "load_model": ".utils.checkpoint",
    "Config": ".utils.config",
    "sentence_hmm": ".models.hmm",
    "plot_spectrogram": ".reporting.spectrograms",
    "plot_mel_spectrogram": ".reporting.spectrograms",
    "plot_mfcc": ".reporting.spectrograms",
    "nbest_decode": ".ops.nbest",
    "StreamingComposite": ".ops.streaming",
    "StreamingMFCC": ".ops.streaming_mfcc",
    "make_mesh": ".parallel.data_parallel",
    "dp_kmeans_step": ".parallel.data_parallel",
    "dp_composite_decode": ".parallel.data_parallel",
}


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(_importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted([*_EXPORTS, "fp32_exact", "resolve_device"])
