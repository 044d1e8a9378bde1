"""The port's copied host-side data modules against cs304_tpu's: the
synthetic corpus (bitwise the same audio), the endpointer (the same speech
and noise clips; the port runs the JAX package's Python fallback, which its
native tier matches byte for byte) and the one DIGIT_LABELS."""
import numpy as np

from cs304_tpu.audio.endpointing import SignalSeparation as JSep
from cs304_tpu.data.synthetic import SyntheticTIDigits as JCorpus
from cs304_tpu.data.ti_digits import DIGIT_LABELS as J_DIGIT_LABELS
from cs304_tpu_torch.audio.endpointing import SignalSeparation
from cs304_tpu_torch.data import DIGIT_LABELS, SyntheticTIDigits, batching, ti_digits


def test_one_digit_labels():
    assert DIGIT_LABELS is ti_digits.DIGIT_LABELS is batching.DIGIT_LABELS
    assert DIGIT_LABELS == J_DIGIT_LABELS


def test_synthetic_corpus_and_endpointing_match_jax():
    kw = dict(num_train_speakers=1, num_test_speakers=1, takes_per_digit=1)
    want, got = JCorpus(**kw), SyntheticTIDigits(**kw)
    for label in DIGIT_LABELS:
        for w, g in zip(want.train_dataset[label], got.train_dataset[label]):
            np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(want.sentence_audio("4Z2", 0, jitter_seed=2),
                                  got.sentence_audio("4Z2", 0, jitter_seed=2))
    clips = [c for label in DIGIT_LABELS for c in got.train_dataset[label]]
    clips.append(np.zeros(1600, np.float32))  # never ends: skipped by both
    j_sep, t_sep = JSep(), SignalSeparation()
    w_speech, g_speech = j_sep.remove_empty_batch(clips), t_sep.remove_empty_batch(clips)
    assert len(g_speech) == len(w_speech) == len(DIGIT_LABELS)
    for w, g in zip(w_speech, g_speech):
        np.testing.assert_array_equal(w, g)
    w_noise, g_noise = j_sep.get_all_noises(), t_sep.get_all_noises()
    assert len(g_noise) == len(w_noise) > 0
    for w, g in zip(w_noise, g_noise):
        np.testing.assert_array_equal(w, g)
