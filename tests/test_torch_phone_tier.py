"""The phone-tier slice end to end, the port against the JAX package on the
CPU, and the port's WER metrics (cs304_tpu_torch/reporting/metrics.py).

benchmarks/phone_tier.py's flow at tests/test_torch_lexicon.py's mini size:
the flat-start phone boot with the silence model, the tied phone tier, the
senone tier (decision-tree state tying, retrained with state and transition
ties), every lexicon word composed by both packages (the held-out OOV word
included), and held-out-speaker sentences decoded in-vocabulary and with the
OOV word. The same features and the same silence model go through both.

Tolerances: trained phone models within rtol 1e-4 / atol 1e-5 of JAX's with
the same iteration count (the senone tier's training is held so in
tests/test_torch_senone.py); decoded transcripts of both tiers and the OOV
corpus WER equal JAX's. Every tier of the port (word,
phone, biphone, triphone, tied triphone, senone) runs end to end on the CPU
and decodes the same transcripts again from its checkpoint. The metrics
(edit operations, alignment, WER, corpus WER) equal JAX's exactly.
"""
import numpy as np
import pytest

import cs304_tpu.models.lexicon as jlx
import cs304_tpu.models.senone as jsn
import cs304_tpu.reporting.metrics as jmet
from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig
import cs304_tpu_torch.models.lexicon as plx
import cs304_tpu_torch.models.senone as psn
import cs304_tpu_torch.reporting.metrics as pmet
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from test_torch_lexicon import (
    ITERATIONS,
    assert_models_close,
    jax_lexicon,
    mini_corpus,
    to_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PENALTY = -100.0


def eval_sets():
    """(in-vocab truths, features), (OOV truths, features): two-word
    sentences of the held-out speaker, as phone_tier.py draws them."""
    corpus, _lex, train_words, oov, *_ = mini_corpus()
    rng = np.random.default_rng(6)
    spk = 2  # the test speaker
    sets = []
    for k, make in enumerate((lambda: tuple(str(x) for x in rng.choice(train_words, size=2)),
                              lambda: (oov[0], str(rng.choice(train_words))))):
        truths, clips = [], []
        for j in range(4):
            tr = make()
            truths.append("".join(tr))
            clips.append(corpus.sentence_audio(tr, spk, jitter_seed=200 + 100 * k + j))
        sets.append((truths, mfcc_batch(clips, device="cpu")))
    return sets


def wer_pairs(truths, preds):
    return [([t[i:i + 3] for i in range(0, len(t), 3)], [p[i:i + 3] for i in range(0, len(p), 3)])
            for t, p in zip(truths, preds)]


def test_phone_and_senone_tiers_match_jax_end_to_end():
    _c, lex, _tw, oov, stripped, _raw, labeled, silence = mini_corpus()
    jlex = jax_lexicon(lex)
    cfg = dict(max_iterations=ITERATIONS, cov_reg=0.1)
    # Phone tier: the flat-start boot (bitwise, test_torch_lexicon.py) and
    # the tied training.
    boot = plx.uniform_phone_boot(stripped, lex)
    boot["S"] = silence
    phones, n_p = plx.train_phone_models(boot, labeled, lex, ContinuousTrainConfig(**cfg),
                                         device="cpu")
    jboot = jlx.uniform_phone_boot(stripped, jlex)
    jboot["S"] = to_jax({"S": silence})["S"]
    jphones, n_j = jlx.train_phone_models(jboot, labeled, jlex, JConfig(**cfg))
    assert n_p == n_j
    assert_models_close(phones, jphones)
    # Senone tier on the port's phones (its training against JAX's:
    # test_torch_senone.py), composed by both packages.
    sen, tying, _ = psn.train_senone_models(phones, labeled, lex, max_per_state=2,
                                            config=ContinuousTrainConfig(**cfg), device="cpu")
    jtying = jsn.SenoneTying(classes=tying.classes, trees=tying.trees,
                             num_states=tying.num_states, senone_of=tying.senone_of)
    tiers = {
        "phone": (plx.compose_word_models(lex, phones),
                  jlx.compose_word_models(jlex, jphones)),
        "senone": (psn.compose_word_models_senone(lex, sen, tying, phones),
                   jsn.compose_word_models_senone(jlex, to_jax(sen), jtying, to_jax(phones))),
    }
    # Both sets in one batch: JAX compiles its decode once a shape.
    (iv_truths, iv_feats), (oov_truths, oov_feats) = eval_sets()
    for name, (ours, theirs) in tiers.items():
        assert oov[0] in ours and oov[0] in theirs
        preds = ContinuousDecoder(ours, penalty=PENALTY, device="cpu").predict_batch(
            iv_feats + oov_feats)
        assert preds == JDecoder(theirs, penalty=PENALTY).predict_batch(iv_feats + oov_feats)
        pairs = wer_pairs(oov_truths, preds[len(iv_truths):])
        assert pmet.corpus_wer(pairs) == jmet.corpus_wer(pairs)


def test_every_port_tier_runs_and_decodes_from_its_checkpoint(tmp_path):
    """The word tier and the five phone tiers on the CPU at the mini size:
    train, compose every lexicon word, decode both evaluation sets; saved
    with the port's save_models and loaded through compose_from_checkpoint,
    each phone tier decodes the same transcripts."""
    from cs304_tpu_torch.models.biphone import (
        compose_from_checkpoint,
        compose_word_models_biphone,
        train_biphone_models,
    )
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainer
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_digit_models
    from cs304_tpu_torch.models.triphone import (
        compose_word_models_triphone,
        tie_and_train_triphones,
        train_triphone_models,
    )
    from cs304_tpu_torch.utils.checkpoint import load_models, save_models

    _c, lex, _tw, _oov, stripped, _raw, labeled, silence = mini_corpus()
    cfg = ContinuousTrainConfig(max_iterations=1, cov_reg=0.1)
    words = train_digit_models(stripped, SegmentalKMeansConfig(
        num_states=5, max_iterations=3, length_multiple=32), device="cpu")
    words["S"] = silence
    wt = ContinuousTrainer(words, cfg, device="cpu")
    wt.train(labeled)
    boot = plx.uniform_phone_boot(stripped, lex)
    boot["S"] = silence
    phones, _ = plx.train_phone_models(boot, labeled, lex, cfg, device="cpu")
    bi, _ = train_biphone_models(phones, labeled, lex, cfg, device="cpu")
    tri, _ = train_triphone_models(phones, labeled, lex, cfg, device="cpu")
    tied, tied_lex, _ = tie_and_train_triphones(phones, labeled, lex, max_per_phone=2,
                                                config=cfg, device="cpu")
    sen, tying, _ = psn.train_senone_models(phones, labeled, lex, max_per_state=2, config=cfg,
                                            device="cpu")
    composed = {
        "phone": plx.compose_word_models(lex, phones),
        "biphone": compose_word_models_biphone(lex, bi, phones),
        "triphone": compose_word_models_triphone(lex, tri, phones, biphone_models=bi),
        "tied_triphone": plx.compose_word_models(tied_lex, tied),
        "senone": psn.compose_word_models_senone(lex, sen, tying, phones),
    }
    sets = eval_sets()
    word_dec = ContinuousDecoder(wt.models(), penalty=PENALTY, device="cpu")
    assert all(isinstance(p, str) for p in word_dec.predict_batch(sets[0][1]))

    root = str(tmp_path)
    save_models(phones, root, tier="monophones")
    lex.save(f"{root}/lexicon.json")
    save_models(bi, f"{root}/biphones", tier="biphones")
    save_models(tri, f"{root}/triphones", tier="triphones")
    sen_root = str(tmp_path / "sen")
    save_models(phones, sen_root, tier="monophones")
    lex.save(f"{sen_root}/lexicon.json")
    save_models(sen, f"{sen_root}/senones", tier="senones")
    tying.save(f"{sen_root}/senones/senone_tying.json")
    save_models(tied, f"{root}/tied", tier="tied_triphones")
    tied_lex.save(f"{root}/tied/lexicon.json")
    from_disk = {"triphone": root, "senone": sen_root, "tied_triphone": f"{root}/tied"}
    for name, models in composed.items():
        assert set(lex.words) <= set(models) and "S" in models, name
        dec = ContinuousDecoder(models, penalty=PENALTY, device="cpu")
        preds = [dec.predict_batch(feats) for _truths, feats in sets]
        assert all(len(p) == 4 and all(isinstance(x, str) for x in p) for p in preds)
        if name in from_disk:
            folder = from_disk[name]
            _lex, loaded, desc = compose_from_checkpoint(f"{folder}/lexicon.json",
                                                         load_models(folder))
            assert (desc == "") == (name == "tied_triphone")
            dec2 = ContinuousDecoder(loaded, penalty=PENALTY, device="cpu")
            assert [dec2.predict_batch(feats) for _t, feats in sets] == preds, name


@pytest.mark.parametrize("seed", range(6))
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    vocab = ["bab", "bad", "baf", "bag"]
    pairs = []
    for _ in range(8):
        ref = [str(x) for x in rng.choice(vocab, size=int(rng.integers(0, 5)))]
        hyp = [str(x) for x in rng.choice(vocab, size=int(rng.integers(0, 5)))]
        pairs.append((ref, hyp))
        assert pmet.align(ref, hyp) == jmet.align(ref, hyp)
        ops, jops = pmet.edit_ops(ref, hyp), jmet.edit_ops(ref, hyp)
        assert (ops.substitutions, ops.insertions, ops.deletions, ops.total) == \
            (jops.substitutions, jops.insertions, jops.deletions, jops.total)
        assert pmet.wer(ref, hyp) == jmet.wer(ref, hyp)
    assert pmet.corpus_wer(pairs) == jmet.corpus_wer(pairs)
