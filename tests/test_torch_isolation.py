"""cs304_tpu_torch stands alone: it imports neither jax nor cs304_tpu.

A fresh interpreter blocks both (``sys.modules[name] = None`` makes any
import of them raise), imports every module of the port, runs a tiny CPU
decode through the raw-audio entry point, a GMM decode and the Baum-Welch
sentence forward-backward, and feeds two sessions of a ServingSessionPool
through one utterance each; then the search slice: a bigram + beam decode,
n-best, posterior confidences, the counted, duration and grammar decodes, a
lattice rescored with a bigram, and a bigram and a confidences serving pool;
then slice 4b: an isolated-word classification, a forced alignment, one
legacy (fused=False) training iteration, MAP adaptation, a DTW search, the
associative-scan decode and the "high" MFCC tier; then the phone tiers: a
generated lexicon, a senone tier trained and decoded, its WER; then the
command line (the walk imports cs304_tpu_torch.scripts.* and the config,
profiling, compat and reporting modules): a checkpoint saved, a WAV written
and transcribed through the transcribe script's main with --device cpu, the
typed config and the compat layer's MFCC; then data parallelism: a word
model trained and a batch decoded over a 1-rank CPU mesh.
"""
import os
import subprocess
import sys

_CODE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cs304_tpu"] = None
import numpy as np
import cs304_tpu_torch
for mod in pkgutil.walk_packages(cs304_tpu_torch.__path__, "cs304_tpu_torch."):
    importlib.import_module(mod.name)
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.models import ContinuousDecoder, flagship_models
dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                        backend="scanfree", device="cpu")
out = dec.predict_signal_batch(list(make_signals(2, 0.5)))
assert len(out) == 2 and all(isinstance(s, str) for s in out), out
import torch
from cs304_tpu_torch.models.train_continuous_gmm import promote_to_gmm
from cs304_tpu_torch.models.train_fused import _banded_fb_batch
gmm = promote_to_gmm({m.label: m for m in flagship_models()}, 2)
gdec = ContinuousDecoder(gmm, penalty=-100.0, emissions="quad", device="cpu")
assert len(gdec.predict_signal_batch(list(make_signals(2, 0.5)))) == 2
la, lb, ll = _banded_fb_batch(torch.zeros(2, 6, 5), *(torch.zeros(2, 5),) * 3,
                              torch.tensor([6, 3]), torch.tensor([5, 5]))
assert la.shape == lb.shape == (2, 6, 5) and torch.isfinite(ll).all()
from cs304_tpu_torch.serving import ServingSessionPool
pool = ServingSessionPool(flagship_models(), num_slots=2, max_frames=256, device="cpu")
rng = np.random.default_rng(0)
quiet = lambda n: rng.normal(0, 20.0, n).astype(np.float32)
loud = rng.normal(0, 2000.0, 8000).astype(np.float32)
sessions = [pool.open(), pool.open()]
done = {}
for piece in (quiet(1600), loud, quiet(8000)):
    for s, rs in pool.feed({s: piece for s in sessions}).items():
        done.setdefault(s, []).extend(rs)
    pool.partials(sessions)
assert sorted(done) == sessions and all(len(rs) == 1 for rs in done.values()), done
from cs304_tpu_torch.ops import (grammar, lattice, lm, nbest, rescore, viterbi_counted,
                                 viterbi_duration)
labels = dec.composite.labels
bg = lm.train_word_bigram(["12", "375", "4Z"], labels)
feats = [rng.normal(size=(40, 39)).astype(np.float32) for _ in range(2)]
sdec = ContinuousDecoder(flagship_models(), bigram=bg, beam=80.0, device="cpu")
assert len(sdec.predict_batch(feats)) == 2
assert dec.predict_nbest(feats[0], n=2)
assert len(dec.predict_batch_with_confidence(feats)) == 2
for texts in (dec.predict_batch_counted(feats, 2), dec.predict_batch_duration(feats, 2),
              dec.predict_batch_grammar(feats, grammar.WordDFA.exact_count(2, labels))):
    assert len(texts) == 2
lat = lattice.forward_lattice(dec.composite, feats[0], beam=1e4, device="cpu")
assert rescore.lattice_rescore(dec.composite, lat, features=feats[0], bigram=bg,
                               device="cpu")[1] is not None
lm_pool = ServingSessionPool(flagship_models(), num_slots=2, max_frames=256, bigram=bg,
                             device="cpu")
conf_pool = ServingSessionPool(flagship_models(), num_slots=2, max_frames=256,
                               confidences=True, device="cpu")
for p in (lm_pool, conf_pool):
    s = p.open()
    got = [r for piece in (quiet(1600), loud, quiet(8000)) for r in p.feed({s: piece}).get(s, [])]
    assert len(got) == 1, got
assert got[0].confidence is not None
from cs304_tpu_torch.models import (ContinuousTrainConfig, ContinuousTrainer, ForcedAligner,
                                    ModelCollection, map_adapt)
from cs304_tpu_torch.ops.dtw import DTWRecognizer
from cs304_tpu_torch.ops.mfcc import MFCCConfig, mfcc_batch
from cs304_tpu_torch.ops.viterbi_assoc import viterbi_composite_assoc
words = {m.label: m for m in flagship_models()}
coll = ModelCollection.from_models([m for m in flagship_models() if m.label != "S"],
                                   device="cpu")
assert coll.predict(feats[0]) in coll.labels
enroll = {"12": [feats[0]], "4": [feats[1]]}
res = ForcedAligner(words, device="cpu").align_batch(enroll["12"], "12")
assert res[0].num_frames == 40
legacy = ContinuousTrainer(words, ContinuousTrainConfig(fused=False, max_iterations=1,
                                                        silence_bootstrap=False),
                           device="cpu")
assert legacy.train(enroll) == 1
assert set(map_adapt(words, enroll, device="cpu")) == set(words)
rec = DTWRecognizer.from_features([feats[0][:10], feats[1][:12]], device="cpu")
assert rec.search(feats[1][:12])[0] == 1
c = dec.composite
lb = torch.as_tensor(rng.normal(size=(40, c.num_states)).astype(np.float32))
score, path = viterbi_composite_assoc(lb, c.log_a, c.lower_of_state, c.is_entry,
                                      c.is_exit, c.penalty)
assert path.shape == (40,)
assert mfcc_batch(list(make_signals(1, 0.5)), cfg=MFCCConfig(precision="high"),
                  device="cpu")[0].shape[1] == 39
from cs304_tpu_torch.data.wordvocab import make_lexicon
from cs304_tpu_torch.models import lexicon, senone
from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu_torch.reporting.metrics import corpus_wer
assert make_lexicon(6, phones_per_word=(2, 3), num_phones=6).words[0] == "bab"
def phone(label, center):
    means = np.array([[center, st, 0.0] for st in range(3)], np.float32)
    return WordHMM(label=label, means=means, log_a=uniform_forward_log_a(3),
                   covariances=np.tile(np.eye(3, dtype=np.float32) * 0.2, (3, 1, 1)))
def utt(centers):
    f = np.asarray([[c, st, 0.0] for c in centers for st in range(3) for _ in range(3)],
                   np.float32)
    return f + rng.normal(0, 0.05, f.shape).astype(np.float32)
plex = lexicon.Lexicon({"xa": ("pX", "pA"), "xc": ("pX", "pC")})
boot = {"pX": phone("pX", 6.0), "pA": phone("pA", 0.0), "pC": phone("pC", 3.0),
        "S": phone("S", -12.0)}
plabeled = {("xa",): [utt((-12, 4, 0, -12)) for _ in range(3)],
            ("xc",): [utt((-12, 8, 3, -12)) for _ in range(3)]}
units, tying, _ = senone.train_senone_models(
    boot, plabeled, plex, min_count=2.0,
    config=ContinuousTrainConfig(max_iterations=1, length_multiple=32), device="cpu")
pdec = ContinuousDecoder(senone.compose_word_models_senone(plex, units, tying, boot),
                         penalty=-5.0, device="cpu")
assert corpus_wer([(["xa"], [pdec.predict(utt((-12, 4, 0, -12)))])])["ref_words"] == 1
import contextlib, io, os, tempfile
from cs304_tpu_torch import Config, compat
from cs304_tpu_torch.audio.wav import write_wav_int16
from cs304_tpu_torch.scripts import transcribe
from cs304_tpu_torch.utils.checkpoint import save_models
assert Config().frontend.mfcc_config().n_mfcc == 13
assert compat.MFCC(make_signals(1, 0.5)[0], 16000, device="cpu").feature_vector.shape[0] == 39
with tempfile.TemporaryDirectory() as tmp:
    save_models(flagship_models(), os.path.join(tmp, "ckpt"))
    write_wav_int16(os.path.join(tmp, "a.wav"), make_signals(1, 0.5)[0], 16000)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        transcribe.main(["--checkpoint-dir", os.path.join(tmp, "ckpt"), "--device", "cpu",
                         "--wav", os.path.join(tmp, "a.wav"),
                         "--log-file", os.path.join(tmp, "rt.log")])
    assert out.getvalue().startswith(os.path.join(tmp, "a.wav") + ": "), out.getvalue()
import torch.distributed as dist
from cs304_tpu_torch import dp_composite_decode, make_mesh
from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm
mesh = make_mesh(device_type="cpu")
word = train_word_hmm("xa", [utt((4, 0, 8)) for _ in range(3)],
                      SegmentalKMeansConfig(num_states=3, max_iterations=2, length_multiple=8),
                      mesh=mesh)
c = dec.composite
scores, paths = dp_composite_decode(c.means, c.covariances, c.log_a, c.lower_of_state,
                                    c.is_entry, c.is_exit, c.penalty,
                                    np.zeros((2, 5, 39), np.float32), np.array([5, 3]), mesh)
assert np.isnan(word.final_score) and paths.shape == (2, 5), (word, paths.shape)
dist.destroy_process_group()
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith(("jax.", "cs304_tpu.")))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_port_imports_no_jax_and_decodes():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CODE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout
