"""Decode synthetic multi-digit audio built by concatenating single-digit clips
(reference scripts/project4_2digits.py / project4_phone.py — which naively
argmax whole clips with isolated models; we run both that and the proper
continuous decoder to show why continuous decoding is needed). Clips are
silence-stripped before concatenation so the synthetic utterance is continuous
speech (the reference's project5 evolution; raw lead/tail room tone between
concatenated takes is out of any trained silence model's domain)."""
from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, exact_accuracy,
    load_config, load_corpus,
)

import numpy as np

from cs304_tpu_torch.audio.endpointing import SignalSeparation
from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
from cs304_tpu_torch.models.collection import ModelCollection
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--n-digits", type=int, default=2)
    parser.add_argument("--num-samples", type=int, default=20)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)
    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)

    rng = np.random.default_rng(0)
    labels = list(DIGIT_LABELS)
    truths, clips = [], []
    train = corpus.train_dataset
    sep = SignalSeparation(
        sample_rate=int(cfg.frontend.sample_rate),
        frame_time=cfg.endpoint.frame_time,
        speech_high_threshold=cfg.endpoint.speech_high_threshold,
        speech_low_threshold=cfg.endpoint.speech_low_threshold,
        silence_duration_threshold=cfg.endpoint.silence_duration_threshold,
    )
    stripped = {l: sep.remove_empty(train[l][0]) for l in labels}
    for _ in range(args.num_samples):
        transcript = "".join(rng.choice(labels, size=args.n_digits))
        truths.append(transcript)
        clips.append(np.concatenate([stripped[l] for l in transcript]))
    feats = mfcc_batch(clips, cfg=cfg.frontend.mfcc_config(), device=args.device)

    # Naive whole-clip argmax (the reference project4 approach — fails by design).
    mc = ModelCollection.from_models([models[l] for l in labels], device=args.device)
    naive = mc.predict_batch(feats)
    naive_acc = exact_accuracy(truths, naive)

    # Proper continuous decoding: stripped concatenation is continuous speech,
    # so digit models only (the reference's no-silence setup, penalty -250 in
    # its scripts).
    digit_models = {l: models[l] for l in labels}
    decoder = ContinuousDecoder(digit_models, penalty=cfg.decode.word_penalty,
                                device=args.device)
    continuous = decoder.predict_batch(feats)
    cont_acc = exact_accuracy(truths, continuous)
    print(f"naive isolated argmax exact-match: {naive_acc:.2%}")
    print(f"continuous decoder exact-match:    {cont_acc:.2%}")


if __name__ == "__main__":
    run_main(main)
