"""Serving-session demo: continuous raw-audio feeds -> endpointed utterance
transcripts, many sessions at once (cs304_tpu_torch/serving.py).

Each simulated "microphone" carries several utterances separated by silence;
the pool endpoints them online, streams partials while speech is live, and
emits offline-parity finals at each endpoint.

(no reference equivalent — the reference's live loop blocks on one mic,
scripts/project6_interactive.py:16-39 there)
"""
from cs304_tpu_torch.scripts._common import (
    adopt_checkpoint_frontend, base_parser, load_config, run_main,
)

import numpy as np

from cs304_tpu_torch.serving import ServingSessionPool
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--chunk-ms", type=float, default=100.0)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)

    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

    corpus = SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                               takes_per_digit=3)
    sr = 16000

    def silence(seconds, seed):
        return np.random.default_rng(seed).normal(
            0, 20.0, int(seconds * sr)
        ).astype(np.float32)

    plans = {0: ["375", "12"], 1: ["186Z"], 2: ["54321", "9O2"]}
    audio = {}
    for mic, transcripts in plans.items():
        pieces = [silence(0.3, mic)]
        for i, tr in enumerate(transcripts):
            pieces.append(corpus.sentence_audio(tr, mic, jitter_seed=i))
            pieces.append(silence(0.5, mic * 7 + i))
        audio[mic] = np.concatenate(pieces)

    pool = ServingSessionPool(
        models, penalty=cfg.decode.word_penalty,
        mcfg=cfg.frontend.mfcc_config(), num_slots=8, device=args.device,
    )
    sessions = {mic: pool.open() for mic in plans}
    chunk = int(args.chunk_ms / 1000 * sr)
    cursors = {mic: 0 for mic in plans}
    t = 0.0
    while any(cursors[m] < len(audio[m]) for m in plans):
        step = {}
        for mic in plans:
            if cursors[mic] < len(audio[mic]):
                step[sessions[mic]] = audio[mic][
                    cursors[mic] : cursors[mic] + chunk
                ]
                cursors[mic] += chunk
        done = pool.feed(step)
        t += args.chunk_ms / 1000
        live = pool.partials()  # ONE dispatch for every session's partial
        for mic in plans:
            for r in done.get(sessions[mic], []):
                print(f"t={t:5.2f}s  mic {mic}: FINAL {r.text!r} "
                      f"({r.num_samples / sr:.2f}s; last partial "
                      f"{r.last_partial!r})")
            p = live.get(sessions[mic], "")
            if p:
                print(f"t={t:5.2f}s  mic {mic}: partial {p!r}")
    print("\nexpected:", {m: plans[m] for m in plans})


if __name__ == "__main__":
    run_main(main)
