"""Continuous decode of n-digit utterances, with or without the silence model;
exact-sequence accuracy + CSV + confusion data (reference
scripts/project5_test_ndigits_no_sil.py / _with_sil.py / project5_test_1digit.py)."""
from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, exact_accuracy,
    load_config, load_corpus,
)

from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.reporting.csvnia import CSVWriter
from cs304_tpu_torch.reporting.metrics import corpus_wer
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--n-digits", type=int, default=7)
    parser.add_argument("--no-silence", action="store_true")
    parser.add_argument("--csv-out", default=None)
    parser.add_argument("--max-per-label", type=int, default=None)
    parser.add_argument("--known-count", action="store_true",
                        help="decode constrained to exactly --n-digits "
                             "words (word-count automaton composed with "
                             "the trellis) instead of relying on the "
                             "inter-word penalty to get the count right")
    parser.add_argument("--bigram-lm", action="store_true",
                        help="decode with a word-bigram LM trained on the "
                             "training split's transcripts (per-pair "
                             "inter-word penalties in the composite trellis)")
    parser.add_argument("--lm-weight", type=float, default=1.0)
    parser.add_argument("--beam", type=float, default=0.0,
                        help="per-frame beam pruning width in log-prob "
                             "units (0 = exact search); large-vocabulary "
                             "hypothesis control, ops/viterbi.py")
    parser.add_argument("--min-duration", type=int, default=0,
                        help="decode with per-state duration floors: every "
                             "word state must persist >= N frames "
                             "(ops/viterbi_duration.py; 0 = unconstrained)")
    args = parser.parse_args(argv)
    if args.min_duration and (args.known_count or args.bigram_lm):
        raise SystemExit("--min-duration cannot combine with --known-count "
                         "or --bigram-lm (separate trellis compositions)")
    if args.beam and (args.min_duration or args.known_count):
        raise SystemExit("--beam only applies to the unconstrained trellis "
                         "(the counted/duration kernels do not implement "
                         "the prune)")
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)
    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()
    if args.no_silence:
        models = {l: m for l, m in models.items() if l != "S"}
    bigram = None
    if args.bigram_lm:
        from cs304_tpu_torch.ops.lm import train_word_bigram

        with_sil = "S" in models
        vocab = set(models)
        all_transcripts = sorted(corpus.train_dataset.labels)
        # The LM vocabulary is closed over the loaded models; transcripts
        # mentioning words without a model cannot be counted.
        transcripts = [t for t in all_transcripts if set(t) <= vocab]
        if not transcripts:
            raise SystemExit(
                "--bigram-lm: no training transcript is fully covered by "
                f"the checkpoint vocabulary {sorted(vocab - {'S'})}"
            )
        bigram = train_word_bigram(
            transcripts, sorted(models), insert_silence=with_sil,
        )
        dropped = len(all_transcripts) - len(transcripts)
        print(f"bigram LM: {len(transcripts)} training transcripts"
              + (f" ({dropped} dropped: out-of-vocabulary words)"
                 if dropped else "")
              + f", vocab {sorted(models)}, lm_weight {args.lm_weight}")
    decoder = ContinuousDecoder(
        models, penalty=cfg.decode.word_penalty,
        bigram=bigram, lm_weight=args.lm_weight,
        beam=args.beam or None, device=args.device,
    )

    for split_name, dataset in (
        ("train", corpus.train_dataset),
        ("test", corpus.test_dataset),
    ):
        grouped = dataset.get_all_n_digits(args.n_digits)
        truths, clips = [], []
        for transcript, utts in grouped.items():
            if args.max_per_label:
                utts = utts[: args.max_per_label]
            for u in utts:
                truths.append(transcript)
                clips.append(u)
        if not truths:
            print(f"{split_name}: no {args.n_digits}-digit utterances")
            continue
        feats = mfcc_batch(clips, cfg=mcfg, device=args.device)
        if args.known_count:
            preds = decoder.predict_batch_counted(feats, args.n_digits)
        elif args.min_duration:
            preds = decoder.predict_batch_duration(
                feats, min_duration=args.min_duration
            )
        else:
            preds = decoder.predict_batch(feats)
        acc = exact_accuracy(truths, preds)
        print(f"{split_name} exact-sequence accuracy (n={args.n_digits}): {acc:.2%}")
        stats = corpus_wer([(list(t), list(p)) for t, p in zip(truths, preds)])
        print(
            f"{split_name} WER: {stats['wer']:.2%} "
            f"(sub {stats['substitutions']}, ins {stats['insertions']}, "
            f"del {stats['deletions']} / {stats['ref_words']} words)"
        )
        if args.csv_out:
            w = CSVWriter(["Ground Truth", "Predict"])
            for t, p in zip(truths, preds):
                w.add_line([t, p])
            w.write(f"{args.csv_out}.{split_name}.csv")


if __name__ == "__main__":
    run_main(main)
