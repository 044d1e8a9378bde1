"""Batch transcription: decode WAV files (or a directory) to a CSV/stdout.

The operational front door to the serving stack: bucketed batch decoding
with optional per-word posterior confidences, word timings, word-count or
grammar constraints, and a bigram LM. (The reference has no batch tool —
its eval scripts are corpus-specific.)

Examples:
  python -m cs304_tpu_torch.scripts.transcribe --checkpoint-dir .cache/m6 --wav-dir recordings/
  python -m cs304_tpu_torch.scripts.transcribe --checkpoint-dir .cache/m6 --wav a.wav \
      --confidence --timings --csv-out out.csv
"""
import glob
import os
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    adopt_checkpoint_frontend, base_parser, load_config, run_main,
)

from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--wav", action="append", default=[],
                        help="WAV file to transcribe (repeatable)")
    parser.add_argument("--wav-dir", default=None,
                        help="transcribe every *.wav under this directory")
    parser.add_argument("--csv-out", default=None,
                        help="write results as pipe-CSV")
    parser.add_argument("--confidence", action="store_true",
                        help="per-utterance min word posterior")
    parser.add_argument("--timings", action="store_true",
                        help="include per-word start/end seconds (from the "
                             "decode-confidence pass)")
    parser.add_argument("--known-count", type=int, default=None,
                        metavar="N", help="decode exactly N digits")
    parser.add_argument("--grammar-strings", default=None, metavar="A,B,...",
                        help="constrain to this finite transcript set "
                             "(mutually exclusive with --known-count and "
                             "--confidence/--timings, which use the "
                             "unconstrained trellis)")
    parser.add_argument("--beam", type=float, default=0.0,
                        help="per-frame beam pruning width (0 = exact "
                             "search); large-vocabulary hypothesis control")
    parser.add_argument("--min-duration", type=int, default=0, metavar="N",
                        help="every word state must persist >= N frames "
                             "(duration-constrained trellis; 0 = off; "
                             "mutually exclusive with the other "
                             "constrained modes)")
    parser.add_argument("--lexicon", default=None, metavar="FILE",
                        help="pronunciation lexicon JSON: treat the "
                             "checkpoint as PHONE models (train_phones.py) "
                             "and compose each lexicon word from its "
                             "phones — words added to the lexicon after "
                             "training decode too (OOV support)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--fast", action="store_true",
                        help="large-vocabulary fast mode: quad-form "
                             "emissions at 3-pass precision — measured "
                             "exact-accuracy parity with transcript "
                             "agreement 1.0 on the 100-word gated corpus "
                             "(benchmarks/scale_vocab.py)")
    args = parser.parse_args(argv)
    cfg = load_config(args)
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()

    paths = list(args.wav)
    if args.wav_dir:
        paths += sorted(glob.glob(os.path.join(args.wav_dir, "**", "*.wav"),
                                  recursive=True))
    if not paths:
        raise SystemExit("error: no input — pass --wav and/or --wav-dir")

    constraint_flags = (args.known_count is not None) + bool(
        args.grammar_strings
    ) + bool(args.min_duration)
    if constraint_flags > 1:
        raise SystemExit(
            "error: --known-count, --grammar-strings and --min-duration "
            "are mutually exclusive"
        )
    if constraint_flags and args.beam:
        raise SystemExit(
            "error: --beam only applies to the unconstrained trellis — the "
            "counted/grammar/duration kernels do not implement the prune; "
            "drop one of the flags"
        )
    if constraint_flags and (args.confidence or args.timings):
        raise SystemExit(
            "error: --confidence/--timings decode the unconstrained trellis "
            "and would silently drop --known-count/--grammar-strings — "
            "pick one mode"
        )
    models = load_models(cfg.checkpoint_dir)
    if args.lexicon:
        from cs304_tpu_torch.models.biphone import compose_from_checkpoint

        lex, models, unit_desc = compose_from_checkpoint(args.lexicon,
                                                         models)
        print(f"composed {len(lex.words)} words from "
              f"{len(lex.phones)} phones"
              + (f" + {unit_desc}" if unit_desc else ""))
    decoder = ContinuousDecoder(
        models, penalty=cfg.decode.word_penalty,
        beam=args.beam or None,
        emissions="quad" if args.fast else "whiten",
        emission_precision="high" if args.fast else "highest",
        device=args.device,
    )
    grammar = None
    if args.grammar_strings:
        from cs304_tpu_torch.ops.grammar import WordDFA

        grammar = WordDFA.from_strings(
            [s.strip() for s in args.grammar_strings.split(",") if s.strip()],
            decoder.composite.labels,
        )

    from cs304_tpu_torch.audio.wav import read_wav

    rows = []
    for start in range(0, len(paths), args.batch_size):
        chunk = paths[start : start + args.batch_size]
        feats, hops_s = [], []
        for p in chunk:
            rate, signal = read_wav(p)
            feats.append(
                mfcc_batch([signal], cfg=replace(mcfg, sample_rate=float(rate)),
                           device=args.device)[0]
            )
            # Frame hop in seconds at THIS file's rate (a fixed 16 kHz hop_s
            # halved every timing on 8 kHz files).
            hops_s.append(mcfg.hop_length / float(rate))
        if args.confidence or args.timings:
            scored = decoder.predict_batch_with_confidence(feats)
            for p, words, hop_s in zip(chunk, scored, hops_s):
                text = "".join(w for w, _s, _e, _c in words)
                conf = min((c for _w, _s, _e, c in words), default=0.0)
                timing = ";".join(
                    f"{w}:{s * hop_s:.2f}-{e * hop_s:.2f}"
                    for w, s, e, _c in words
                ) if args.timings else ""
                rows.append([p, text, f"{conf:.3f}", timing])
        elif args.known_count is not None:
            for p, text in zip(
                chunk, decoder.predict_batch_counted(feats, args.known_count)
            ):
                rows.append([p, text, "", ""])
        elif grammar is not None:
            for p, text in zip(
                chunk, decoder.predict_batch_grammar(feats, grammar)
            ):
                rows.append([p, text, "", ""])
        elif args.min_duration:
            for p, text in zip(
                chunk,
                decoder.predict_batch_duration(
                    feats, min_duration=args.min_duration
                ),
            ):
                rows.append([p, text, "", ""])
        else:
            for p, text in zip(chunk, decoder.predict_batch(feats)):
                rows.append([p, text, "", ""])

    for row in rows:
        extras = "  ".join(c for c in row[2:] if c)
        print(f"{row[0]}: {row[1]}" + (f"  [{extras}]" if extras else ""))
    if args.csv_out:
        from cs304_tpu_torch.reporting.csvnia import CSVWriter

        writer = CSVWriter(["wav", "text", "confidence", "timings"])
        for row in rows:
            writer.add_line(row)
        writer.write(args.csv_out)


if __name__ == "__main__":
    run_main(main)
