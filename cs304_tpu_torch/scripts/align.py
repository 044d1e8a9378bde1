"""Forced alignment CLI: word/state timings of known transcripts.

Exposes the alignment the embedded trainer computes internally (reference
hidden_markov_model.py:584-664) as a user tool: feed WAVs + transcripts
against a trained checkpoint, get per-word start/end times (and optionally
per-state runs), printable or as pipe-CSV.

Examples:
  python -m cs304_tpu_torch.scripts.align --checkpoint-dir .cache/model --wav a.wav --transcript 375
  python -m cs304_tpu_torch.scripts.align --checkpoint-dir .cache/model \
      --wav a.wav --transcript 375 --wav b.wav --transcript 186Z \
      --csv-out alignments.csv --states
"""
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    adopt_checkpoint_frontend, base_parser, load_config, run_main,
)

from cs304_tpu_torch.models.align import ForcedAligner
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--wav", action="append", default=[], required=True,
                        help="WAV file to align (repeatable)")
    parser.add_argument("--transcript", action="append", default=[],
                        required=True,
                        help="digit transcript for the matching --wav "
                             "(repeatable, same order)")
    parser.add_argument("--no-silence", action="store_true",
                        help="do not interleave the silence model")
    parser.add_argument("--cross-word", choices=("exit_only", "band"),
                        default="exit_only")
    parser.add_argument("--states", action="store_true",
                        help="also print per-state frame runs")
    parser.add_argument("--include-silence", action="store_true",
                        help="include silence segments in the output")
    parser.add_argument("--csv-out", default=None,
                        help="write segments as pipe-CSV to this file")
    parser.add_argument("--lexicon", default=None, metavar="FILE",
                        help="pronunciation lexicon JSON: the checkpoint "
                             "holds PHONE models (train_phones.py) and the "
                             "transcripts are WORDS (comma-separated for "
                             "multi-char labels) — output segments are "
                             "PHONE-level timings")
    args = parser.parse_args(argv)
    if len(args.wav) != len(args.transcript):
        raise SystemExit("error: need one --transcript per --wav")
    cfg = load_config(args)
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()

    models = load_models(cfg.checkpoint_dir)
    lex = None
    expand_lex = None
    if args.lexicon:
        from cs304_tpu_torch.models.biphone import load_unit_table

        lex, unit_lex, table, desc = load_unit_table(args.lexicon, models)
        expand_lex = lex
        align_models = models
        if table is not None:
            # Context-dependent alignment: expand through the derived
            # unit lexicon (biphone or triphone) and align against the
            # unit models (unseen contexts back off down the chain) —
            # segment names carry the context ("pA-pB", "pA-pB+pC"),
            # i.e. phone timings with context labels.
            expand_lex = unit_lex
            align_models = table
            print(f"context-dependent alignment: {desc}")
        # Transcripts are pre-expanded to phone sequences (silence between
        # words only), so the aligner must not interleave silence again.
        aligner = ForcedAligner(
            align_models, insert_sil=False, cross_word=args.cross_word,
            device=args.device,
        )
    else:
        aligner = ForcedAligner(
            models, insert_sil=not args.no_silence, cross_word=args.cross_word,
            device=args.device,
        )

    rows = []
    from cs304_tpu_torch.audio.wav import read_wav

    for wav_path, transcript in zip(args.wav, args.transcript):
        rate, signal = read_wav(wav_path)
        feats = mfcc_batch(
            [signal], cfg=replace(mcfg, sample_rate=float(rate)),
            device=args.device,
        )
        if lex is not None:
            # Comma-split ALWAYS (a single comma-free multi-char word is a
            # one-word transcript, not characters to iterate).
            words = tuple(w for w in transcript.split(",") if w)
            unknown = [w for w in words if w not in lex]
            if not words or unknown:
                raise SystemExit(
                    f"error: transcript {transcript!r}: "
                    + (f"unknown lexicon words {unknown}" if unknown
                       else "no words")
                    + f" — lexicon has {len(lex.words)} words"
                )
            aligned_transcript = expand_lex.expand_transcript(
                words, insert_silence=not args.no_silence
            )
        else:
            aligned_transcript = transcript
        res = aligner.align(feats[0], aligned_transcript)
        print(f"{wav_path}  transcript={transcript}  "
              f"score={res.score:.2f}  frames={res.num_frames}")
        for w in res.word_segments(include_silence=args.include_silence):
            print(f"  {w.word:>2}  {w.start_s:7.3f}s – {w.end_s:7.3f}s  "
                  f"(frames {w.start_frame}–{w.end_frame})")
            if args.states:
                for s in w.states:
                    print(f"       state {s.state}: frames "
                          f"{s.start_frame}–{s.end_frame}")
            rows.append([wav_path, transcript, w.word, w.position,
                         w.start_frame, w.end_frame,
                         f"{w.start_s:.3f}", f"{w.end_s:.3f}"])

    if args.csv_out:
        from cs304_tpu_torch.reporting.csvnia import CSVWriter

        writer = CSVWriter(["wav", "transcript", "word", "position",
                            "start_frame", "end_frame", "start_s", "end_s"])
        for row in rows:
            writer.add_line(row)
        writer.write(args.csv_out)  # logs "wrote N rows to <path>"


if __name__ == "__main__":
    run_main(main)
