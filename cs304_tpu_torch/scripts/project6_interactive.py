"""Mic -> endpoint -> MFCC -> continuous decode with silence (reference
scripts/project6_interactive.py). Requires sounddevice; --wav decodes a file
instead of capturing (works everywhere)."""
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, load_config,
)

from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import load_models


def _build_grammar(args, labels):
    """--grammar-strings / --grammar-pattern -> WordDFA (or None)."""
    if args.grammar_strings and args.grammar_pattern:
        raise ValueError(
            "use --grammar-strings OR --grammar-pattern, not both"
        )
    from cs304_tpu_torch.ops.grammar import WordDFA

    if args.grammar_strings:
        return WordDFA.from_strings(
            [s.strip() for s in args.grammar_strings.split(",") if s.strip()],
            labels,
        )
    if args.grammar_pattern:
        digits = tuple(l for l in labels if l != "S")
        sets = [
            digits if pos == "*" else tuple(pos)
            for pos in args.grammar_pattern.split(":")
        ]
        return WordDFA.from_positions(sets, labels)
    return None


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--wav", default=None, help="decode this WAV instead of the mic")
    parser.add_argument("--nbest", type=int, default=1,
                        help="print the N best hypotheses with scores")
    parser.add_argument("--confidence", action="store_true",
                        help="print per-word posterior confidences "
                             "(sum-semiring forward/backward over the "
                             "composite trellis)")
    parser.add_argument("--spot", default=None, metavar="WORD",
                        help="posterior keyword spotting: report where "
                             "this vocabulary word occurs (with "
                             "--spot-threshold)")
    parser.add_argument("--spot-threshold", type=float, default=0.5)
    parser.add_argument("--lattice-dot", default=None, metavar="FILE",
                        help="also write a word lattice as Graphviz DOT")
    parser.add_argument("--lattice-method", choices=("forward", "nbest"),
                        default="forward",
                        help="forward: true lattice generation over all "
                             "word-end hypotheses in --lattice-beam; "
                             "nbest: arcs from the n-best paths only")
    parser.add_argument("--lattice-beam", type=float, default=50.0,
                        help="score beam (nats below the best path) for "
                             "--lattice-method forward")
    parser.add_argument("--rescore-lm", default=None, metavar="FILE",
                        help="second-pass lattice rescoring: train a "
                             "word-bigram LM from the transcripts in FILE "
                             "(one per line, e.g. '375') and rescore the "
                             "forward lattice (--lattice-beam) with it")
    parser.add_argument("--lm-order", type=int, default=2, choices=(2, 3),
                        help="--rescore-lm model order: 2 = bigram lattice "
                             "rescoring (first-pass-compatible measure), "
                             "3 = trigram (two words of history in the "
                             "lattice DP — the standard second pass)")
    parser.add_argument("--lm-weight", type=float, default=1.0,
                        help="LM weight for --rescore-lm")
    parser.add_argument("--consensus-net", action="store_true",
                        help="confusion-network ('sausage') decoding: print "
                             "the slots with word posteriors and the "
                             "per-slot MBR decode")
    parser.add_argument("--grammar-strings", default=None, metavar="A,B,...",
                        help="constrain decoding to this finite transcript "
                             "set (comma-separated), e.g. '375,186Z' — the "
                             "trellis composed with a trie DFA")
    parser.add_argument("--grammar-pattern", default=None, metavar="P1:P2:...",
                        help="constrain decoding to a fixed-length pattern: "
                             "colon-separated per-position alphabets, '*' = "
                             "any digit, e.g. '12:*:Z' (position 0 in {1,2}, "
                             "any, then Z)")
    parser.add_argument("--high", type=float, default=128.0)
    parser.add_argument("--low", type=float, default=16.0)
    parser.add_argument("--silence-duration", type=float, default=0.2)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    decoder = ContinuousDecoder(
        load_models(cfg.checkpoint_dir), penalty=cfg.decode.word_penalty,
        device=args.device,
    )
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()

    if args.wav:
        from cs304_tpu_torch.audio.wav import read_wav

        rate, signal = read_wav(args.wav)
        feats = mfcc_batch([signal], cfg=replace(mcfg, sample_rate=float(rate)),
                           device=args.device)
        grammar = _build_grammar(args, decoder.composite.labels)
        if grammar is not None:
            print("decoded:",
                  decoder.predict_batch_grammar(feats, grammar)[0])
        elif args.nbest > 1:
            for score, text in decoder.predict_nbest(feats[0], n=args.nbest):
                print(f"{score:12.2f}  {text}")
        else:
            print("decoded:", decoder.predict(feats[0]))
        log_b = None
        if decoder._gmm is not None and (
            args.confidence or args.lattice_dot or args.spot
            or args.rescore_lm or args.consensus_net
        ):
            import torch

            from cs304_tpu_torch.ops.gaussian import gmm_log_pdf, make_gmm_params

            means, covs, weights = decoder._gmm
            log_b = gmm_log_pdf(
                make_gmm_params(means, covs, weights, device=args.device),
                torch.as_tensor(feats[0], device=args.device),
            )
        if args.confidence:
            from cs304_tpu_torch.ops.lattice import word_confidences

            for label, st, en, conf in word_confidences(
                decoder.composite, feats[0], log_b=log_b, device=args.device
            ):
                print(f"  {label}  frames [{st:4d},{en:4d})  "
                      f"confidence {conf:.3f}")
        if args.spot:
            from cs304_tpu_torch.ops.lattice import spot_keyword

            hits = spot_keyword(
                decoder.composite, feats[0], args.spot,
                threshold=args.spot_threshold, log_b=log_b, device=args.device,
            )
            if not hits:
                print(f"keyword {args.spot!r}: no occurrences above "
                      f"posterior {args.spot_threshold}")
            for st, en, p in sorted(hits):
                print(f"  {args.spot}  frames [{st:4d},{en:4d})  "
                      f"posterior {p:.3f}")
        if args.lattice_dot:
            from cs304_tpu_torch.ops.lattice import forward_lattice, nbest_lattice

            if args.lattice_method == "forward":
                lat = forward_lattice(
                    decoder.composite, feats[0], beam=args.lattice_beam,
                    log_b=log_b, device=args.device,
                )
            else:
                lat = nbest_lattice(
                    decoder.composite, feats[0], n=max(args.nbest, 8),
                    log_b=log_b, device=args.device,
                )
            with open(args.lattice_dot, "w") as f:
                f.write(lat.to_dot())
            print(f"lattice: {len(lat.arcs)} arcs -> {args.lattice_dot}")
        if args.rescore_lm:
            from cs304_tpu_torch.ops.lattice import forward_lattice
            from cs304_tpu_torch.ops.lm import train_word_bigram
            from cs304_tpu_torch.ops.rescore import lattice_rescore

            with open(args.rescore_lm) as f:
                transcripts = [ln.strip() for ln in f if ln.strip()]
            vocab = set(decoder.composite.labels)
            bad = [(i + 1, t) for i, t in enumerate(transcripts)
                   if not set(t) <= vocab]
            if bad:
                line_no, t = bad[0]
                raise SystemExit(
                    f"error: {args.rescore_lm}:{line_no}: transcript "
                    f"{t!r} uses words outside the decode vocabulary "
                    f"{sorted(vocab)} ({len(bad)} bad line(s))"
                )
            lat = forward_lattice(
                decoder.composite, feats[0], beam=args.lattice_beam,
                log_b=log_b, device=args.device,
            )
            if args.lm_order == 3:
                from cs304_tpu_torch.ops.lm import train_word_trigram
                from cs304_tpu_torch.ops.rescore import lattice_rescore_trigram

                trigram = train_word_trigram(
                    transcripts, labels=decoder.composite.labels
                )
                score, text, _arcs = lattice_rescore_trigram(
                    decoder.composite, lat, trigram, features=feats[0],
                    log_b=log_b, lm_weight=args.lm_weight, device=args.device,
                )
            else:
                bigram = train_word_bigram(
                    transcripts, labels=decoder.composite.labels
                )
                score, text, _arcs = lattice_rescore(
                    decoder.composite, lat, features=feats[0], log_b=log_b,
                    bigram=bigram, lm_weight=args.lm_weight,
                    device=args.device,
                )
            print(f"rescored: {text}  (score {score:.2f}, "
                  f"{len(lat.arcs)} arcs, order {args.lm_order}, "
                  f"lm_weight {args.lm_weight})")
        if args.consensus_net:
            from cs304_tpu_torch.ops.rescore import cn_decode, confusion_network

            slots = confusion_network(
                decoder.composite, feats[0], beam=args.lattice_beam,
                log_b=log_b, device=args.device,
            )
            for s in slots:
                hyps = ", ".join(
                    f"{w}:{p:.3f}"
                    for w, p in sorted(s.hyps.items(), key=lambda kv: -kv[1])
                )
                eps = s.eps()
                if eps > 1e-3:
                    hyps += f", eps:{eps:.3f}"
                print(f"  slot [{s.start:4d},{s.end:4d})  {hyps}")
            print("consensus-net:", cn_decode(slots))
        return

    from cs304_tpu_torch.audio.capture import Segmentation

    seg = Segmentation.from_basic(
        sample_rate=int(cfg.frontend.sample_rate),
        speech_high_threshold=args.high,
        speech_low_threshold=args.low,
        silence_duration_threshold=args.silence_duration,
    )
    while True:
        path = seg.main()
        if path is None:
            continue
        from cs304_tpu_torch.audio.wav import read_wav

        rate, signal = read_wav(path)
        feats = mfcc_batch([signal], cfg=replace(mcfg, sample_rate=float(rate)),
                           device=args.device)
        grammar = _build_grammar(args, decoder.composite.labels)
        if grammar is not None:
            print("decoded:",
                  decoder.predict_batch_grammar(feats, grammar)[0])
        else:
            print("decoded:", decoder.predict(feats[0]))


if __name__ == "__main__":
    run_main(main)
