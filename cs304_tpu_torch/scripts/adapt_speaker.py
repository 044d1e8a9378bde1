"""MAP speaker adaptation CLI: enroll a speaker, save an adapted checkpoint.

Feed a few enrollment WAVs with known transcripts; the word-model means are
MAP-interpolated toward the speaker's forced-alignment statistics
(models/adapt.py) and saved as a new checkpoint usable by every decode
script. (No reference equivalent — the reference's only answer to a new
speaker/channel was retraining.)

Example:
  python -m cs304_tpu_torch.scripts.adapt_speaker --checkpoint-dir .cache/m6 \
      --out-dir .cache/m6_alice \
      --wav a1.wav --transcript 375 --wav a2.wav --transcript 186Z --tau 20
"""
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    adopt_checkpoint_frontend, base_parser, load_config, run_main,
)

from cs304_tpu_torch.models.adapt import map_adapt
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import load_manifest, load_models, save_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--out-dir", required=True,
                        help="directory for the adapted checkpoint")
    parser.add_argument("--wav", action="append", default=[], required=True,
                        help="enrollment WAV (repeatable)")
    parser.add_argument("--transcript", action="append", default=[],
                        help="digit transcript for the matching --wav "
                             "(omit all of them with --unsupervised)")
    parser.add_argument("--unsupervised", action="store_true",
                        help="self-adaptation: pseudo-transcripts from the "
                             "decoder's own confident predictions "
                             "(models/adapt.py self_adapt — mild-mismatch "
                             "use; strong mismatch needs true transcripts)")
    parser.add_argument("--min-confidence", type=float, default=0.7,
                        help="per-word posterior bar for --unsupervised")
    parser.add_argument("--tau", type=float, default=None,
                        help="MAP prior weight (equivalent prior frames per "
                             "state; smaller = trust enrollment more; "
                             "default 20, or 1 with --unsupervised)")
    parser.add_argument("--no-adapt-silence", action="store_true",
                        help="keep the silence model at the prior (silence "
                             "adapts with the words by default — measured "
                             "necessary, see models/adapt.py)")
    args = parser.parse_args(argv)
    if args.unsupervised:
        if args.transcript:
            raise SystemExit(
                "error: --unsupervised takes no --transcript "
                "(that's what supervised mode is for)"
            )
    elif len(args.wav) != len(args.transcript):
        raise SystemExit("error: need one --transcript per --wav")
    cfg = load_config(args)
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()

    models = load_models(cfg.checkpoint_dir)
    from cs304_tpu_torch.audio.wav import read_wav

    def featurize(wav_path):
        rate, signal = read_wav(wav_path)
        return mfcc_batch(
            [signal], cfg=replace(mcfg, sample_rate=float(rate)),
            device=args.device,
        )[0]

    if args.unsupervised:
        from cs304_tpu_torch.models.adapt import self_adapt

        adapted, kept = self_adapt(
            models, [featurize(w) for w in args.wav],
            tau=1.0 if args.tau is None else args.tau,
            penalty=cfg.decode.word_penalty,
            min_confidence=args.min_confidence,
            adapt_silence=not args.no_adapt_silence,
            device=args.device,
        )
        if kept == 0:
            raise SystemExit(
                "error: no utterance cleared the confidence bar "
                f"({args.min_confidence}) — lower --min-confidence or "
                "provide transcripts"
            )
        print(f"self-adaptation kept {kept}/{len(args.wav)} utterance(s)")
    else:
        labeled = {}
        for wav_path, transcript in zip(args.wav, args.transcript):
            labeled.setdefault(transcript, []).append(featurize(wav_path))
        adapted = map_adapt(
            models, labeled, tau=20.0 if args.tau is None else args.tau,
            adapt_silence=not args.no_adapt_silence,
            device=args.device,
        )
    frontend = None
    src_manifest = {}
    try:
        src_manifest = load_manifest(cfg.checkpoint_dir)
        frontend = src_manifest.get("frontend")
    except OSError:
        pass
    # Adapted checkpoints inherit the source's unit tier: MAP adaptation
    # shifts parameters, not the unit convention.
    save_models(
        adapted, args.out_dir, frontend=frontend,
        tier=src_manifest.get("unit_tier"),
        provenance={"script": "adapt_speaker.py",
                    "source": cfg.checkpoint_dir},
    )
    print(f"adapted {len(adapted)} models on {len(args.wav)} enrollment "
          f"utterance(s) -> {args.out_dir}")


if __name__ == "__main__":
    run_main(main)
