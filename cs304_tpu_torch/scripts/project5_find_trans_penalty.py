"""Sweep the inter-word transition penalty and plot accuracy vs penalty
(reference scripts/project5_find_trans_ndigits_no_sil.py / _with_sil.py)."""
from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, exact_accuracy,
    load_config, load_corpus,
)

from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.reporting.visualizer import plot_line
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--n-digits", type=int, default=4)
    parser.add_argument("--no-silence", action="store_true")
    parser.add_argument("--start", type=float, default=0.0)
    parser.add_argument("--stop", type=float, default=-1000.0)
    parser.add_argument("--step", type=float, default=-50.0)
    parser.add_argument("--max-per-label", type=int, default=5)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)
    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)
    if args.no_silence:
        models = {l: m for l, m in models.items() if l != "S"}

    grouped = corpus.train_dataset.get_all_n_digits(args.n_digits)
    truths, clips = [], []
    for transcript, utts in grouped.items():
        for u in utts[: args.max_per_label]:
            truths.append(transcript)
            clips.append(u)
    feats = mfcc_batch(clips, cfg=cfg.frontend.mfcc_config(), device=args.device)

    penalties, accuracies = [], []
    penalty = args.start
    while penalty >= args.stop:
        decoder = ContinuousDecoder(models, penalty=penalty, device=args.device)
        acc = exact_accuracy(truths, decoder.predict_batch(feats))
        print(f"penalty={penalty:8.1f} accuracy={acc:.2%}")
        penalties.append(penalty)
        accuracies.append(acc)
        penalty += args.step
    tag = "no_sil" if args.no_silence else "with_sil"
    plot_line(penalties, accuracies, title=f"accuracy_vs_penalty_{tag}",
              x_label="inter-word log penalty", y_label="exact-sequence accuracy")


if __name__ == "__main__":
    run_main(main)
