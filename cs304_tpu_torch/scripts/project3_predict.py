"""Evaluate the isolated-digit argmax classifier on train+test splits with
confusion matrices (reference scripts/project3_predict_simple.py)."""
from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, exact_accuracy,
    load_config, load_corpus,
)

from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
from cs304_tpu_torch.models.collection import ModelCollection
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.reporting.visualizer import plot_confusion_matrix_from_lists
from cs304_tpu_torch.utils.checkpoint import load_models


def evaluate(mc, dataset, mcfg, title):
    truths, clips = [], []
    for label in DIGIT_LABELS:
        for clip in dataset[label]:
            truths.append(label)
            clips.append(clip)
    preds = mc.predict_batch(mfcc_batch(clips, cfg=mcfg, device=mc.device))
    acc = exact_accuracy(truths, preds)
    print(f"{title} accuracy: {acc:.2%} ({len(truths)} clips)")
    plot_confusion_matrix_from_lists(preds, truths, list(DIGIT_LABELS), title=title)
    return acc


def main(argv=None) -> None:
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)
    models = load_models(cfg.checkpoint_dir, labels=list(DIGIT_LABELS))
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()
    mc = ModelCollection.from_models([models[l] for l in DIGIT_LABELS],
                                     device=args.device)
    evaluate(mc, corpus.train_dataset, mcfg, "train_split")
    evaluate(mc, corpus.test_dataset, mcfg, "test_split")


if __name__ == "__main__":
    run_main(main)
