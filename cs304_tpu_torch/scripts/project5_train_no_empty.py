"""Silence-strip all training clips, train 11 digit HMMs plus a 3-state
silence model "S" from the harvested noise
(reference scripts/project5_train_no_empty.py)."""
from cs304_tpu_torch.scripts._common import (
    run_main, base_parser, frontend_manifest, load_config, load_corpus,
)

from cs304_tpu_torch.audio.endpointing import SignalSeparation
from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
from cs304_tpu_torch.models.train_kmeans import (
    SegmentalKMeansConfig,
    train_digit_models,
    train_word_hmm,
)
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import save_models


def main(argv=None) -> None:
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)

    sep = SignalSeparation(
        sample_rate=int(cfg.frontend.sample_rate),
        frame_time=cfg.endpoint.frame_time,
        speech_high_threshold=cfg.endpoint.speech_high_threshold,
        speech_low_threshold=cfg.endpoint.speech_low_threshold,
        silence_duration_threshold=cfg.endpoint.silence_duration_threshold,
    )
    mcfg = cfg.frontend.mfcc_config()
    feats = {}
    for label in DIGIT_LABELS:
        stripped = sep.remove_empty_batch(corpus.train_dataset[label])
        feats[label] = mfcc_batch(stripped, cfg=mcfg, device=args.device)

    kcfg = SegmentalKMeansConfig(
        num_states=cfg.train.num_states,
        max_iterations=cfg.train.max_iterations,
        cov_reg=cfg.train.cov_reg,
        length_multiple=cfg.train.length_multiple,
    )
    models = train_digit_models(feats, kcfg, device=args.device)

    noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
    silence_cfg = SegmentalKMeansConfig(
        num_states=cfg.train.silence_states,
        max_iterations=cfg.train.max_iterations,
        cov_reg=cfg.train.cov_reg,
        length_multiple=cfg.train.length_multiple,
    )
    models["S"] = train_word_hmm(
        "S", mfcc_batch(noises, cfg=mcfg, device=args.device), silence_cfg,
        device=args.device,
    ).model
    save_models(models, cfg.checkpoint_dir, frontend=frontend_manifest(cfg),
                tier="words", provenance={"script": "project5_train_no_empty.py"})
    print(f"saved {len(models)} models (incl. silence) to {cfg.checkpoint_dir}")


if __name__ == "__main__":
    run_main(main)
