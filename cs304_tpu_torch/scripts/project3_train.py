"""Train the 11 isolated-digit HMMs (reference scripts/project3_train.py)."""
from cs304_tpu_torch.scripts._common import (
    run_main, base_parser, frontend_manifest, load_config, load_corpus,
)

from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_digit_models
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import save_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument(
        "--gmm-mixtures", type=int, default=0,
        help="train K-mixture GMM emissions instead of single Gaussians",
    )
    parser.add_argument(
        "--baum-welch", action="store_true",
        help="refine with soft-EM after segmental k-means (implies GMM path)",
    )
    args = parser.parse_args(argv)
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)

    mcfg = cfg.frontend.mfcc_config()
    feats = {
        label: mfcc_batch(corpus.train_dataset[label], cfg=mcfg, device=args.device)
        for label in DIGIT_LABELS
    }
    kcfg = SegmentalKMeansConfig(
        num_states=cfg.train.num_states,
        max_iterations=cfg.train.max_iterations,
        cov_reg=cfg.train.cov_reg,
        init_cov=cfg.train.init_cov,
        length_multiple=cfg.train.length_multiple,
    )
    if args.gmm_mixtures or args.baum_welch:
        from cs304_tpu_torch.models.gmm_hmm import train_gmm_hmm, train_gmm_hmm_baum_welch

        k = max(args.gmm_mixtures, 1)
        models = {}
        for label, f in feats.items():
            m = train_gmm_hmm(label, f, num_mixtures=k, cfg=kcfg,
                              device=args.device)
            if args.baum_welch:
                m = train_gmm_hmm_baum_welch(label, f, num_mixtures=k, cfg=kcfg,
                                             init=m, device=args.device)
            models[label] = m
            print(f"trained GMM {label} (K={k}, bw={args.baum_welch})")
    else:
        models = train_digit_models(feats, kcfg, device=args.device)
    save_models(models, cfg.checkpoint_dir, frontend=frontend_manifest(cfg),
                tier="words", provenance={"script": "project3_train.py"})
    print(f"saved {len(models)} models to {cfg.checkpoint_dir}")


if __name__ == "__main__":
    run_main(main)
