"""Train a TIED PHONE inventory from a word corpus + pronunciation lexicon.

The word-tier scripts (project3/5/6) train one HMM per word (reference
hidden_markov_model.py:211-410). This script trains the phone tier
(models/lexicon.py): flat-start boot of shared 3-state phone HMMs, then
tied embedded training where every occurrence of a phone IN ANY WORD pools
into one model. The checkpoint holds the phone models + `lexicon.json`;
decode with `transcribe.py --lexicon <ckpt>/lexicon.json` (words are
composed from phones at load — including words added to the lexicon AFTER
training, the OOV capability the word tier cannot express).

Corpus: the generated word corpus (`--num-words`, data/wordvocab.py) with
its generation-truth lexicon, or your own lexicon via --lexicon-in.
"""
from cs304_tpu_torch.scripts._common import (
    base_parser, frontend_manifest, load_config, run_main,
)

import os

import numpy as np

from cs304_tpu_torch.audio.endpointing import SignalSeparation
from cs304_tpu_torch.data.wordvocab import make_lexicon, make_word_corpus
from cs304_tpu_torch.models.lexicon import (
    Lexicon,
    train_phone_models,
    uniform_phone_boot,
)
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig
from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import save_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--num-words", type=int, default=30,
                        help="generated word-corpus vocabulary size")
    parser.add_argument("--out-dir", default=".cache/phone_models")
    parser.add_argument("--iterations", type=int, default=10)
    parser.add_argument("--hold-out", type=int, default=0, metavar="K",
                        help="exclude the last K words from ALL training "
                             "(decode them later through the lexicon to "
                             "demonstrate OOV support)")
    parser.add_argument("--train-sentences", type=int, default=12)
    parser.add_argument("--gmm-mixtures", type=int, default=0,
                        help="refine the tied phones with embedded "
                             "K-mixture GMM training after the K=1 stage "
                             "(composed words become GMM models)")
    parser.add_argument("--biphones", action="store_true",
                        help="after the monophone stage, train LEFT-CONTEXT "
                             "biphone units (models/biphone.py) initialized "
                             "from the trained monophones; saved under "
                             "<out-dir>/biphones/ and picked up "
                             "automatically by transcribe.py --lexicon, "
                             "with monophone back-off for unseen pairs")
    parser.add_argument("--triphones", action="store_true",
                        help="also train BOTH-SIDE context units "
                             "(models/triphone.py) under <out-dir>/"
                             "triphones/; with --biphones too, decode/"
                             "align back off triphone -> biphone -> "
                             "monophone")
    parser.add_argument("--tie-triphones", type=int, default=None,
                        metavar="N",
                        help="GENERALIZED triphones: seed-train triphone "
                             "units, cluster them to at most N per center "
                             "phone (data-driven tying), retrain the tied "
                             "models, and save them with the TIED lexicon "
                             "as an ordinary phone checkpoint — "
                             "transcribe/align need no special handling; "
                             "the unit->cluster map lands in "
                             "tied_units.json")
    parser.add_argument("--senones", type=int, default=None, metavar="N",
                        help="STATE-LEVEL tying (models/senone.py): "
                             "seed-train triphone units, grow one phonetic "
                             "decision tree per (phone, state) over data-"
                             "driven context classes with at most N leaves "
                             "(senones) each, and retrain the units with "
                             "per-senone statistic pooling. Saved under "
                             "<out-dir>/senones/ and auto-detected by "
                             "transcribe/align --lexicon; unseen triphones "
                             "are synthesized through the trees instead of "
                             "backing off")
    parser.add_argument("--senone-min-gain", type=float, default=0.0,
                        help="minimum likelihood gain for a tree split")
    parser.add_argument("--senone-min-count", type=float, default=8.0,
                        help="minimum occupancy per split child")
    parser.add_argument("--smooth-tau", type=float, default=None,
                        metavar="TAU",
                        help="with --biphones/--triphones: MAP-smooth the "
                             "units toward their monophone priors instead "
                             "of full re-estimation (rare units stay tied, "
                             "frequent units specialize — the sparse-data "
                             "setting)")
    parser.add_argument("--lexicon-in", default=None,
                        help="pronunciation lexicon JSON (default: the "
                             "corpus's generation-truth lexicon)")
    args = parser.parse_args(argv)
    if args.smooth_tau is not None and not (args.biphones or args.triphones):
        parser.error("--smooth-tau only applies with --biphones/--triphones")
    if args.tie_triphones is not None and (args.biphones or args.triphones):
        parser.error("--tie-triphones writes a self-contained tied "
                     "checkpoint; do not combine with "
                     "--biphones/--triphones")
    if args.senones is not None and (
        args.biphones or args.triphones or args.tie_triphones is not None
    ):
        parser.error("--senones is its own unit tier; do not combine with "
                     "--biphones/--triphones/--tie-triphones")
    if args.senones is not None and args.senones < 1:
        parser.error("--senones must be >= 1")
    if args.senones is not None and args.gmm_mixtures > 1:
        parser.error("senone retraining is K=1 (state ties pool Gaussian "
                     "statistics); drop --gmm-mixtures")
    if args.smooth_tau is not None and args.gmm_mixtures > 1:
        # Statically-known incompatibility: fail before minutes of
        # monophone training, not inside the biphone stage.
        parser.error("--smooth-tau is a K=1 MAP pass; use full "
                     "re-estimation with --gmm-mixtures")
    cfg = load_config(args)

    corpus = make_word_corpus(
        args.num_words, num_train_speakers=4, num_test_speakers=2,
        takes_per_digit=3,
    )
    lex = (Lexicon.load(args.lexicon_in) if args.lexicon_in
           else make_lexicon(args.num_words))
    labels = corpus.labels
    train_words = labels[: len(labels) - args.hold_out]
    held = labels[len(labels) - args.hold_out:]
    if held:
        print(f"holding out of training: {held}")

    mcfg = cfg.frontend.mfcc_config()
    sep = SignalSeparation()
    stripped = {
        l: mfcc_batch(sep.remove_empty_batch(corpus.train_dataset[l]),
                      cfg=mcfg, device=args.device)
        for l in train_words
    }
    raw = {l: mfcc_batch(corpus.train_dataset[l], cfg=mcfg, device=args.device)
           for l in train_words}
    print(f"boot: {len(lex.phones)} phones from "
          f"{sum(len(v) for v in raw.values())} clips")
    boot = uniform_phone_boot(stripped, lex)
    noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
    boot["S"] = train_word_hmm(
        "S", mfcc_batch(noises, cfg=mcfg, device=args.device),
        SegmentalKMeansConfig(num_states=3, max_iterations=12,
                              length_multiple=32),
        device=args.device,
    ).model

    labeled = {(w,): raw[w] for w in train_words}
    rng = np.random.default_rng(5)
    added = 0
    while added < args.train_sentences:
        tr = tuple(str(x) for x in rng.choice(train_words, size=3))
        if tr in labeled:
            continue
        labeled[tr] = mfcc_batch(
            [corpus.sentence_audio(tr, spk, jitter_seed=added)
             for spk in range(4)],
            cfg=mcfg, device=args.device,
        )
        added += 1

    train_cfg = ContinuousTrainConfig(max_iterations=args.iterations,
                                      cov_reg=0.1)
    context_tiers = (args.biphones or args.triphones
                     or args.tie_triphones is not None
                     or args.senones is not None)
    phones, iterations = train_phone_models(
        boot, labeled, lex, train_cfg,
        # With context tiers the GMM refinement belongs to the unit stage;
        # the monophones stay K=1 so unit clones and back-off are K=1.
        gmm_mixtures=0 if context_tiers else args.gmm_mixtures,
        device=args.device,
    )
    print(f"tied training: {iterations} iterations over "
          f"{sum(len(v) for v in labeled.values())} utterances")

    save_models(
        phones, args.out_dir, frontend=frontend_manifest(cfg),
        tier="monophones",
        provenance={"script": "train_phones.py",
                    "iterations": int(iterations),
                    "num_words": args.num_words},
    )
    lex.save(os.path.join(args.out_dir, "lexicon.json"))
    print(f"saved {len(phones)} phone models + lexicon.json to "
          f"{args.out_dir}")

    if args.biphones:
        from cs304_tpu_torch.models.biphone import train_biphone_models

        units, bi_iterations = train_biphone_models(
            phones, labeled, lex, train_cfg,
            gmm_mixtures=args.gmm_mixtures,
            smooth_tau=args.smooth_tau,
            device=args.device,
        )
        save_models(
            units, os.path.join(args.out_dir, "biphones"),
            tier="biphones",
            provenance={"script": "train_phones.py --biphones",
                        "iterations": int(bi_iterations),
                        "units": len(units) - 1,
                        "smooth_tau": args.smooth_tau},
        )
        print(f"biphone stage: {bi_iterations} iterations; saved "
              f"{len(units) - 1} context-dependent units to "
              f"{os.path.join(args.out_dir, 'biphones')}")

    if args.triphones:
        from cs304_tpu_torch.models.triphone import train_triphone_models

        tri_units, tri_iterations = train_triphone_models(
            phones, labeled, lex, train_cfg,
            gmm_mixtures=args.gmm_mixtures,
            smooth_tau=args.smooth_tau,
            device=args.device,
        )
        save_models(
            tri_units, os.path.join(args.out_dir, "triphones"),
            tier="triphones",
            provenance={"script": "train_phones.py --triphones",
                        "iterations": int(tri_iterations),
                        "units": len(tri_units) - 1,
                        "smooth_tau": args.smooth_tau},
        )
        print(f"triphone stage: {tri_iterations} iterations; saved "
              f"{len(tri_units) - 1} context-dependent units to "
              f"{os.path.join(args.out_dir, 'triphones')}")

    if args.senones is not None:
        from cs304_tpu_torch.models.senone import train_senone_models

        units, tying, sen_iterations = train_senone_models(
            phones, labeled, lex,
            max_per_state=args.senones,
            min_gain=args.senone_min_gain,
            min_count=args.senone_min_count,
            config=train_cfg,
            device=args.device,
        )
        sen_dir = os.path.join(args.out_dir, "senones")
        save_models(
            units, sen_dir,
            tier="senones",
            provenance={"script": "train_phones.py --senones",
                        "iterations": int(sen_iterations),
                        "units": len(units) - 1,
                        "senones": tying.num_senones(),
                        "max_per_state": args.senones},
        )
        tying.save(os.path.join(sen_dir, "senone_tying.json"))
        print(f"senone stage: {sen_iterations} iterations; "
              f"{len(units) - 1} triphone units tied into "
              f"{tying.num_senones()} senones "
              f"(max {args.senones}/(phone,state)); saved to {sen_dir} — "
              f"transcribe/align --lexicon auto-detect it")

    if args.tie_triphones is not None:
        import json

        from cs304_tpu_torch.models.triphone import tie_and_train_triphones

        tied, tied_lex, mapping = tie_and_train_triphones(
            phones, labeled, lex, max_per_phone=args.tie_triphones,
            config=train_cfg, device=args.device,
        )
        tied_dir = os.path.join(args.out_dir, "tied")
        save_models(
            tied, tied_dir, frontend=frontend_manifest(cfg),
            tier="tied_triphones",
            provenance={"script": "train_phones.py --tie-triphones",
                        "clusters": len(set(mapping.values())),
                        "max_per_phone": args.tie_triphones},
        )
        tied_lex.save(os.path.join(tied_dir, "lexicon.json"))
        with open(os.path.join(tied_dir, "tied_units.json"), "w") as f:
            json.dump(mapping, f, indent=1, sort_keys=True)
        print(f"tied {len(mapping)} triphone units into "
              f"{len(set(mapping.values()))} generalized models "
              f"(max {args.tie_triphones}/phone); self-contained tied "
              f"checkpoint at {tied_dir} — decode with "
              f"--lexicon {os.path.join(tied_dir, 'lexicon.json')}")


if __name__ == "__main__":
    run_main(main)
