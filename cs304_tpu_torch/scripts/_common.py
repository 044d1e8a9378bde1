"""Shared plumbing for the project scripts (the port's copy of
scripts/_common.py).

The reference scripts hardcode constants in-file (SURVEY.md §2.2); here every
script is an argparse CLI over cs304_tpu_torch.utils.config.Config, with a
--synthetic switch that substitutes the generated corpus when the licensed
TI-Digits tree is absent, and a --device switch: the card by default
(raising without one), the CPU only when asked for.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import logging
import os
import sys

from cs304_tpu_torch.device import resolve_device
from cs304_tpu_torch.utils.config import Config


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", help="JSON config file", default=None)
    p.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE", help="config override, e.g. decode.word_penalty=-250",
    )
    p.add_argument("--data-root", default=None, help="TI-Digits root directory")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument(
        "--synthetic", action="store_true",
        help="use the generated synthetic corpus instead of TI-Digits",
    )
    p.add_argument("--log-file", default="runtime.log")
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the first CUDA card, and an "
             "error without one; 'cpu' runs on the CPU, e.g. with "
             "'torchrun --nproc-per-node 4 -m cs304_tpu_torch.scripts."
             "project6_train --data-parallel --device cpu' to exercise "
             "--data-parallel on CPU ranks without a card)",
    )
    return p


def load_config(args) -> Config:
    # Resolved first, so a missing card fails before any work; every library
    # call of the scripts then takes device=args.device.
    args.device = resolve_device(getattr(args, "device", None))
    cfg = Config.from_file(args.config) if args.config else Config()
    if args.overrides:
        cfg.apply_overrides(args.overrides)
    if args.data_root:
        cfg.data_root = args.data_root
    if args.checkpoint_dir:
        cfg.checkpoint_dir = args.checkpoint_dir
    logging.basicConfig(
        filename=args.log_file, level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    logging.getLogger().addHandler(logging.StreamHandler())
    return cfg


def load_corpus(args, cfg: Config):
    """Returns an object with .train_dataset / .test_dataset."""
    if args.synthetic:
        from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

        return SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                                 takes_per_digit=3, with_sentences=True)
    from cs304_tpu_torch.data.ti_digits import TIDigits

    if not cfg.data_root or not os.path.isdir(cfg.data_root):
        raise FileNotFoundError(
            f"TI-Digits root {cfg.data_root!r} not found — pass --data-root "
            "pointing at the corpus (…/Adults/TIDIGITS above TRAIN/TEST), or "
            "use --synthetic to run on the generated corpus"
        )
    return TIDigits(cfg.data_root)


def frontend_manifest(cfg: Config) -> dict:
    """Front-end facts a checkpoint must pin for decode-time feature parity."""
    return {"normalization": cfg.frontend.normalization}


def adopt_checkpoint_frontend(cfg: Config, args) -> None:
    """Adopt the checkpoint's recorded front-end settings into cfg.frontend.

    Models trained on CMVN features are useless on per-frame-normalized ones
    (and vice versa), so decoding scripts call this after load_config to make
    the checkpoint's manifest win — unless the user explicitly overrode the
    same key with --set frontend.<key>=...
    """
    from cs304_tpu_torch.utils.checkpoint import load_manifest

    try:
        recorded = load_manifest(cfg.checkpoint_dir).get("frontend") or {}
    except OSError:
        return
    explicit = {
        o.partition("=")[0].strip().split(".", 1)[1]
        for o in getattr(args, "overrides", [])
        if o.partition("=")[0].strip().startswith("frontend.")
    }
    for key, value in recorded.items():
        if key not in explicit and hasattr(cfg.frontend, key):
            setattr(cfg.frontend, key, value)


def exact_accuracy(truths, preds) -> float:
    return sum(p == t for p, t in zip(preds, truths)) / max(len(truths), 1)


def run_main(main_fn) -> None:
    """Entry-point wrapper: user-facing errors become one-line messages with
    exit code 1 instead of tracebacks (set CS304_TRACEBACK=1 to debug)."""
    try:
        main_fn()
    except KeyboardInterrupt:
        raise
    except (FileNotFoundError, ValueError, KeyError, RuntimeError) as e:
        if os.environ.get("CS304_TRACEBACK"):
            raise
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)


def run_in_process(main_fn, argv) -> str:
    """Call ``main_fn(argv)`` in this process and return what it printed.

    Support for running scripts in process, not used by the scripts
    themselves: the CPU tests (tests/test_torch_cli_*.py) and chip_smoke.py's
    command-line phase drive every script through it. The root logger's
    handlers are restored afterwards (load_config adds a console handler,
    and the log file's, on every call), so runs in one process do not echo
    each other's lines. Errors propagate: run_main's one-line form is for
    the command line."""
    root = logging.getLogger()
    kept = list(root.handlers)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main_fn(argv)
    finally:
        for h in root.handlers[:]:
            if h not in kept:
                root.removeHandler(h)
                h.close()
    return out.getvalue()
