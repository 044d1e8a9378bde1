"""Logging setup mirroring the reference's per-script runtime.log convention
(scripts/project3_train.py:6-8) plus console echo."""
from __future__ import annotations

import logging
import sys


def setup_logging(
    log_file: str | None = "runtime.log",
    level: int = logging.INFO,
    console: bool = True,
) -> None:
    handlers: list[logging.Handler] = []
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    if console:
        handlers.append(logging.StreamHandler(sys.stderr))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )
