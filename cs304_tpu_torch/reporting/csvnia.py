"""Pipe-delimited CSV writer/reader, format-compatible with the reference.

The reference rolls its own '|'-separated CSV with doubled-quote escaping and
typed re-parsing (int / None / str) on read (csvnia.py:41-51, 79-93); its eval
scripts dump truth-vs-prediction tables in this format
(scripts/project5_test_ndigits_no_sil.py:75-78). Files written by either
implementation parse identically in the other.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Union

logger = logging.getLogger(__name__)

Cell = Union[str, int, None]


def _escape_cell(entry) -> str:
    if isinstance(entry, str):
        return '"' + entry.replace('"', '""') + '"'
    return str(entry)


def _parse_cell(entry: str) -> Cell:
    if len(entry) >= 2 and entry[0] == '"' and entry[-1] == '"':
        return entry[1:-1].replace('""', '"')
    if entry == "None":
        return None
    if entry.isdigit():
        return int(entry)
    return entry


class CSVWriter:
    """Accumulate rows, then write (reference csvnia.py:23-52)."""

    def __init__(self, columns: List[str]) -> None:
        self.columns = columns
        self.records: List[List] = []

    def __len__(self) -> int:
        return len(self.records)

    def add_line(self, line: List) -> None:
        if len(line) != len(self.columns):
            raise ValueError(
                f"row has {len(line)} cells, expected {len(self.columns)}"
            )
        self.records.append(line)

    def write(self, path: str) -> None:
        lines = ["|".join(_escape_cell(c) for c in self.columns)]
        lines.extend("|".join(_escape_cell(c) for c in row) for row in self.records)
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        logger.info("wrote %d rows to %s", len(self.records), path)


class CSVReader:
    """Iterate rows as column->value dicts (reference csvnia.py:54-92)."""

    def __init__(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            raw = [line.strip() for line in f if line.strip()]
        if not raw:
            raise ValueError(f"empty CSV: {path}")
        self.columns = [c.replace('"', "") for c in raw[0].split("|")]
        self.records = [
            [_parse_cell(c) for c in line.split("|")] for line in raw[1:]
        ]

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator[Dict[str, Cell]]:
        for row in self.records:
            yield dict(zip(self.columns, row))
