"""Per-phase progress reporting (the reference uses nested tqdm bars with
disable flags, hidden_markov_model.py:254-259; we keep that surface but make
it optional and dependency-tolerant)."""
from __future__ import annotations



def progress_bar(total: int, desc: str = "", enabled: bool = True, position: int = 0):
    """A tqdm bar when available/enabled, else a no-op object."""
    if enabled:
        try:
            from tqdm import tqdm

            return tqdm(total=total, desc=desc, position=position)
        except Exception:
            pass

    class _Noop:
        def update(self, n: int = 1):
            pass

        def close(self):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()
            return False

    return _Noop()
