"""Pickle-backed artifact cache (the port's copy of
``letf_tpu/utils/cache.py``): the historical frame and the fitted models
are cached under ``config.CACHE_DIR``.

Unlike the reference, a cache file that exists but cannot be read or
written raises: a corrupt cache is a fault to see, not to skip.
"""

from __future__ import annotations

import pickle
from pathlib import Path


def save_cache(data, filepath: Path) -> None:
    with open(filepath, "wb") as f:
        pickle.dump(data, f)


def load_cache(filepath: Path):
    if not Path(filepath).exists():
        return None
    with open(filepath, "rb") as f:
        return pickle.load(f)
