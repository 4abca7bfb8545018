"""The float type of the reference's day loops.

float32, as the port's kernels compute. The control of the benchmark's
comparison (``benchmark/checks.py``) runs the same loops in bfloat16, the
nearest precision below: the day carries, every stored series and the
counter draws once drawn are then bfloat16; the draws' bits and the model
tables are as before.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

F = torch.float32


@contextlib.contextmanager
def lowered(dtype: torch.dtype = torch.bfloat16):
    """Run the reference's day loops in ``dtype`` inside the block."""
    global F
    saved, F = F, dtype
    try:
        yield
    finally:
        F = saved


def round_np(x: np.ndarray) -> np.ndarray:
    """A NumPy float array rounded to ``F`` where that is bfloat16 (kept in
    float32 storage); unchanged otherwise."""
    if F != torch.bfloat16:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).float().numpy()
