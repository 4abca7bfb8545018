"""Frozen copy of ``letf_tpu_torch/ops/reductions.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Summary reductions on the device: percentile fans, CVaR, win rates.

Port of ``letf_tpu/ops/reductions.py``. Quantiles are per column with
linear interpolation (``np.percentile``'s default); ``torch.quantile``
refuses a flattened input above 2**24 elements, so every call reduces one
axis.

``fixed_sum`` and ``day_mean`` are the port's reductions of one trial's
values (over its days, its candidate blocks, its lots): torch's own
``sum``/``mean`` pick their order from the whole shape, so a trial's
result would depend on how many trials share its batch.
"""

from __future__ import annotations

import torch


def fixed_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` in an order fixed by that dim's length
    alone: halving steps of elementwise adds (entries 2i and 2i + 1; an odd
    last entry carried to the end of the next step). Each output element
    comes from its own inputs alone, so it is the same bits in any batch,
    chunk or shard, on the CPU and on the card."""
    s = x.movedim(dim, 0)
    while s.shape[0] > 1:
        m = s.shape[0]
        h = s[0:m - 1:2] + s[1:m:2]
        s = torch.cat([h, s[m - 1:]]) if m % 2 else h
    return s[0]


def day_mean(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The mean over ``dim`` (a trial's days) of ``x``: ``fixed_sum`` over
    the length."""
    return fixed_sum(x, dim) / x.shape[dim]


