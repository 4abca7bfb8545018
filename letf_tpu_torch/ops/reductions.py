"""Summary reductions on the device: percentile fans, CVaR, win rates.

Port of ``letf_tpu/ops/reductions.py``. Quantiles are per column with
linear interpolation (``np.percentile``'s default); ``torch.quantile``
refuses a flattened input above 2**24 elements, so every call reduces one
axis.
"""

from __future__ import annotations

import torch

PERCENTILES = (10.0, 25.0, 40.0, 50.0, 60.0, 75.0, 90.0)


def percentile_fan(wealth: torch.Tensor) -> torch.Tensor:
    """wealth [N, S] -> [len(PERCENTILES), S]."""
    q = torch.tensor(PERCENTILES, dtype=wealth.dtype,
                     device=wealth.device) / 100.0
    return torch.quantile(wealth, q, dim=0, interpolation="linear")


def cvar(wealth: torch.Tensor, alpha: float = 0.05) -> torch.Tensor:
    """Mean wealth of the worst max(1, int(N * alpha)) trials, per
    column: [N, S] -> [S]."""
    k = max(1, int(wealth.shape[0] * alpha))
    return torch.sort(wealth, dim=0).values[:k].sum(0) / k


def win_rate(wealth: torch.Tensor, benchmark: torch.Tensor) -> torch.Tensor:
    """Percent of trials beating the per-trial benchmark: [N, S], [N] ->
    [S]."""
    return (wealth > benchmark[:, None]).to(wealth.dtype).mean(0) * 100.0


def wealth_to_cagr(wealth, initial_capital: float, years: float):
    w = torch.clamp_min(wealth, 0.0)
    return (w / initial_capital) ** (1.0 / years) - 1.0
