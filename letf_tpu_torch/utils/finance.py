"""Borrow-cost math, drawdown duration and the dynamic-factor backfill
(the port's copy of ``letf_tpu/utils/finance.py``):
``calculate_daily_borrow_cost`` for a scalar rate,
``get_borrow_cost_series`` over a frame's IRX column,
``get_max_underwater_days`` of an equity curve and
``fill_missing_with_dynamic_factor`` on the port's ``utils/frame.Frame``,
bit for bit the JAX package's on a pandas DataFrame.
"""

from __future__ import annotations

import numpy as np

from letf_tpu_torch.utils.frame import (
    _prep,
    bfill,
    ffill,
    fillna,
    rolling_cov,
    rolling_mean,
    rolling_var,
)


def calculate_daily_borrow_cost(leverage: float, risk_free_rate: float,
                                spread: float) -> float:
    """Daily financing drag of an Lx fund: (L-1) * max(rf + spread, 0) / 252.

    A 3x fund borrows 2x its capital; a 1x fund borrows nothing. Rates are
    annual decimals; the result is a daily decimal.
    """
    borrowed = leverage - 1.0
    if borrowed <= 0:
        return 0.0
    annual = borrowed * max(risk_free_rate + spread, 0.0)
    return annual / 252.0


def get_borrow_cost_series(df, leverage: float, spread: float) -> np.ndarray:
    """Daily borrow cost from the frame's IRX column (percent units)."""
    borrowed = leverage - 1.0
    if borrowed <= 0:
        return np.zeros(len(df))
    risk_free = df["IRX"] / 100.0
    return borrowed * (risk_free + spread) / 252.0


def get_max_underwater_days(equity_curve) -> int:
    """Longest run of days below the running high-water mark."""
    ec = np.asarray(equity_curve, dtype=float)
    if ec.size == 0:
        return 0
    hwm = np.maximum.accumulate(ec)
    under = ec < hwm
    best = run = 0
    for u in under:
        run = run + 1 if u else 0
        best = max(best, run)
    return int(best)


def fill_missing_with_dynamic_factor(df, target_col: str, factor_col: str,
                                     default_beta: float, seed: int = 1234):
    """Backfill the missing days of ``target_col`` (a column of the frame
    ``df``, added as NaN when absent) from ``factor_col``: a 252-day
    rolling beta (at least 40 days; the covariance over the variance,
    zero variance and +-inf read as missing, clipped to [-3, 3], forward
    then backward filled, ``default_beta`` where none exists) and rolling
    alpha, plus residuals of the days where both are present, resampled
    with ``np.random.default_rng(seed).choice`` in row order. Fewer than
    40 such days: ``default_beta * factor``. Returns the filled column."""
    if target_col not in df:
        df[target_col] = np.full(len(df), np.nan)
    target = np.array(df[target_col], np.float64)
    factor = np.array(df[factor_col], np.float64)

    valid = ~np.isnan(target) & ~np.isnan(factor)
    if valid.sum() < 40:
        return fillna(target, default_beta * factor)

    with np.errstate(all="ignore"):
        cov = rolling_cov(target, factor, 252, 40)
        var = rolling_var(_prep(factor), 252, 40)
        beta = cov / np.where(var == 0, np.nan, var)
    beta = np.clip(np.where(np.isinf(beta), np.nan, beta), -3.0, 3.0)
    beta = fillna(bfill(ffill(beta)), default_beta)

    alpha = rolling_mean(_prep(target - beta * factor), 252, 40)
    alpha = fillna(bfill(ffill(alpha)), 0.0)

    fitted = alpha + beta * factor
    residuals = (target - fitted)[valid]
    residuals = residuals[~np.isnan(residuals)]
    missing = np.isnan(target) & ~np.isnan(factor)

    if len(residuals) > 20 and missing.any():
        rng = np.random.default_rng(seed)
        sampled = rng.choice(residuals, size=int(missing.sum()),
                             replace=True)
        target[missing] = fitted[missing] + sampled
    else:
        target[missing] = fitted[missing]
    return target
