"""Borrow-cost math and drawdown duration (the port's copy of
``letf_tpu/utils/finance.py:18-54``): ``calculate_daily_borrow_cost`` for a
scalar rate, ``get_borrow_cost_series`` over a frame's IRX column and
``get_max_underwater_days`` of an equity curve.

``fill_missing_with_dynamic_factor`` serves only the network data route
and waits with it (ROADMAP item 14).
"""

from __future__ import annotations

import numpy as np


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
