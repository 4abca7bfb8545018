"""The income path of the wired tax engine.

The port's own copy of ``letf_tpu/income.py::simulate_wired_income_path``
(the NumPy generator seeded with 42: promotions, job changes, setbacks with
recovery, retirement drop), which the post-tax tables tax against.
"""

from __future__ import annotations

import numpy as np


def simulate_wired_income_path(base_income: float, years: int,
                               years_until_retirement: int | None = None,
                               retirement_income: float | None = None,
                               seed: int = 42) -> np.ndarray:
    """The income path used inside the wired tax engine — exact parity with
    the inline generator at letf/integration.py:258-328 (seed 42: promotions
    25%, job changes 10%, setbacks 3% with 2y recovery, ±clip [-0.5, 1.0],
    retirement drop to 50% of peak with 2% COLA)."""
    rng = np.random.default_rng(seed)
    path = [float(base_income)]
    in_recovery = 0
    peak = float(base_income)
    retirement_pct = 0.50

    for year in range(1, years + 1):
        current = path[-1]
        if years_until_retirement is not None and year > years_until_retirement:
            if retirement_income is None:
                if year == years_until_retirement + 1:
                    new_income = peak * retirement_pct
                else:
                    new_income = current * 1.02
            else:
                if year == years_until_retirement + 1:
                    new_income = float(retirement_income)
                else:
                    new_income = current * 1.02
        else:
            growth = 0.04 + rng.normal(0, 0.08)
            event = 0.0
            if rng.random() < 0.03 and in_recovery == 0:
                event = rng.uniform(-0.20, -0.10)
                in_recovery = 2
            elif rng.random() < 0.10:
                event = rng.uniform(0.10, 0.30)
            elif rng.random() < 0.25:
                event = rng.uniform(0.15, 0.25)
            recovery = 0.0
            if in_recovery > 0:
                recovery = 0.08
                in_recovery -= 1
            total = float(np.clip(growth + event + recovery, -0.50, 1.00))
            new_income = current * (1 + total)
            peak = max(peak, new_income)
        path.append(new_income)

    return np.asarray(path)
