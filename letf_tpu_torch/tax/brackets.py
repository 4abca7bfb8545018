"""2024 tax bracket tables (federal, LTCG, state, NIIT).

The port's own copy of ``letf_tpu/tax/brackets.py`` (public statutory
data). Brackets are (upper_limit, rate) pairs; ``bracket_arrays`` converts
a table to padded numpy arrays for the vectorized tax.
"""

from __future__ import annotations

import numpy as np

INF = float("inf")

STATE_TAX_BRACKETS = {
    "CA": {
        "single": [
            (10412, 0.01), (24684, 0.02), (38959, 0.04), (54081, 0.06),
            (68350, 0.08), (349137, 0.093), (418961, 0.103),
            (698271, 0.113), (INF, 0.133),
        ],
        "married": [
            (20824, 0.01), (49368, 0.02), (77918, 0.04), (108162, 0.06),
            (136700, 0.08), (698274, 0.093), (837922, 0.103),
            (1396542, 0.113), (INF, 0.133),
        ],
        "std_deduction": {"single": 5363, "married": 10726},
    },
    "NY": {
        "single": [
            (8500, 0.04), (11700, 0.045), (13900, 0.0525), (80650, 0.055),
            (215400, 0.06), (1077550, 0.0685), (5000000, 0.0965),
            (25000000, 0.103), (INF, 0.109),
        ],
        "married": [
            (17150, 0.04), (23600, 0.045), (27900, 0.0525), (161550, 0.055),
            (323200, 0.06), (2155350, 0.0685), (5000000, 0.0965),
            (25000000, 0.103), (INF, 0.109),
        ],
        "std_deduction": {"single": 8000, "married": 16050},
    },
    "TX": {
        "single": [(INF, 0.0)], "married": [(INF, 0.0)],
        "std_deduction": {"single": 0, "married": 0},
    },
    "FL": {
        "single": [(INF, 0.0)], "married": [(INF, 0.0)],
        "std_deduction": {"single": 0, "married": 0},
    },
    "WA": {
        # 7% capital-gains-only tax above $250k; ordinary income untaxed.
        "single": [(250000, 0.0), (INF, 0.07)],
        "married": [(250000, 0.0), (INF, 0.07)],
        "std_deduction": {"single": 0, "married": 0},
        "cap_gains_only": True,
    },
    "NV": {
        "single": [(INF, 0.0)], "married": [(INF, 0.0)],
        "std_deduction": {"single": 0, "married": 0},
    },
    "IL": {
        "single": [(INF, 0.0495)], "married": [(INF, 0.0495)],
        "std_deduction": {"single": 2425, "married": 4850},
    },
    "MA": {
        "single": [(INF, 0.05)], "married": [(INF, 0.05)],
        "std_deduction": {"single": 0, "married": 0},
    },
    "NJ": {
        "single": [
            (20000, 0.014), (35000, 0.0175), (40000, 0.035),
            (75000, 0.05525), (500000, 0.0637), (1000000, 0.0897),
            (INF, 0.1075),
        ],
        "married": [
            (20000, 0.014), (50000, 0.0175), (70000, 0.0245),
            (80000, 0.035), (150000, 0.05525), (500000, 0.0637),
            (1000000, 0.0897), (INF, 0.1075),
        ],
        "std_deduction": {"single": 1000, "married": 2000},
    },
}

FEDERAL_TAX_BRACKETS_2024 = {
    "single": [
        (11600, 0.10), (47150, 0.12), (100525, 0.22), (191950, 0.24),
        (243725, 0.32), (609350, 0.35), (INF, 0.37),
    ],
    "married": [
        (23200, 0.10), (94300, 0.12), (201050, 0.22), (383900, 0.24),
        (487450, 0.32), (731200, 0.35), (INF, 0.37),
    ],
}

LTCG_BRACKETS_2024 = {
    "single": [(47025, 0.00), (518900, 0.15), (INF, 0.20)],
    "married": [(94050, 0.00), (583750, 0.15), (INF, 0.20)],
}

STANDARD_DEDUCTION_2024 = {"single": 14600, "married": 29200}
NIIT_THRESHOLD_2024 = {"single": 200000, "married": 250000}
NIIT_RATE = 0.038

def bracket_arrays(brackets, max_len: int = 12):
    """Convert a (limit, rate) table to padded (limits[K], rates[K]) float64
    arrays with +inf padding — the representation consumed by the vectorized
    segment-sum bracket math on device."""
    limits = np.full(max_len, np.inf, np.float64)
    rates = np.zeros(max_len, np.float64)
    for i, (lim, rate) in enumerate(brackets):
        limits[i] = lim
        rates[i] = rate
    # Pad trailing rates with the top rate so interpolation past the table is safe.
    if len(brackets) < max_len:
        rates[len(brackets):] = brackets[-1][1]
    return limits, rates
