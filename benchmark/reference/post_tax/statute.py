"""Frozen copy of the JAX package's tax statute and income path (plain
Python), part of the benchmark's plain post-tax reference: it imports
nothing of the port or the JAX package. From ``letf_tpu/tax/brackets.py``
(the 2024 tables), ``letf_tpu/tax/marginal.py``
(``calculate_comprehensive_tax_v6`` with its helpers),
``letf_tpu/tax/engine.py`` (``_net_core`` on Python scalars as
``compute_capital_gains`` calls it) and ``letf_tpu/income.py``
(``simulate_wired_income_path``). What the post-tax reference does not
run was left out: the reporting breakdowns, the golden cases, the
vectorized netting and the other lot elections.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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


# ---- marginal.py ----

def _tax_from_table(taxable: float,
                    brackets: List[Tuple[float, float]]) -> float:
    tax = 0.0
    prev = 0.0
    for limit, rate in brackets:
        if taxable <= prev:
            break
        amount = min(taxable, limit) - prev
        tax += amount * rate
        prev = limit
        if taxable <= limit:
            break
    return tax


def calculate_marginal_tax(income: float, brackets: List[Tuple[float, float]],
                           standard_deduction: float = 0.0) -> float:
    """Progressive tax on ``income`` after ``standard_deduction``."""
    if income <= 0:
        return 0.0
    taxable = max(0.0, income - standard_deduction)
    return _tax_from_table(taxable, brackets)


def calculate_ltcg_tax_stacked(ltcg_amount: float,
                               ordinary_income_after_deduction: float,
                               ltcg_brackets) -> float:
    """Stacked LTCG tax: gains fill the LTCG brackets from where ordinary
    income left off."""
    if ltcg_amount <= 0:
        return 0.0
    total_tax = 0.0
    remaining = ltcg_amount
    position = max(0.0, ordinary_income_after_deduction)
    for ceiling, rate in ltcg_brackets:
        if remaining <= 0:
            break
        if position >= ceiling:
            continue
        in_bracket = min(remaining, ceiling - position)
        total_tax += in_bracket * rate
        remaining -= in_bracket
        position += in_bracket
    return total_tax


def _inflate(brackets, m):
    return [(lim * m, rate) for lim, rate in brackets]


def calculate_comprehensive_tax_v6(taxable_st: float, taxable_lt: float,
                                   capital_loss_deduction: float,
                                   ordinary_income: float = 0.0,
                                   include_state: bool = True,
                                   include_niit: bool = True,
                                   filing_status: str = "single",
                                   bracket_multiplier: float = 1.0,
                                   state_code: str = "CA") -> Dict:
    """Federal (ordinary + ST stacked + LTCG stacked), state and NIIT."""
    ordinary_brackets = FEDERAL_TAX_BRACKETS_2024.get(
        filing_status, FEDERAL_TAX_BRACKETS_2024["single"])
    std_deduction = STANDARD_DEDUCTION_2024.get(
        filing_status, STANDARD_DEDUCTION_2024["single"])
    ltcg_brackets = LTCG_BRACKETS_2024.get(filing_status,
                                           LTCG_BRACKETS_2024["single"])
    state_data = STATE_TAX_BRACKETS.get(state_code, STATE_TAX_BRACKETS["CA"])
    state_brackets = state_data.get(filing_status, state_data["single"])
    state_std_ded = state_data["std_deduction"].get(
        filing_status, state_data["std_deduction"]["single"])
    niit_threshold = NIIT_THRESHOLD_2024.get(filing_status,
                                             NIIT_THRESHOLD_2024["single"])

    if bracket_multiplier != 1.0:
        ordinary_brackets = _inflate(ordinary_brackets, bracket_multiplier)
        ltcg_brackets = _inflate(ltcg_brackets, bracket_multiplier)
        std_deduction *= bracket_multiplier
        niit_threshold *= bracket_multiplier
        state_brackets = _inflate(state_brackets, bracket_multiplier)
        state_std_ded *= bracket_multiplier

    adjusted_ordinary = max(0.0, ordinary_income - capital_loss_deduction)
    federal_ordinary = calculate_marginal_tax(adjusted_ordinary,
                                              ordinary_brackets,
                                              std_deduction)
    total_ordinary_income = adjusted_ordinary + taxable_st
    federal_with_st = calculate_marginal_tax(total_ordinary_income,
                                             ordinary_brackets, std_deduction)
    federal_st_tax = federal_with_st - federal_ordinary
    total_income = total_ordinary_income + taxable_lt

    ordinary_base_for_ltcg = max(0.0, total_ordinary_income - std_deduction)
    federal_ltcg_tax = 0.0
    if taxable_lt > 0:
        federal_ltcg_tax = calculate_ltcg_tax_stacked(
            taxable_lt, ordinary_base_for_ltcg, ltcg_brackets)
    federal_total = federal_ordinary + federal_st_tax + federal_ltcg_tax

    state_tax = 0.0
    if include_state:
        if state_data.get("cap_gains_only", False):
            state_tax = calculate_marginal_tax(taxable_st + taxable_lt,
                                               state_brackets, state_std_ded)
        else:
            state_tax = calculate_marginal_tax(total_income, state_brackets,
                                               state_std_ded)

    niit_tax = 0.0
    if include_niit and total_income > niit_threshold:
        niit_base = min(taxable_st + taxable_lt,
                        total_income - niit_threshold)
        niit_tax = niit_base * NIIT_RATE

    return {"federal_total": federal_total, "state_tax": state_tax,
            "niit_tax": niit_tax,
            "total_tax": federal_total + state_tax + niit_tax}


# ---- engine.py: the netting core under the default election
# (MINIMIZE_ST_FIRST), on Python scalars ----

def compute_capital_gains(st_gains, st_losses, lt_gains, lt_losses,
                          st_cf_in, lt_cf_in):
    """Returns (taxable_st, taxable_lt, st_cf_out, lt_cf_out,
    capital-loss deduction)."""
    curr_st = st_gains - st_losses
    curr_lt = lt_gains - lt_losses
    offset_a = min(max(curr_st, 0.0), max(-curr_lt, 0.0))
    curr_st = curr_st - offset_a
    curr_lt = curr_lt + offset_a
    offset_b = min(max(curr_lt, 0.0), max(-curr_st, 0.0))
    curr_lt = curr_lt - offset_b
    curr_st = curr_st + offset_b
    net_st, net_lt = curr_st, curr_lt
    cf_st, cf_lt = st_cf_in, lt_cf_in

    def apply(cf, net):
        used = min(cf, max(net, 0.0))
        return cf - used, net - used

    cf_st, net_st = apply(cf_st, net_st)   # ST CF -> ST gains
    cf_lt, net_lt = apply(cf_lt, net_lt)   # LT CF -> LT gains
    cf_st, net_lt = apply(cf_st, net_lt)   # ST CF -> LT gains (cross)
    cf_lt, net_st = apply(cf_lt, net_st)   # LT CF -> ST gains (cross)

    total_net = net_st + net_lt
    deduction = min(3000.0, max(-total_net, 0.0))
    st_loss = max(-net_st, 0.0)
    lt_loss = max(-net_lt, 0.0)
    ded_from_st = min(deduction, st_loss)
    ded_from_lt = deduction - ded_from_st
    cf_st_out = cf_st + max(st_loss - ded_from_st, 0.0)
    cf_lt_out = cf_lt + max(lt_loss - ded_from_lt, 0.0)
    return (max(net_st, 0.0), max(net_lt, 0.0), cf_st_out, cf_lt_out,
            deduction)


# ---- income.py ----

def simulate_wired_income_path(base_income: float, years: int,
                               years_until_retirement: Optional[int] = None,
                               retirement_income: Optional[float] = None,
                               seed: int = 42) -> np.ndarray:
    """The income path of the wired tax engine (seed 42: promotions 25%,
    job changes 10%, setbacks 3% with 2 years of recovery, growth clipped
    to [-0.5, 1.0], retirement at 50% of peak with 2% COLA)."""
    rng = np.random.default_rng(seed)
    path = [float(base_income)]
    in_recovery = 0
    peak = float(base_income)
    for year in range(1, years + 1):
        current = path[-1]
        if years_until_retirement is not None \
                and year > years_until_retirement:
            if year == years_until_retirement + 1:
                new_income = (peak * 0.50 if retirement_income is None
                              else float(retirement_income))
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
