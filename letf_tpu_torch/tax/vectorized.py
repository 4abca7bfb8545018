"""Exact netting and comprehensive tax over (trial, year) tensors.

Port of ``letf_tpu/tax/vectorized.py``: ``_piecewise``, ``_inflated_tax``,
``net_years`` (a loop over the Y years), ``comprehensive_tax`` and
``total_tax_all_trials``, and the host bridge
``yearly_activity_from_trades`` (one trade list through the wired lot and
wash-sale machinery of ``integration.py``). Netting calls the port's copy of the statute,
``tax/engine.py::_net_core``, through its ``xp=(minimum, maximum)`` pair
``engine.TORCH_XP`` (torch versions that accept Python-float operands); the bracket tables
are ``tax/brackets.py``. Tensors run in the dtype of the yearly activity.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from letf_tpu_torch.tax.brackets import (
    FEDERAL_TAX_BRACKETS_2024,
    LTCG_BRACKETS_2024,
    NIIT_RATE,
    NIIT_THRESHOLD_2024,
    STANDARD_DEDUCTION_2024,
    STATE_TAX_BRACKETS,
    bracket_arrays,
)
from letf_tpu_torch.tax.engine import (
    TORCH_XP,
    CapitalLossUsageStrategy,
    _net_core,
)

_BRACKET_INFLATION = 0.025
_MARGIN_RATE = 0.06


def _piecewise(x, limits, rates):
    """Progressive tax on x under (limits[K], rates[K]); non-finite x
    propagates (an upstream defect must surface)."""
    lo = torch.cat([torch.zeros(1, dtype=limits.dtype, device=limits.device),
                    limits[:-1]])
    amt = torch.clamp_min(torch.minimum(x[..., None], limits) - lo, 0.0)
    return (amt * rates).sum(-1)


def _inflated_tax(income, limits, rates, std_ded, m):
    """Tax after the standard deduction with thresholds inflated by m."""
    taxable = torch.clamp_min(income - std_ded * m, 0.0)
    return m * _piecewise(taxable / m, limits, rates)


def net_years(st_gains, st_losses, lt_gains, lt_losses,
              strategy: CapitalLossUsageStrategy =
              CapitalLossUsageStrategy.MINIMIZE_ST_FIRST):
    """Year-by-year netting with carryforwards over [N, Y] tensors: the
    statutory core of tax/engine.py applied year after year."""
    N, Y = st_gains.shape
    cf_st = torch.zeros(N, dtype=st_gains.dtype, device=st_gains.device)
    cf_lt = torch.zeros_like(cf_st)
    outs = []
    for y in range(Y):
        t_st, t_lt, cf_st, cf_lt, ded = _net_core(
            st_gains[:, y], st_losses[:, y], lt_gains[:, y], lt_losses[:, y],
            cf_st, cf_lt, strategy, TORCH_XP)
        outs.append((t_st, t_lt, ded))
    t_st, t_lt, ded = (torch.stack(v, dim=1) for v in zip(*outs))
    return t_st, t_lt, ded, cf_st, cf_lt


def _table(brackets, like):
    return [torch.as_tensor(a, dtype=like.dtype, device=like.device)
            for a in bracket_arrays(brackets)]


def comprehensive_tax(taxable_st, taxable_lt, capital_loss_deduction,
                      ordinary_income, bracket_multiplier,
                      filing_status: str = "single", state_code: str = "CA",
                      include_state: bool = True, include_niit: bool = True):
    """Federal ordinary + ST stacked at ordinary rates + stacked LTCG +
    state + NIIT with per-element bracket inflation (broadcastable)."""
    like = taxable_st
    fo_lim, fo_rate = _table(FEDERAL_TAX_BRACKETS_2024[filing_status], like)
    lt_lim, lt_rate = _table(LTCG_BRACKETS_2024[filing_status], like)
    state = STATE_TAX_BRACKETS.get(state_code, STATE_TAX_BRACKETS["CA"])
    st_lim, st_rate = _table(state[filing_status], like)
    st_ded = state["std_deduction"][filing_status]
    std_ded = STANDARD_DEDUCTION_2024[filing_status]
    niit_thresh = NIIT_THRESHOLD_2024[filing_status]
    cap_gains_only = state.get("cap_gains_only", False)

    m = bracket_multiplier
    adj_ordinary = torch.clamp_min(ordinary_income - capital_loss_deduction,
                                   0.0)
    federal_ordinary = _inflated_tax(adj_ordinary, fo_lim, fo_rate, std_ded,
                                     m)
    total_ordinary = adj_ordinary + taxable_st
    federal_with_st = _inflated_tax(total_ordinary, fo_lim, fo_rate, std_ded,
                                    m)
    federal_st = federal_with_st - federal_ordinary

    base = torch.clamp_min(total_ordinary - std_ded * m, 0.0)
    ltcg_tax = (m * _piecewise((base + taxable_lt) / m, lt_lim, lt_rate)
                - m * _piecewise(base / m, lt_lim, lt_rate))
    ltcg_tax = torch.where(taxable_lt > 0, ltcg_tax, 0.0)

    federal_total = federal_ordinary + federal_st + ltcg_tax
    total_income = total_ordinary + taxable_lt

    if include_state:
        state_base = (taxable_st + taxable_lt if cap_gains_only
                      else total_income)
        state_tax = _inflated_tax(state_base, st_lim, st_rate, st_ded, m)
    else:
        state_tax = torch.zeros_like(total_income)

    if include_niit:
        investment = taxable_st + taxable_lt
        niit_base = torch.minimum(
            investment, torch.clamp_min(total_income - niit_thresh * m, 0.0))
        niit = torch.where(total_income > niit_thresh * m,
                           niit_base * NIIT_RATE, 0.0)
    else:
        niit = torch.zeros_like(total_income)

    return {"federal_total": federal_total, "state_tax": state_tax,
            "niit_tax": niit, "total_tax": federal_total + state_tax + niit}


def total_tax_all_trials(yearly_activity, income_path, initial_capital,
                         avg_trades_per_year, filing_status: str = "single",
                         state_code: str = "CA",
                         strategy: CapitalLossUsageStrategy =
                         CapitalLossUsageStrategy.MINIMIZE_ST_FIRST,
                         include_state: bool = True,
                         include_niit: bool = True) -> Dict:
    """Exact per-trial tax. yearly_activity [N, Y, 4] (st_gains,
    st_losses, lt_gains, lt_losses); income_path [Y+1] (year 0 = base
    income); avg_trades_per_year [N] (the margin-leverage proxy). Returns
    total_tax [N] and the yearly taxable tensors."""
    sg, sl, lg, ll = (yearly_activity[..., k] for k in range(4))
    N, Y = sg.shape
    dt, dev = sg.dtype, sg.device
    t_st, t_lt, ded, cf_st, cf_lt = net_years(sg, sl, lg, ll, strategy)

    years = torch.arange(Y, dtype=dt, device=dev)
    m = (1.0 + _BRACKET_INFLATION) ** years
    ordinary = torch.as_tensor(income_path, dtype=dt, device=dev)[1:Y + 1]

    avg = avg_trades_per_year
    lev = torch.where(avg < 50, 1.2,
                      torch.where(avg < 150, 1.5, torch.full_like(avg, 1.8)))
    base_margin = initial_capital * (lev - 1.0) * _MARGIN_RATE
    margin = base_margin[:, None] * (1.0 + years * 0.15)[None, :]
    st_after = torch.clamp_min(t_st - margin, 0.0)
    rem = torch.clamp_min(margin - t_st, 0.0)
    lt_after = torch.clamp_min(t_lt - rem, 0.0)

    kw = dict(filing_status=filing_status, state_code=state_code,
              include_state=include_state, include_niit=include_niit)
    baseline = comprehensive_tax(torch.zeros_like(st_after),
                                 torch.zeros_like(lt_after), ded,
                                 ordinary[None, :], m[None, :], **kw)
    with_gains = comprehensive_tax(st_after, lt_after, ded,
                                   ordinary[None, :], m[None, :], **kw)
    year_tax = torch.clamp_min(with_gains["total_tax"]
                               - baseline["total_tax"], 0.0)
    return {"total_tax": year_tax.sum(1), "yearly_tax": year_tax,
            "taxable_st": t_st, "taxable_lt": t_lt,
            "final_cf_st": cf_st, "final_cf_lt": cf_lt}


def yearly_activity_from_trades(trades, n_years: int,
                                elections=None) -> np.ndarray:
    """Host bridge: one trade list -> [Y, 4] yearly (st_g, st_l, lt_g, lt_l)
    via the exact wired lot/wash machinery (integration.py pass 1+2)."""
    from letf_tpu_torch.integration import _yearly_activity_from_trades
    from letf_tpu_torch.tax.engine import TaxpayerElections

    if elections is None:
        elections = TaxpayerElections()
    acts = _yearly_activity_from_trades(trades, elections)
    out = np.zeros((n_years, 4))
    for year, a in acts.items():
        if 0 <= year < n_years:
            out[year] = [a["st_gains"], a["st_losses"],
                         a["lt_gains"], a["lt_losses"]]
    return out
