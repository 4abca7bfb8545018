"""Integration layer: trade lists -> wired tax engine -> post-tax wealth.

The port's copy of ``letf_tpu/integration.py`` (host Python and numpy):
- wash-sale pass over the complete trade list (±30d look-back/forward)
- lot-tracked realization with elected lot selection and basis/holding-period
  adjustments from wash sales
- per-sale wash-sale re-check against ANY buy within ±30 days (the reference
  checks all buys at integration.py:199-206, not just unused ones — kept)
- income path Monte Carlo (seed 42) with optional retirement transition
- 2.5%/yr tax-bracket inflation
- IRC §163(d) margin-interest deduction estimated from trading frequency
- per-year incremental tax: tax(ordinary + gains) - tax(ordinary)
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from letf_tpu_torch import config as cfg
from letf_tpu_torch.income import simulate_wired_income_path
from letf_tpu_torch.tax.engine import TaxpayerElections, compute_capital_gains
from letf_tpu_torch.tax.lot_selection import get_lots_to_sell
from letf_tpu_torch.tax.marginal import calculate_comprehensive_tax_v6
from letf_tpu_torch.tax.wash_sale import WashSaleTracker

_DAYS_PER_YEAR = 252
_LT_THRESHOLD_DAYS = 365
_BRACKET_INFLATION = 0.025
_MARGIN_RATE = 0.06


def _estimate_leverage_ratio(avg_trades_per_year: float) -> float:
    """Leverage proxy from trading frequency (integration.py:383-388)."""
    if avg_trades_per_year < 50:
        return 1.2
    if avg_trades_per_year < 150:
        return 1.5
    return 1.8


def _yearly_activity_from_trades(trades: List[Dict],
                                 elections: TaxpayerElections) -> Dict:
    """Passes 1+2 of the wired engine: wash-sale analysis over the full
    trade list, then lot-tracked realization aggregated by tax year.
    Returns {year: {st_gains, st_losses, lt_gains, lt_losses,
    wash_sale_disallowed}} — the bridge between trade lists and the
    vectorized (trial, year) device tax (tax/vectorized.py)."""
    wash_tracker = WashSaleTracker(days_per_year=_DAYS_PER_YEAR)
    for t in trades:
        wash_tracker.record_trade(
            asset=t["asset"], day=t["day_index"], action=t["action"],
            shares=(t["shares"] if "shares" in t
                    else t["dollar_amount"] / t["price"]),
            price=t["price"])
    wash_tracker.process_all_wash_sales()

    yearly_activity: Dict[int, Dict[str, float]] = defaultdict(lambda: {
        "st_gains": 0.0, "st_losses": 0.0,
        "lt_gains": 0.0, "lt_losses": 0.0,
        "wash_sale_disallowed": 0.0,
    })
    positions: Dict[str, List[Dict]] = defaultdict(list)

    # Sorted buy-day index per asset: the per-sale wash re-check ("any buy
    # within +/-30 days") becomes two binary searches instead of the
    # reference's scan over the whole trade list per consumed lot.
    buy_days_by_asset: Dict[str, List[int]] = {}
    for t in trades:
        if t["action"] == "BUY":
            buy_days_by_asset.setdefault(t["asset"], []).append(t["day_index"])
    buy_days_by_asset = {a: sorted(d) for a, d in buy_days_by_asset.items()}

    def _any_buy_in_window(asset: str, sale_day: int) -> bool:
        days = buy_days_by_asset.get(asset)
        if days is None:
            return False
        lo = bisect.bisect_left(days, sale_day - 30)
        hi = bisect.bisect_right(days, sale_day + 30)
        if hi <= lo:
            return False
        # Some day of the window differs from the sale day unless the
        # window's (sorted) first and last days both equal it.
        return not (days[lo] == sale_day and days[hi - 1] == sale_day)

    for trade in trades:
        year = trade["day_index"] // _DAYS_PER_YEAR
        asset = trade["asset"]

        if trade["action"] == "BUY":
            shares = (trade["shares"] if "shares" in trade
                      else trade["dollar_amount"] / trade["price"])
            base_cost = shares * trade["price"]
            basis_adj = wash_tracker.get_basis_adjustment(asset, trade["day_index"])
            adjusted_cost = base_cost + basis_adj
            holding_start = wash_tracker.get_holding_period_adjustment(
                asset, trade["day_index"])
            positions[asset].append({
                "day": trade["day_index"],
                "shares": shares,
                "price": trade["price"],
                "adjusted_price": adjusted_cost / shares if shares > 0 else trade["price"],
                "basis_adjustment": basis_adj,
                "original_day": holding_start,
                "tacked_shares": wash_tracker.get_tacked_shares(asset, trade["day_index"]),
                "has_wash_sale_adjustment": (basis_adj > 0
                                             or holding_start != trade["day_index"]),
            })

        elif trade["action"] == "SELL":
            shares_to_sell = (trade["shares"] if "shares" in trade
                              else trade["dollar_amount"] / trade["price"])
            sale_price = trade["price"]
            sale_day = trade["day_index"]

            lots_to_use = get_lots_to_sell(
                positions=positions[asset], shares_needed=shares_to_sell,
                method=elections.lot_selection_method,
                sale_day=sale_day, sale_price=sale_price)

            remaining = shares_to_sell
            for lot_idx in lots_to_use:
                if remaining <= 0.001 or lot_idx >= len(positions[asset]):
                    continue
                pos = positions[asset][lot_idx]
                if pos["shares"] <= 0.001:
                    continue
                sold = min(remaining, pos["shares"])
                holding_days = sale_day - pos["original_day"]
                gain_loss = sold * (sale_price - pos["adjusted_price"])

                # Per-sale wash re-check against ANY buy within +/-30 days.
                is_wash = gain_loss < 0 and _any_buy_in_window(asset, sale_day)

                if is_wash and gain_loss < 0:
                    yearly_activity[year]["wash_sale_disallowed"] += abs(gain_loss)
                else:
                    if holding_days > _LT_THRESHOLD_DAYS:
                        key = "lt_gains" if gain_loss > 0 else "lt_losses"
                    else:
                        key = "st_gains" if gain_loss > 0 else "st_losses"
                    yearly_activity[year][key] += abs(gain_loss)

                pos["shares"] -= sold
                remaining -= sold

            positions[asset] = [p for p in positions[asset] if p["shares"] > 0.001]

    return yearly_activity


def process_trades_with_wired_engine(
    trades: List[Dict],
    time_horizon_years: int,
    elections: TaxpayerElections,
    initial_capital: float,
    debug: bool = False,
    strategy_id: str = "UNKNOWN",
    tax_config: Optional[Dict] = None,
) -> Dict:
    """Process a strategy's trade list through the full tax engine."""
    if tax_config is None:
        tax_config = {"filing_status": "single", "state": "CA",
                      "ordinary_income": 150000, "career_stage": "mid"}

    if not trades:
        return {
            "total_tax": 0, "yearly_taxes": [],
            "total_st_gains": 0, "total_lt_gains": 0,
            "final_cf": {"st": 0, "lt": 0},
            "debug_info": "No trades provided",
        }

    yearly_activity = _yearly_activity_from_trades(trades, elections)

    # ------------------------------------------------------------------
    # Income path + margin interest assumptions.
    # ------------------------------------------------------------------
    base_income = tax_config.get("ordinary_income", 150000)
    years_until_retirement = tax_config.get("years_until_retirement", None)
    retirement_income = tax_config.get("retirement_income", None)
    income_path = simulate_wired_income_path(
        base_income, time_horizon_years,
        years_until_retirement=years_until_retirement,
        retirement_income=retirement_income, seed=42)

    avg_trades_per_year = (len(trades) / time_horizon_years
                           if time_horizon_years > 0 else 0.0)
    leverage_ratio = _estimate_leverage_ratio(avg_trades_per_year)
    base_margin_interest = initial_capital * (leverage_ratio - 1.0) * _MARGIN_RATE

    # ------------------------------------------------------------------
    # Year-by-year netting + incremental comprehensive tax.
    # ------------------------------------------------------------------
    cumulative_tax = 0.0
    yearly_results = []
    st_cf = 0.0
    lt_cf = 0.0

    for year in range(time_horizon_years):
        ydata = yearly_activity[year]
        result = compute_capital_gains(
            st_gains=ydata["st_gains"], st_losses=ydata["st_losses"],
            lt_gains=ydata["lt_gains"], lt_losses=ydata["lt_losses"],
            st_loss_cf_in=st_cf, lt_loss_cf_in=lt_cf,
            elections=elections, trace=False)

        ordinary_income = float(income_path[year + 1])
        bracket_multiplier = (1 + _BRACKET_INFLATION) ** year

        # §163(d): margin interest offsets investment income (ST first).
        annual_margin_interest = base_margin_interest * (1 + year * 0.15)
        st_after_margin = max(0.0, result.taxable_st - annual_margin_interest)
        margin_remaining = max(0.0, annual_margin_interest - result.taxable_st)
        lt_after_margin = max(0.0, result.taxable_lt - margin_remaining)

        common = dict(
            capital_loss_deduction=result.capital_loss_deduction,
            ordinary_income=ordinary_income,
            include_state=True, include_niit=True,
            filing_status=tax_config.get("filing_status", "single").lower(),
            bracket_multiplier=bracket_multiplier,
            state_code=tax_config.get("state", "CA"))
        baseline = calculate_comprehensive_tax_v6(
            taxable_st=0, taxable_lt=0, **common)
        with_gains = calculate_comprehensive_tax_v6(
            taxable_st=st_after_margin, taxable_lt=lt_after_margin, **common)

        year_tax = max(0.0, with_gains["total_tax"] - baseline["total_tax"])
        cumulative_tax += year_tax

        st_cf = result.st_loss_cf_out
        lt_cf = result.lt_loss_cf_out

        gains_total = result.taxable_st + result.taxable_lt
        yearly_results.append({
            "year": year,
            "taxable_st": result.taxable_st,
            "taxable_lt": result.taxable_lt,
            "tax": year_tax,
            "st_cf": st_cf,
            "lt_cf": lt_cf,
            "capital_loss_deduction": result.capital_loss_deduction,
            "federal_total": with_gains["federal_total"] - baseline["federal_total"],
            "state_tax": with_gains["state_tax"] - baseline["state_tax"],
            "niit_tax": with_gains["niit_tax"] - baseline["niit_tax"],
            "effective_rate": year_tax / gains_total if gains_total > 0 else 0.0,
        })

    return {
        "total_tax": cumulative_tax,
        "yearly_taxes": yearly_results,
        "total_st_gains": sum(y["taxable_st"] for y in yearly_results),
        "total_lt_gains": sum(y["taxable_lt"] for y in yearly_results),
        "final_cf": {"st": st_cf, "lt": lt_cf},
        "engine_version": "tpu_v1_marginal_rates",
        "used_proper_marginal_rates": True,
        "debug_enabled": debug,
        "income_trajectory": {
            "years": list(range(len(income_path))),
            "income": income_path.tolist(),
            "peak_income": float(np.max(income_path)),
            "retirement_year": years_until_retirement,
        },
    }


def process_monte_carlo_with_wired_engine(
    mc_results: Dict[str, List[Dict]],
    time_horizon_years: int,
    initial_capital: float,
    elections: Optional[TaxpayerElections] = None,
) -> Dict[str, Dict]:
    """Batch-process Monte Carlo results through the wired engine."""
    if elections is None:
        elections = TaxpayerElections()

    results = {}
    for strategy_id, sim_results in mc_results.items():
        pre_tax, post_tax, details = [], [], []
        for sim in sim_results:
            pre = sim["Final_Wealth"]
            pre_tax.append(pre)
            trade_list = sim.get("Trade_List")
            if trade_list:
                tax_result = process_trades_with_wired_engine(
                    trades=trade_list, time_horizon_years=time_horizon_years,
                    elections=elections, initial_capital=initial_capital,
                    tax_config={"filing_status": "single", "state": "CA"})
                post_tax.append(pre - tax_result["total_tax"])
                details.append(tax_result)
            else:
                post_tax.append(pre)
                details.append(None)

        pre_med = float(np.median(pre_tax))
        post_med = float(np.median(post_tax))
        pre_cagr = (pre_med / initial_capital) ** (1 / time_horizon_years) - 1
        post_cagr = (post_med / initial_capital) ** (1 / time_horizon_years) - 1
        tax_drag = pre_med - post_med
        valid = [d for d in details if d is not None]
        avg_final_cf = (np.mean([d["final_cf"]["st"] + d["final_cf"]["lt"]
                                 for d in valid]) if valid else 0.0)

        results[strategy_id] = {
            "pre_tax_median_wealth": pre_med,
            "post_tax_median_wealth": post_med,
            "pre_tax_median_cagr": pre_cagr,
            "post_tax_median_cagr": post_cagr,
            "median_tax_drag": tax_drag,
            "tax_drag_pct": tax_drag / pre_med * 100 if pre_med > 0 else 0.0,
            "avg_final_cf": float(avg_final_cf),
            "elections_used": elections.capital_loss_strategy.value,
        }
    return results


def generate_ultimate_report(results: Dict[str, Dict],
                             initial_capital: float, horizon: int) -> None:
    """Ranked Roth/taxable report (reference integration.py:641-719)."""
    print("\n" + "=" * 100)
    print(f"{horizon}-YEAR HORIZON - WIRED TAX ENGINE (PyTorch port)")
    print("=" * 100)

    print("\n> ROTH IRA COMPATIBLE (Tax-Free)")
    print("-" * 100)
    roth = sorted((
        {"id": sid, "median": r["pre_tax_median_wealth"],
         "cagr": r["pre_tax_median_cagr"]}
        for sid, r in results.items() if sid in cfg.ROTH_IDS),
        key=lambda x: x["median"], reverse=True)
    print(f"{'Rank':<6} {'ID':<6} {'Median$':>14} {'CAGR':>10}")
    for i, row in enumerate(roth):
        print(f"{i + 1:<6} {row['id']:<6} ${row['median']:>13,.0f} "
              f"{row['cagr'] * 100:>9.2f}%")

    print("\n> TAXABLE BROKERAGE (Wired Engine)")
    print("-" * 100)
    taxable = sorted((
        {"id": sid, "post_median": r["post_tax_median_wealth"],
         "post_cagr": r["post_tax_median_cagr"], "tax_drag": r["tax_drag_pct"],
         "final_cf": r.get("avg_final_cf", 0)}
        for sid, r in results.items() if sid in cfg.TAXABLE_IDS),
        key=lambda x: x["post_median"], reverse=True)
    print(f"{'Rank':<6} {'ID':<6} {'Post-Tax$':>14} {'Post-CAGR':>11} "
          f"{'Tax Drag':>10} {'Final CF':>12}")
    for i, row in enumerate(taxable):
        print(f"{i + 1:<6} {row['id']:<6} ${row['post_median']:>13,.0f} "
              f"{row['post_cagr'] * 100:>10.2f}% {row['tax_drag']:>9.2f}% "
              f"${row['final_cf']:>11,.0f}")
    print("=" * 100)
