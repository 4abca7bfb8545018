"""Frozen copy of the JAX package's host trade tracker and wired tax chain
(plain Python and NumPy), part of the benchmark's plain post-tax
reference: it imports nothing of the port or the JAX package.

- ``trades_from_emission``: ``letf_tpu/strategies/host.py``'s replay of a
  journal column through ``TradeJournal.log_allocation_change`` (the
  share-exact rule, with its 0.001-share dust rule);
- ``WashSaleTracker``: ``letf_tpu/tax/wash_sale.py``'s two-pass IRC §1091
  analysis (FIFO consumption of pristine lots, the nearest unused buy
  within ±30 days, basis adjustment and §1223(4) holding-period tacking);
- ``yearly_activity``: ``letf_tpu/integration.py::
  _yearly_activity_from_trades`` under the FIFO election
  (``tax/lot_selection.py::select_lot_fifo``);
- ``total_tax``: ``integration.process_trades_with_wired_engine``'s
  year loop (netting with carryforwards, the §163(d) margin-interest
  proxy, 2.5% bracket inflation, the incremental comprehensive tax on the
  wired income path).

Left out: the wash-sale chains and reports (they move no tax), the other
lot elections, the debug and breakdown fields.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from benchmark.reference import config as cfg
from benchmark.reference.post_tax import statute

DAYS_PER_YEAR = 252
LT_THRESHOLD_DAYS = 365
BRACKET_INFLATION = 0.025
MARGIN_RATE = 0.06
WINDOW = 30         # wash-sale window, trading days on each side of a sale
EPS = 0.001         # the tracker's share dust


def trades_from_emission(alloc, value, price, asset,
                         price_floor: float = 0.0) -> List[Dict]:
    """One journal column's [S] host arrays (new allocation, NaN where the
    day logs no change; equity before the day; the journal asset's price;
    its asset index) -> trade dicts, by the TradeJournal's rule, each
    day's price taken at no less than ``price_floor``."""
    positions: Dict[str, float] = defaultdict(float)
    trades = []
    for day in range(alloc.shape[0]):
        a = alloc[day]
        if np.isnan(a):
            continue
        p = max(float(price[day]), price_floor)
        if p <= 0:
            continue
        name = cfg.ASSET_NAMES[int(asset[day])]
        target = float(a) * float(value[day]) / p
        change = target - positions[name]
        if abs(change) < EPS:
            continue
        shares = abs(change)
        trades.append({"day_index": day, "asset": name,
                       "action": "BUY" if change > 0 else "SELL",
                       "shares": shares, "price": p,
                       "dollar_amount": shares * p})
        positions[name] = target
    return trades


class WashSaleTracker:
    """Two-pass wash-sale analyzer over a complete trade list."""

    def __init__(self):
        self.trades: Dict[str, List[Dict]] = defaultdict(list)
        self.basis_adjustments = defaultdict(lambda: defaultdict(float))
        self.holding_period_adjustments = defaultdict(
            lambda: defaultdict(int))

    def record_trade(self, asset: str, day: int, action: str,
                     shares: float, price: float) -> None:
        self.trades[asset].append({"day": day, "action": action.upper(),
                                   "shares": shares, "price": price})

    def process_all_wash_sales(self) -> None:
        for asset, trade_list in self.trades.items():
            ordered = sorted(trade_list, key=lambda t: t["day"])
            buys = [t for t in ordered if t["action"] == "BUY"]
            sells = [t for t in ordered if t["action"] == "SELL"]
            buy_days = np.array([b["day"] for b in buys], dtype=np.int64)
            unused = np.ones(len(buys), dtype=bool)
            # Each sell consumes a prefix of the PRISTINE FIFO lots.
            live = [(b["day"], b["shares"], b["price"]) for b in buys
                    if b["shares"] > EPS]
            lot_days = np.array([d for d, _, _ in live], dtype=np.int64)
            lot_sh = np.array([s for _, s, _ in live])
            lot_px = np.array([p for _, _, p in live])
            cum_sh = np.concatenate([[0.0], np.cumsum(lot_sh)])
            cum_cost = np.concatenate([[0.0], np.cumsum(lot_sh * lot_px)])
            for sell in sells:
                sell_day = sell["day"]
                sell_shares = sell["shares"]
                proceeds = sell_shares * sell["price"]
                if len(live) == 0:
                    cost_basis = 0.0
                else:
                    take_total = min(sell_shares, float(cum_sh[-1]))
                    k = int(np.searchsorted(cum_sh[1:], take_total - EPS,
                                            side="right"))
                    k = min(k, len(live) - 1)
                    cost_basis = float(cum_cost[k]) + (
                        take_total - float(cum_sh[k])) * float(lot_px[k])
                gain_loss = proceeds - cost_basis
                if gain_loss >= 0:
                    continue
                loss_amount = -gain_loss
                dist = np.abs(buy_days - sell_day)
                eligible = (dist <= WINDOW) & (buy_days != sell_day) & unused
                if not eligible.any():
                    continue
                # The nearest replacement buy, the earliest of equidistant.
                rep_idx = int(np.argmin(np.where(eligible, dist,
                                                 WINDOW + 1)))
                rep_buy = buys[rep_idx]
                rep_shares = rep_buy["shares"]
                if rep_shares >= sell_shares:
                    disallowed = loss_amount
                else:
                    disallowed = loss_amount * (rep_shares / sell_shares)
                self.basis_adjustments[asset][rep_buy["day"]] += disallowed
                # The sale consumed a prefix of the lots, in day order:
                # the earliest original day is the first lot's.
                self.holding_period_adjustments[asset][rep_buy["day"]] = (
                    int(lot_days[0]) if len(live) else sell_day)
                unused[rep_idx] = False

    def get_basis_adjustment(self, asset: str, buy_day: int) -> float:
        return self.basis_adjustments[asset][buy_day]

    def get_holding_period_adjustment(self, asset: str, buy_day: int) -> int:
        adjusted = self.holding_period_adjustments[asset].get(buy_day, 0)
        return adjusted if adjusted > 0 else buy_day


def _select_lot_fifo(positions: List[Dict], shares_needed: float):
    selected = []
    remaining = shares_needed
    for i in range(len(positions)):
        if remaining <= EPS:
            break
        if positions[i]["shares"] > EPS:
            selected.append(i)
            remaining -= positions[i]["shares"]
    return selected


def yearly_activity(trades: List[Dict]) -> Dict[int, Dict[str, float]]:
    """The wash-sale pass over the whole list, then FIFO lot realization
    by tax year: {year: {st_gains, st_losses, lt_gains, lt_losses,
    wash_sale_disallowed}}."""
    wash = WashSaleTracker()
    for t in trades:
        wash.record_trade(t["asset"], t["day_index"], t["action"],
                          t["shares"], t["price"])
    wash.process_all_wash_sales()

    activity: Dict[int, Dict[str, float]] = defaultdict(lambda: {
        "st_gains": 0.0, "st_losses": 0.0, "lt_gains": 0.0,
        "lt_losses": 0.0, "wash_sale_disallowed": 0.0})
    positions: Dict[str, List[Dict]] = defaultdict(list)
    buy_days: Dict[str, list] = {}
    for t in trades:
        if t["action"] == "BUY":
            buy_days.setdefault(t["asset"], []).append(t["day_index"])
    buy_days = {a: np.sort(np.asarray(d, dtype=np.int64))
                for a, d in buy_days.items()}

    def any_buy_in_window(asset: str, sale_day: int) -> bool:
        days = buy_days.get(asset)
        if days is None:
            return False
        lo = np.searchsorted(days, sale_day - WINDOW, side="left")
        hi = np.searchsorted(days, sale_day + WINDOW, side="right")
        return bool(np.any(days[lo:hi] != sale_day))

    for trade in trades:
        year = trade["day_index"] // DAYS_PER_YEAR
        asset = trade["asset"]
        day = trade["day_index"]
        if trade["action"] == "BUY":
            shares = trade["shares"]
            basis_adj = wash.get_basis_adjustment(asset, day)
            positions[asset].append({
                "shares": shares,
                "adjusted_price": ((shares * trade["price"] + basis_adj)
                                   / shares if shares > 0
                                   else trade["price"]),
                "original_day": wash.get_holding_period_adjustment(asset,
                                                                   day)})
        else:
            remaining = trade["shares"]
            for lot_idx in _select_lot_fifo(positions[asset], remaining):
                if remaining <= EPS or lot_idx >= len(positions[asset]):
                    continue
                pos = positions[asset][lot_idx]
                if pos["shares"] <= EPS:
                    continue
                sold = min(remaining, pos["shares"])
                holding_days = day - pos["original_day"]
                gain_loss = sold * (trade["price"] - pos["adjusted_price"])
                # Per-sale wash re-check against ANY buy within ±30 days.
                if gain_loss < 0 and any_buy_in_window(asset, day):
                    activity[year]["wash_sale_disallowed"] += abs(gain_loss)
                else:
                    term = "lt" if holding_days > LT_THRESHOLD_DAYS else "st"
                    kind = "gains" if gain_loss > 0 else "losses"
                    activity[year][f"{term}_{kind}"] += abs(gain_loss)
                pos["shares"] -= sold
                remaining -= sold
            positions[asset] = [p for p in positions[asset]
                                if p["shares"] > EPS]
    return activity


def _leverage_ratio(avg_trades_per_year: float) -> float:
    if avg_trades_per_year < 50:
        return 1.2
    if avg_trades_per_year < 150:
        return 1.5
    return 1.8


def total_tax(trades: List[Dict], years: int, income_path: np.ndarray,
              initial_capital: float, filing_status: str = "single",
              state_code: str = "CA") -> float:
    """The wired engine's total tax of one trade list over ``years``."""
    if not trades:
        return 0.0
    activity = yearly_activity(trades)
    base_margin = (initial_capital
                   * (_leverage_ratio(len(trades) / years) - 1.0)
                   * MARGIN_RATE)
    total = 0.0
    st_cf = lt_cf = 0.0
    for year in range(years):
        y = activity[year]
        t_st, t_lt, st_cf, lt_cf, ded = statute.compute_capital_gains(
            y["st_gains"], y["st_losses"], y["lt_gains"], y["lt_losses"],
            st_cf, lt_cf)
        margin = base_margin * (1 + year * 0.15)
        st_after = max(0.0, t_st - margin)
        lt_after = max(0.0, t_lt - max(0.0, margin - t_st))
        common = dict(capital_loss_deduction=ded,
                      ordinary_income=float(income_path[year + 1]),
                      include_state=True, include_niit=True,
                      filing_status=filing_status,
                      bracket_multiplier=(1 + BRACKET_INFLATION) ** year,
                      state_code=state_code)
        base = statute.calculate_comprehensive_tax_v6(
            taxable_st=0, taxable_lt=0, **common)
        with_gains = statute.calculate_comprehensive_tax_v6(
            taxable_st=st_after, taxable_lt=lt_after, **common)
        total += max(0.0, with_gains["total_tax"] - base["total_tax"])
    return total
