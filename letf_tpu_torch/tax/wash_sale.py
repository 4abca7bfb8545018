"""IRC §1091 wash-sale tracking with look-back AND look-forward windows.

The port's copy of ``letf_tpu/tax/wash_sale.py`` (host Python and numpy):
- record all trades first, then process (two-pass: look-forward needs future buys)
- a SELL at a loss triggers a wash sale if any not-yet-used BUY of the same
  asset falls within ±30 days (excluding the sale day itself)
- the NEAREST buy is chosen as the replacement lot
- partial disallowance when replacement shares < sold shares
- the disallowed loss is added to the replacement lot's cost basis
- IRC §1223(4) holding-period tacking: the replacement lot inherits the
  earliest original buy day among the lots consumed by the loss sale
- cross-year wash sales and chained wash sales are tracked for reporting
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class WashSaleLot:
    day: int
    shares: float
    price: float
    cost_basis: float
    original_buy_day: int


@dataclasses.dataclass
class WashSaleEvent:
    sale_day: int
    asset: str
    loss_amount: float            # disallowed portion
    replacement_buy_day: int
    replacement_shares: float
    basis_adjustment: float
    original_lot_buy_day: int
    shares_affected: float
    sale_tax_year: int = 0
    replacement_tax_year: int = 0
    is_cross_year: bool = False
    chain_id: int = 0


_WINDOW = 30  # trading days on each side of the sale


class WashSaleTracker:
    """Two-pass wash-sale analyzer over a complete trade list."""

    def __init__(self, days_per_year: int = 252):
        self.days_per_year = days_per_year
        self.trades: Dict[str, List[Dict]] = defaultdict(list)
        self.wash_sale_events: List[WashSaleEvent] = []
        self.disallowed_losses: Dict[str, float] = defaultdict(float)
        self.allowed_losses: Dict[str, float] = defaultdict(float)
        self.basis_adjustments: Dict[str, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        self.holding_period_adjustments: Dict[str, Dict[int, int]] = defaultdict(
            lambda: defaultdict(int))
        self.tacked_shares: Dict[str, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        self.disallowed_by_year: Dict[str, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        self.allowed_by_year: Dict[str, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        self.wash_sale_chains: Dict[int, List[WashSaleEvent]] = defaultdict(list)
        self._next_chain_id = 1
        self.tainted_lots: Dict[str, Dict[int, int]] = defaultdict(
            lambda: defaultdict(int))
        self._processed = False

    # ------------------------------------------------------------------
    def _day_to_tax_year(self, day: int) -> int:
        return day // self.days_per_year

    def record_trade(self, asset: str, day: int, action: str,
                     shares: float, price: float) -> None:
        self.trades[asset].append({
            "day": day,
            "action": action.upper(),
            "shares": shares,
            "price": price,
            "dollar_amount": shares * price,
        })
        self._processed = False

    @staticmethod
    def _nearest_unused(buy_days: List[int], unused: List[bool],
                        sell_day: int) -> int:
        """Index of the nearest unused buy within ±30 days of the sale, not
        on the sale day, or -1; of equidistant buys the earliest (the
        smallest index), as a stable argmin over all buys picks it. Walks
        out from the sale day on each side of the day-ordered buys."""
        left = bisect.bisect_left(buy_days, sell_day) - 1
        while left >= 0 and sell_day - buy_days[left] <= _WINDOW \
                and not unused[left]:
            left -= 1
        if left >= 0 and sell_day - buy_days[left] <= _WINDOW:
            # The smallest unused index of that day.
            j = left - 1
            while j >= 0 and buy_days[j] == buy_days[left]:
                if unused[j]:
                    left = j
                j -= 1
            d_left = sell_day - buy_days[left]
        else:
            left, d_left = -1, _WINDOW + 1
        right = bisect.bisect_right(buy_days, sell_day)
        while right < len(buy_days) and buy_days[right] - sell_day <= _WINDOW \
                and not unused[right]:
            right += 1
        if right < len(buy_days) and buy_days[right] - sell_day <= _WINDOW \
                and buy_days[right] - sell_day < d_left:
            return right
        return left

    # ------------------------------------------------------------------
    def process_all_wash_sales(self) -> None:
        """Identify every wash sale: FIFO lot consumption determines each
        sale's gain/loss; losses scan ±30 days of buys for replacements."""
        for asset, trade_list in self.trades.items():
            if not trade_list:
                continue
            ordered = sorted(trade_list, key=lambda t: t["day"])
            buys = [t for t in ordered if t["action"] == "BUY"]
            sells = [t for t in ordered if t["action"] == "SELL"]

            # Buys are in day order, so the ±30-day window of a sale is a
            # slice of them found by bisection.
            buy_days = [b["day"] for b in buys]
            unused = [True] * len(buys)   # one-use replacements

            # The reference consumes FIFO lots against a PRISTINE copy for
            # every sell (wash_sale.py:209 copies, the live list is never
            # mutated) — so each sell's cost basis is a prefix of the
            # original lots, computable from cumulative sums in O(log n)
            # instead of the reference's O(sells * lots) rebuild.
            live = [(b["day"], b["shares"], b["price"]) for b in buys
                    if b["shares"] > 0.001]
            lot_days = [int(d) for d, _, _ in live]
            lot_sh = np.array([s for _, s, _ in live])
            lot_px = [float(p) for _, _, p in live]
            cum_sh = np.concatenate([[0.0], np.cumsum(lot_sh)]).tolist()
            cum_cost = np.concatenate(
                [[0.0], np.cumsum(lot_sh * np.array(lot_px))]).tolist()
            lot_day_set = set(lot_days)
            # The earliest lot day that carries a taint (taints are only
            # ever set, to chain ids > 0): a sale whose consumed prefix
            # reaches it finds its chain there.
            first_taint = min((d for d, v in self.tainted_lots.get(
                asset, {}).items() if v > 0 and d in lot_day_set),
                default=None)

            for sell in sells:
                sell_day = sell["day"]
                sell_shares = sell["shares"]
                proceeds = sell_shares * sell["price"]

                if len(live) == 0:
                    k = -1
                    cost_basis = 0.0
                else:
                    take_total = min(sell_shares, cum_sh[-1])
                    # Last lot index touched (consumption stops once less
                    # than the reference's 0.001-share dust remains).
                    k = bisect.bisect_right(cum_sh, take_total - 0.001, 1) - 1
                    k = min(k, len(live) - 1)
                    cost_basis = cum_cost[k] + (
                        take_total - cum_sh[k]) * lot_px[k]
                # The sale consumes the prefix 0..k of the pristine FIFO
                # lots (none when k < 0); in day order, so its earliest
                # buy day is lot_days[0].

                gain_loss = proceeds - cost_basis
                if gain_loss >= 0:
                    continue
                loss_amount = -gain_loss

                rep_idx = self._nearest_unused(buy_days, unused, sell_day)
                if rep_idx < 0:
                    self.allowed_losses[asset] += loss_amount
                    continue

                # Nearest replacement buy wins (IRS does not specify; the
                # reference uses nearest — wash_sale.py:263-266).
                rep_buy = buys[rep_idx]

                rep_shares = rep_buy["shares"]
                if rep_shares >= sell_shares:
                    disallowed = loss_amount
                    shares_affected = sell_shares
                else:
                    disallowed = loss_amount * (rep_shares / sell_shares)
                    shares_affected = rep_shares
                allowed = loss_amount - disallowed

                self.disallowed_losses[asset] += disallowed
                self.allowed_losses[asset] += allowed
                self.basis_adjustments[asset][rep_buy["day"]] += disallowed

                # §1223(4) tacking: inherit the earliest consumed lot's day.
                earliest = lot_days[0] if k >= 0 else sell_day
                self.holding_period_adjustments[asset][rep_buy["day"]] = earliest
                self.tacked_shares[asset][rep_buy["day"]] += shares_affected
                unused[rep_idx] = False

                sale_year = self._day_to_tax_year(sell_day)
                rep_year = self._day_to_tax_year(rep_buy["day"])
                cross = sale_year != rep_year
                self.disallowed_by_year[asset][sale_year] += disallowed
                self.allowed_by_year[asset][sale_year] += allowed

                chain_id = (self.tainted_lots[asset].get(lot_days[0], 0)
                            if k >= 0 else 0)
                if chain_id == 0 and cross:
                    chain_id = self._next_chain_id
                    self._next_chain_id += 1
                elif chain_id == 0 and self.wash_sale_events and k >= 0:
                    # The first consumed lot that carries a taint: in day
                    # order, the earliest tainted lot day, if the consumed
                    # prefix reaches it.
                    if first_taint is not None and first_taint <= lot_days[k]:
                        chain_id = self.tainted_lots[asset][first_taint]
                if chain_id > 0:
                    self.tainted_lots[asset][rep_buy["day"]] = chain_id
                    if rep_buy["day"] in lot_day_set and (
                            first_taint is None
                            or rep_buy["day"] < first_taint):
                        first_taint = rep_buy["day"]

                event = WashSaleEvent(
                    sale_day=sell_day, asset=asset, loss_amount=disallowed,
                    replacement_buy_day=rep_buy["day"],
                    replacement_shares=min(rep_shares, sell_shares),
                    basis_adjustment=disallowed,
                    original_lot_buy_day=earliest,
                    shares_affected=shares_affected,
                    sale_tax_year=sale_year, replacement_tax_year=rep_year,
                    is_cross_year=cross, chain_id=chain_id)
                self.wash_sale_events.append(event)
                if chain_id > 0:
                    self.wash_sale_chains[chain_id].append(event)

        self._processed = True

    # ------------------------------------------------------------------
    def check_wash_sale(self, asset: str, sale_day: int, loss_amount: float,
                        all_trades: List[Dict] | None = None) -> float:
        """Single-sale convenience check. Returns the ALLOWED loss."""
        if loss_amount >= 0:
            return loss_amount
        if all_trades is None:
            return loss_amount
        for t in all_trades:
            if (t.get("action", "").upper() == "BUY"
                    and t.get("asset") == asset):
                day = t.get("day", t.get("day_index", 0))
                if abs(day - sale_day) <= _WINDOW and day != sale_day:
                    self.disallowed_losses[asset] += abs(loss_amount)
                    return 0.0
        return loss_amount

    def get_total_disallowed(self) -> float:
        return sum(self.disallowed_losses.values())

    def get_total_allowed(self) -> float:
        return sum(self.allowed_losses.values())

    def get_basis_adjustment(self, asset: str, buy_day: int) -> float:
        return self.basis_adjustments[asset][buy_day]

    def get_holding_period_adjustment(self, asset: str, buy_day: int) -> int:
        adjusted = self.holding_period_adjustments[asset].get(buy_day, 0)
        return adjusted if adjusted > 0 else buy_day

    def get_tacked_shares(self, asset: str, buy_day: int) -> float:
        return self.tacked_shares[asset].get(buy_day, 0.0)

    def get_wash_sale_summary(self) -> Dict:
        if not self._processed:
            self.process_all_wash_sales()
        assets = set(list(self.disallowed_losses) + list(self.allowed_losses))
        return {
            "total_disallowed": self.get_total_disallowed(),
            "total_allowed": self.get_total_allowed(),
            "events_count": len(self.wash_sale_events),
            "by_asset": {a: {"disallowed": self.disallowed_losses[a],
                             "allowed": self.allowed_losses[a]} for a in assets},
            "events": [{"sale_day": e.sale_day, "asset": e.asset,
                        "loss_disallowed": e.loss_amount,
                        "replacement_day": e.replacement_buy_day}
                       for e in self.wash_sale_events],
        }

    def get_disallowed_for_year(self, asset: str, tax_year: int) -> float:
        return self.disallowed_by_year[asset].get(tax_year, 0.0)

    def get_allowed_for_year(self, asset: str, tax_year: int) -> float:
        return self.allowed_by_year[asset].get(tax_year, 0.0)

    def get_chain_info(self, chain_id: int) -> Dict:
        if chain_id not in self.wash_sale_chains:
            return {"chain_id": chain_id, "events": [], "total_disallowed": 0}
        events = self.wash_sale_chains[chain_id]
        return {
            "chain_id": chain_id,
            "events": events,
            "total_disallowed": sum(e.loss_amount for e in events),
            "years_spanned": len({e.sale_tax_year for e in events}),
            "is_cross_year": any(e.is_cross_year for e in events),
        }

    def get_cross_year_summary(self) -> Dict:
        cross = [e for e in self.wash_sale_events if e.is_cross_year]
        by_pair: Dict[str, Dict] = defaultdict(lambda: {"count": 0, "amount": 0.0})
        for e in cross:
            key = f"Y{e.sale_tax_year}->Y{e.replacement_tax_year}"
            by_pair[key]["count"] += 1
            by_pair[key]["amount"] += e.loss_amount
        return {
            "total_cross_year_events": len(cross),
            "total_cross_year_disallowed": sum(e.loss_amount for e in cross),
            "chains_count": len(self.wash_sale_chains),
            "by_year_pair": dict(by_pair),
        }

    def reset(self) -> None:
        self.__init__(days_per_year=self.days_per_year)
