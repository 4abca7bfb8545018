"""Trade journal and emission -> reference-format trade lists (NumPy).

Port of ``letf_tpu/strategies/host.py``'s ``TradeJournal`` (reference
letf/trade.py:6-91) and ``trades_from_emission``. The JAX package's
``letf_tpu.strategies`` imports jax in its ``__init__``, so the port
carries these few lines itself.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import numpy as np

from letf_tpu_torch import config as cfg


@dataclasses.dataclass
class Trade:
    day_index: int
    asset: str
    action: str
    shares: float
    price: float
    dollar_amount: float


class TradeJournal:
    """Share-exact position tracking: a trade is the share difference
    between the target and the currently held position."""

    def __init__(self):
        self.trades: List[Trade] = []
        self.positions: Dict[str, float] = defaultdict(float)

    def log_allocation_change(self, day: int, asset: str,
                              prev_allocation: float, new_allocation: float,
                              portfolio_value: float, price: float) -> None:
        if price <= 0:
            return
        target_shares = new_allocation * portfolio_value / price
        change = target_shares - self.positions[asset]
        if abs(change) < 0.001:
            return
        shares = abs(change)
        self.trades.append(Trade(day, asset, "BUY" if change > 0 else "SELL",
                                 shares, price, shares * price))
        self.positions[asset] = target_shares

    def get_full_trades(self) -> List[Dict]:
        return [dataclasses.asdict(t) for t in self.trades]


def trades_from_emission(tj_alloc, tj_value, tj_price, tj_asset,
                         trial: int, strategy_col: int) -> List[Dict]:
    """The strategy engine's per-day journal emission ([S, B, N_TAX] host
    arrays) -> reference trade dicts for one (trial, taxable column), by
    an exact TradeJournal replay (column 0 = S7 ... 12 = S19)."""
    journal = TradeJournal()
    alloc = np.asarray(tj_alloc[:, trial, strategy_col])
    value = np.asarray(tj_value[:, trial, strategy_col])
    price = np.asarray(tj_price[:, trial, strategy_col])
    asset = np.asarray(tj_asset[:, trial, strategy_col])
    prev = 0.0
    for day in range(alloc.shape[0]):
        a = alloc[day]
        if np.isnan(a):
            continue
        journal.log_allocation_change(
            day=day, asset=cfg.ASSET_NAMES[int(asset[day])],
            prev_allocation=prev, new_allocation=float(a),
            portfolio_value=float(value[day]), price=float(price[day]))
        prev = float(a)
    return journal.get_full_trades()
