"""Journal emission -> reference-format trade lists (NumPy).

Port of ``letf_tpu/strategies/host.py::trades_from_emission``: the
reference's ``TradeJournal`` rule (letf/trade.py:6-91: a trade is the
share difference between the target and the held position, skipped below
0.001 shares) replayed over the engine's per-day journal emission. The
JAX package's ``letf_tpu.strategies`` imports jax in its ``__init__``, so
the port carries these few lines itself.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from letf_tpu_torch import config as cfg


def trades_from_emission(tj_alloc, tj_value, tj_price, tj_asset,
                         trial: int, strategy_col: int) -> List[Dict]:
    """The strategy engine's per-day journal emission ([S, B, N_TAX] host
    arrays) -> reference trade dicts for one (trial, taxable column) by
    the TradeJournal's share-exact rule (column 0 = S7 ... 12 = S19): the
    reference's arithmetic on the same Python floats and the dicts of its
    ``get_full_trades``, built directly (a 30-year column holds thousands
    of trades)."""
    alloc = np.asarray(tj_alloc[:, trial, strategy_col])
    # Only the journal's non-NaN days log a change.
    days = np.flatnonzero(~np.isnan(alloc))
    value = np.asarray(tj_value[days, trial, strategy_col]).tolist()
    price = np.asarray(tj_price[days, trial, strategy_col]).tolist()
    asset = np.asarray(tj_asset[days, trial, strategy_col]).tolist()
    names = cfg.ASSET_NAMES
    positions: Dict[str, float] = {}
    trades = []
    for day, a, v, p, k in zip(days.tolist(), alloc[days].tolist(), value,
                               price, asset):
        if p <= 0:
            continue
        name = names[int(k)]
        target = a * v / p
        change = target - positions.get(name, 0.0)
        if abs(change) < 0.001:
            continue
        shares = abs(change)
        trades.append({"day_index": day, "asset": name,
                       "action": "BUY" if change > 0 else "SELL",
                       "shares": shares, "price": p,
                       "dollar_amount": shares * p})
        positions[name] = target
    return trades
