"""The plain reference of the sampled post-tax tables
(``reporting.sampled_post_tax_tables`` of the port): for chosen (report
row, taxable strategy) pairs, the row's pre-tax final wealth and the
strategy's exact total tax, recomputed on the host from the seed. It
imports nothing of the port (``letf_tpu_torch``), of the JAX package
(``letf_tpu``) or of ``jax``.

- ``emission.py``: the row's path by the cell's plain institutional
  engine and K5's plain loop in NumPy, then frozen copies of the port's
  plain CPU emitting route (signals, the 19 strategies with the taxable
  ones' daily journal: allocation, equity, price, asset);
- ``tracker.py``: frozen copies of the JAX package's host tracker (the
  trade journal, the wash-sale pass, FIFO lots, yearly activity) and the
  wired engine's year loop;
- ``statute.py``: frozen copies of its statute (netting with
  carryforwards, federal, LTCG stacked, state, NIIT, the 2024 tables) and
  its wired income path.

Where the program departs from this chain, by design:

- the dust rule: the host tracker skips a change of under 0.001 shares
  (``TradeJournal``) and drops lots below 0.001 shares; the program's
  device bridge (K7, K8) keeps every change, so a list with many tiny
  rebalances differs by their gains and by the trade count that sets the
  margin-interest proxy;
- the bridge's FIFO merge against the host tracker's lot walk: on some
  30-year lists they disagree by up to 1.79e-3 of gross traded (S12,
  measured on the JAX package's own bridge and host chain, which are the
  source's).


One departure the reference takes over from the program: the bridge
prices every journal day at no less than ``PRICE_FLOOR`` (1e-8 dollars,
its guard on share counts), where the host tracker takes the price as it
is. A 30-year leveraged ETF's price path falls below it in most trials
(to 1e-37 in a crash run) while the strategies trade on (their returns
do not depend on the price level); trades priced below the floor then
realize no gain in the bridge, and the two taxes part by up to several
times. The reference prices its journal at the floor too, so that the
comparison holds the program to its own semantics; ``floored`` counts a
pair's journal days priced below the floor.

The gaps of a tax are therefore read against the row's gross traded
dollars.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import config as cfg
from benchmark.reference.post_tax import emission, statute, tracker

PRICE_FLOOR = 1e-8        # the device bridge's least price of a day

DEFAULT_TAX_CONFIG = {"state": "CA", "ordinary_income": 150000,
                      "filing_status": "single",
                      "years_until_retirement": None,
                      "retirement_income": None}


def income_path(tax_config: Optional[Dict], years: int) -> np.ndarray:
    tc = tax_config or DEFAULT_TAX_CONFIG
    return statute.simulate_wired_income_path(
        tc.get("ordinary_income", 150000), years,
        years_until_retirement=tc.get("years_until_retirement"),
        retirement_income=tc.get("retirement_income"), seed=42)


def pair_taxes(pairs: Iterable[Tuple[int, str]], seed: int, years: int,
               config: dict, glue: torch.dtype = torch.float32
               ) -> Dict[str, np.ndarray]:
    """For each (row, sid) pair: ``wealth`` (the row's pre-tax final
    wealth of strategy sid by the plain engine), ``replay_wealth`` (by
    the emitting replay), ``tax`` (its exact total tax), ``gross``
    (its trades' dollars), ``trades`` (their count) and ``floored`` (its
    journal days priced below ``PRICE_FLOOR``), as [k] arrays."""
    pairs = [(int(r), s) for r, s in pairs]
    rows = np.unique([r for r, _ in pairs])
    rep = emission.replay(rows, seed, years, config, glue)
    tc = config.get("tax_config") or DEFAULT_TAX_CONFIG
    inc = income_path(tc, int(years))
    out = {k: np.zeros(len(pairs)) for k in ("wealth", "replay_wealth",
                                             "tax", "gross", "trades",
                                             "floored")}
    for i, (r, sid) in enumerate(pairs):
        b = int(np.searchsorted(rows, r))
        c = cfg.TAXABLE_IDS.index(sid)
        trades = tracker.trades_from_emission(
            rep.tj_alloc[:, b, c], rep.tj_value[:, b, c],
            rep.tj_price[:, b, c], rep.tj_asset[:, b, c], PRICE_FLOOR)
        out["wealth"][i] = rep.engine_wealth[b, cfg.STRATEGY_INDEX[sid]]
        out["replay_wealth"][i] = rep.final_wealth[b,
                                                   cfg.STRATEGY_INDEX[sid]]
        out["tax"][i] = tracker.total_tax(
            trades, int(years), inc, float(cfg.INITIAL_CAPITAL),
            tc.get("filing_status", "single").lower(),
            tc.get("state", "CA"))
        out["gross"][i] = sum(t["dollar_amount"] for t in trades)
        out["trades"][i] = len(trades)
        logged = ~np.isnan(rep.tj_alloc[:, b, c])
        out["floored"][i] = int((rep.tj_price[logged, b, c]
                                 < PRICE_FLOOR).sum())
    return out
