"""Tax-lot selection methods (taxpayer elections), on the host.

The port's copy of ``letf_tpu/tax/lot_selection.py`` (host Python):
positions are dicts with keys shares, adjusted_price, original_day (plus
anything else the integration layer attaches); each selector returns the
ordered list of lot indices to consume. The device form of the same
elections is ``tax/device_bridge.py``'s election scan.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from letf_tpu_torch.tax.engine import LotSelectionMethod

_EPS = 0.001


def _take_in_order(positions: List[Dict], order, shares_needed: float) -> List[int]:
    selected = []
    remaining = shares_needed
    for i in order:
        if remaining <= _EPS:
            break
        if positions[i]["shares"] > _EPS:
            selected.append(i)
            remaining -= positions[i]["shares"]
    return selected


def select_lot_fifo(positions: List[Dict], shares_needed: float) -> List[int]:
    """Oldest lots first."""
    return _take_in_order(positions, range(len(positions)), shares_needed)


def select_lot_lifo(positions: List[Dict], shares_needed: float) -> List[int]:
    """Newest lots first."""
    return _take_in_order(positions, range(len(positions) - 1, -1, -1), shares_needed)


def select_lot_hifo(positions: List[Dict], shares_needed: float) -> List[int]:
    """Highest cost basis first (minimizes realized gains)."""
    live = [i for i, p in enumerate(positions) if p["shares"] > _EPS]
    live.sort(key=lambda i: positions[i]["adjusted_price"], reverse=True)
    return _take_in_order(positions, live, shares_needed)


def select_lot_lofo(positions: List[Dict], shares_needed: float) -> List[int]:
    """Lowest cost basis first (realizes gains early)."""
    live = [i for i, p in enumerate(positions) if p["shares"] > _EPS]
    live.sort(key=lambda i: positions[i]["adjusted_price"])
    return _take_in_order(positions, live, shares_needed)


def _split_by_term(positions: List[Dict], sale_day: int, lt_threshold: int):
    lt, st = [], []
    for i, p in enumerate(positions):
        if p["shares"] <= _EPS:
            continue
        holding = sale_day - p["original_day"]
        (lt if holding > lt_threshold else st).append((i, holding))
    return lt, st


def select_lot_ltfo(positions: List[Dict], shares_needed: float,
                    sale_day: int, lt_threshold: int = 365) -> List[int]:
    """Long-term lots first (preferential rates), longest-held first."""
    lt, st = _split_by_term(positions, sale_day, lt_threshold)
    lt.sort(key=lambda x: x[1], reverse=True)
    st.sort(key=lambda x: x[1], reverse=True)
    order = [i for i, _ in lt + st]
    return _take_in_order(positions, order, shares_needed)


def select_lot_stfo(positions: List[Dict], shares_needed: float,
                    sale_day: int, lt_threshold: int = 365) -> List[int]:
    """Short-term lots first, shortest-held first."""
    lt, st = _split_by_term(positions, sale_day, lt_threshold)
    st.sort(key=lambda x: x[1])
    lt.sort(key=lambda x: x[1])
    order = [i for i, _ in st + lt]
    return _take_in_order(positions, order, shares_needed)


def select_lot_mintax(positions: List[Dict], shares_needed: float,
                      sale_day: int, sale_price: float,
                      lt_threshold: int = 365,
                      marginal_st_rate: float = 0.37,
                      marginal_lt_rate: float = 0.20) -> List[int]:
    """Select lots in ascending per-share tax impact order."""
    impact = []
    for i, p in enumerate(positions):
        if p["shares"] <= _EPS:
            continue
        gain_per_share = sale_price - p["adjusted_price"]
        is_lt = (sale_day - p["original_day"]) > lt_threshold
        if gain_per_share >= 0:
            rate = marginal_lt_rate if is_lt else marginal_st_rate
        else:
            rate = marginal_st_rate  # losses offset highest-rate gains first
        impact.append((i, gain_per_share * rate))
    impact.sort(key=lambda x: x[1])
    return _take_in_order(positions, [i for i, _ in impact], shares_needed)


def get_lots_to_sell(positions: List[Dict], shares_needed: float,
                     method: LotSelectionMethod, sale_day: int,
                     sale_price: Optional[float] = None) -> List[int]:
    """Dispatch to the elected lot-selection method."""
    if method == LotSelectionMethod.FIFO:
        return select_lot_fifo(positions, shares_needed)
    if method == LotSelectionMethod.LIFO:
        return select_lot_lifo(positions, shares_needed)
    if method == LotSelectionMethod.HIFO:
        return select_lot_hifo(positions, shares_needed)
    if method == LotSelectionMethod.LOFO:
        return select_lot_lofo(positions, shares_needed)
    if method == LotSelectionMethod.LTFO:
        return select_lot_ltfo(positions, shares_needed, sale_day)
    if method == LotSelectionMethod.STFO:
        return select_lot_stfo(positions, shares_needed, sale_day)
    if method in (LotSelectionMethod.MINTAX, LotSelectionMethod.SPEC_ID):
        if sale_price is None:
            return select_lot_hifo(positions, shares_needed)
        return select_lot_mintax(positions, shares_needed, sale_day, sale_price)
    return select_lot_fifo(positions, shares_needed)
