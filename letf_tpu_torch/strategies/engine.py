"""All 19 strategies over a path batch, with trade-journal emission.

Port of ``letf_tpu/strategies/engine.py::run_strategies_batch``, plus
``dca_schedule``, ``withdrawal_schedule`` and ``run_all``. Without emission it is kernel
K4 (``ops/strategies.py``, channel mode) on any device, as the JAX
package's production path runs ``pallas_strategies_run``; with emission it
is the XLA scan of the general path, below. Quirks kept as the reference
keeps them: S7 earns no cash on its idle fraction, S8 charges no costs and
journals its target's asset, S9 freezes on NaN-signal days, S19 rebalances
past a 5% threshold and journals its candidate allocation, S6 re-estimates
embedded leverage from each day's return, loop strategies start
compounding on day 1 while the S1-S3 benchmarks include day 0.

Layout ``[S, B]`` (the path's ``etf_ret`` is ``[A, S, B]``); per-strategy
carries are ``[NS, B]``. Every allocation that depends only on the signals
(and the hysteresis states S4/S5, S8 and S9, which are forward fills) is
computed for all days at once; only what is truly sequential goes to the
day loop, ``ops/emit_days.py`` (one CUDA kernel on the card, its torch
twin on the CPU): the equities with their cashflow overlay and ruin floor,
running maxima and drawdowns, S6's sleeves and S19's thresholded
allocation. The elementwise arithmetic is the reference's, so the split
changes no value. Equity is floored at 0, and below float32's smallest
normal it is ruin (0) as in the reference's flush-to-zero arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import rolling as rl
from letf_tpu_torch.ops import strategies as k4
from letf_tpu_torch.ops.emit_days import (  # noqa: F401 (public, as in JAX)
    INITIAL_CAPITAL,
    N_TAX,
    NS,
    S6_LEV,
    SPREAD,
    TAX_OFFSET,
    emit_days,
)
from letf_tpu_torch.strategies.signals import (
    IDX_SPY,
    IDX_SSO,
    IDX_TMF,
    IDX_TQQQ,
    SignalSet,
    compute_signals,
)

TURNOVER_EPS = 1e-4
POS_CASH, POS_SAFE, POS_RISKY = 0, 1, 2


class StrategyResults(NamedTuple):
    final_wealth: torch.Tensor            # [B, NS]
    num_trades: torch.Tensor              # [B, NS] int32
    max_dd: torch.Tensor                  # [B, NS]
    tj_alloc: Optional[torch.Tensor]      # [S, B, N_TAX] new alloc, NaN = no trade
    tj_value: Optional[torch.Tensor]      # [S, B, N_TAX] equity before the day
    tj_price: Optional[torch.Tensor]      # [S, B, N_TAX] journal asset price
    tj_asset: Optional[torch.Tensor]      # [S, B, N_TAX] int8 asset index


def dca_schedule(sim_days: int, monthly_amount: float,
                 start_day: int = 0) -> np.ndarray:
    """Dollar-cost-averaging contributions: +amount every 21 trading days."""
    cf = np.zeros(sim_days)
    cf[start_day::21] = monthly_amount
    if start_day == 0:
        cf[0] = 0.0   # day 0 is the initial-capital day
    return cf


def withdrawal_schedule(sim_days: int, annual_amount: float,
                        monthly: bool = True) -> np.ndarray:
    """Retirement withdrawals: -amount/12 monthly (or -amount yearly)."""
    cf = np.zeros(sim_days)
    if monthly:
        cf[21::21] = -annual_amount / 12.0
    else:
        cf[252::252] = -annual_amount
    return cf


def _prev(x):
    """Value of the day before (NaN on day 0)."""
    return rl.shift1(x, axis=0)


def _nan_to(x, default):
    return torch.where(torch.isnan(x), default, x)


def _after_day(alloc):
    """The carried allocation before each day: the carry is not updated on
    day 0, so it is 0 before days 0 and 1 and alloc[t-1] after."""
    prev = torch.zeros_like(alloc)
    prev[2:] = alloc[1:-1]
    return prev


def _ffill(update, val, init: float):
    """The state after each day of a carry that takes ``val[t]`` on the
    days where ``update[t]`` holds (never on day 0) and keeps its value
    otherwise, starting from ``init``."""
    S = update.shape[0]
    days = torch.arange(S, device=val.device).view(S, *([1] * (val.ndim - 1)))
    upd = update.clone()
    upd[0] = False
    last = torch.cummax(torch.where(upd, days, -1), dim=0).values
    return torch.where(last >= 0, torch.gather(val, 0, last.clamp_min(0)),
                       init)


def _before(state, init: float):
    """The state before each day from the states after each day."""
    return torch.cat([torch.full_like(state[:1], init), state[:-1]])


def _vol_family(alloc, prev, r, cash, apply_costs, include_cash=True):
    """Turnover/cost/return machinery of S7 and S9-S18."""
    turnover = torch.abs(alloc - prev)
    traded = turnover > TURNOVER_EPS
    cost = torch.where(traded, turnover * SPREAD, 0.0)
    ret = alloc * r + (1.0 - alloc) * cash if include_cash else alloc * r
    if apply_costs:
        ret = ret - cost
    return ret, traded


def _bull(p, sma):
    return torch.where(torch.isnan(p) | torch.isnan(sma), False, p > sma)


def _guard(x, eps, default):
    return torch.where(torch.isnan(x) | (x < eps), default, x)


def run_strategies_batch(path, sig: SignalSet, apply_costs: bool = True,
                         emit_trades: bool = False,
                         cashflows=None) -> StrategyResults:
    """Run S1-S19 over a path batch (the port's PathOutputs, ``[S, B]``
    per-day fields). ``cashflows``: optional [S] per-day dollar flows
    applied to every strategy's equity after the day's return. Without
    emission: kernel K4 on the 23 channels of the path and its signals
    (its plain version on the CPU), always in float32, as the TPU kernel
    is: a float64 run on the CPU gets float32 summaries there, where the
    JAX package's float64 scan stays in float64. With emission the scan
    below runs in the path's dtype."""
    if not emit_trades:
        cf = (None if cashflows is None
              else torch.as_tensor(cashflows).to(path.vix.device))
        fw, nt, mdd = k4.strategies_run(k4.channels_from(path, sig),
                                        cashflows=cf, apply_costs=apply_costs)
        return StrategyResults(fw, nt, mdd, None, None, None, None)
    etf = path.etf_ret
    A, S, B = etf.shape
    dt, dev = etf.dtype, etf.device
    r_tqqq, r_spy, r_sso, r_tmf = (etf[i] for i in (IDX_TQQQ, IDX_SPY,
                                                    IDX_SSO, IDX_TMF))
    cash = path.cash_ret
    reg1 = path.regime == 1
    vix = path.vix
    tqqq_price = sig.prices[IDX_TQQQ]
    spy_asset_price = sig.prices[IDX_SPY]
    first = torch.zeros((S, 1), dtype=torch.bool, device=dev)
    first[0] = True

    def pick(cond, a: float, b):
        """torch.where with the constant a in the path's dtype (two Python
        floats would make a float32 tensor, where JAX keeps them weak)."""
        return torch.where(cond, torch.full(cond.shape, a, dtype=dt,
                                            device=dev), b)

    pp = _prev(sig.spy_price)
    sma1 = _prev(sig.spy_sma200_mp1)
    sma200 = _prev(sig.spy_sma200)
    s5, s10, s20, s60 = (_prev(x) for x in (sig.tqqq_std5, sig.tqqq_std10,
                                            sig.tqqq_std20, sig.tqqq_std60))
    d20 = _prev(sig.tqqq_dstd20)
    rets = [None] * NS
    traded = [None] * NS
    jr = {}                   # journal column -> (do, alloc, price, asset)

    # ---- S1-S3 benchmarks ----
    for i, rb in enumerate((r_tqqq, r_spy, r_sso)):
        rets[i] = rb
        traded[i] = torch.zeros_like(rb, dtype=torch.bool)

    # ---- S4/S5 SMA state machines (buy and sell are complementary when
    # the signals exist, so the position is a forward fill of `buy`) ----
    sma_cost = (torch.where(reg1, float(cfg.BASE_SPREAD_BPS[1]),
                            float(cfg.BASE_SPREAD_BPS[0])).to(dt) / 10000.0
                + cfg.REBALANCE_COST_PER_DOLLAR
                * cfg.ASSETS["TQQQ"].leverage * torch.abs(r_tqqq))
    for i, thresh in ((3, sma1), (4, sma1 * (1.0 - 0.02))):
        known = ~(torch.isnan(pp) | torch.isnan(thresh))
        pos = _ffill(known, (pp >= thresh).to(dt), 0.0)
        flip = pos != _before(pos, 0.0)
        ret = torch.where(pos == 1, r_tqqq, cash)
        if apply_costs:
            ret = ret - torch.where(flip, sma_cost, 0.0)
        rets[i], traded[i] = ret, flip

    # ---- S6 60/40 TQQQ/TMF (sleeves in the day loop) ----
    emb = []
    for r6, lev in ((r_tqqq, S6_LEV[0]), (r_tmf, S6_LEV[1])):
        u = r6 / lev
        den = 1.0 + lev * u
        emb.append(torch.where(torch.abs(den) > 0.01,
                               lev * (1.0 + u) / den, lev))
    rets[5] = torch.zeros_like(r_tqqq)
    traded[5] = torch.zeros_like(r_tqqq, dtype=torch.bool)
    traded[5][1:] = (torch.arange(1, S, device=dev) % 21 == 0)[:, None]

    # ---- S7 vol targeting 20% (reads today's signal; no cash) ----
    v7 = sig.tqqq_std20_mp20
    pos7 = torch.where(torch.isnan(v7) | (v7 < 0.01), 1.0,
                       torch.clamp(0.20 / v7, 0.2, 2.0))
    rets[6], traded[6] = _vol_family(pos7, _after_day(pos7), r_tqqq, cash,
                                     apply_costs, include_cash=False)
    jr[0] = (traded[6], pos7, tqqq_price, IDX_TQQQ)

    # ---- S8 composite regime (TQQQ / SPY / cash; no costs) ----
    rsi8, vix8 = _prev(sig.spy_rsi14), _prev(vix)
    sc = (_bull(pp, sma200).to(torch.int32)
          + torch.where(torch.isnan(rsi8), False,
                        (rsi8 > 40) & (rsi8 < 80)).to(torch.int32)
          + torch.where(torch.isnan(vix8), False, vix8 < 25.0).to(torch.int32))
    target8 = torch.where(sc == 3, POS_RISKY,
                          torch.where(sc == 2, POS_SAFE, POS_CASH))
    held8 = torch.full_like(target8, POS_CASH)      # position before day t
    held8[2:] = target8[1:-1]
    traded[7] = (target8 != held8) & ~first
    target8[0] = POS_CASH                            # day 0 keeps cash
    rets[7] = torch.where(target8 == POS_RISKY, r_tqqq,
                          torch.where(target8 == POS_SAFE, r_spy, cash))
    risky8 = target8 == POS_RISKY
    jr[1] = (traded[7], torch.where(target8 == POS_CASH, 0.0, 1.0).to(dt),
             torch.where(risky8, tqqq_price, spy_asset_price),
             torch.where(risky8, IDX_TQQQ, IDX_SPY).to(torch.int8))

    # ---- S9 adaptive vol target (skips NaN days entirely) ----
    v9 = _prev(sig.tqqq_std20_mp20)
    skip9 = torch.isnan(v9) | torch.isnan(sma200) | (v9 < 0.001)
    cand9 = torch.clamp(pick(pp > sma200, 0.35, 0.12)
                        / torch.where(skip9, 1.0, v9), 0.0, 1.0)
    held9 = _ffill(~skip9, cand9, 0.0)
    prev9 = _before(held9, 0.0)
    alloc9 = torch.where(skip9, prev9, cand9)
    ret9, tr9 = _vol_family(alloc9, prev9, r_tqqq, cash, apply_costs)
    rets[8] = torch.where(skip9, 0.0, ret9)
    traded[8] = tr9 & ~skip9
    jr[2] = (traded[8], alloc9, tqqq_price, IDX_TQQQ)

    # ---- S10-S18: vol-family allocations from signals alone ----
    dv10 = _prev(sig.tqqq_dstd20_mp20)
    alloc = {9: torch.where(torch.isnan(dv10) | (dv10 < 0.001), 1.0,
                            torch.clamp(0.15 / dv10, 0.0, 1.5))}
    bull = _bull(pp, sma1)
    a11 = 0.25 / torch.where(_nan_to(s20, 0.5) < 0.001, 0.5,
                             _nan_to(s20, 0.5))
    alloc[10] = torch.clamp(torch.where(bull, a11 ** 1.2, a11), 0.0, 1.0)
    alloc[11] = torch.clamp(0.22 / _guard(torch.maximum(s20, s5), 0.001, 0.5),
                            0.0, 1.0)
    v13 = _guard(s20, 0.001, 0.5)
    vm13 = _prev(sig.tqqq_volmom5)
    a13 = 0.25 / v13
    a13 = torch.where(~torch.isnan(vm13) & (vm13 < -0.10), a13 * 1.2, a13)
    a13 = torch.where(~torch.isnan(vm13) & (vm13 > 0.10), a13 * 0.7, a13)
    alloc[12] = torch.clamp(a13, 0.0, 1.0)
    s14 = _prev(sig.tqqq_skew60)
    a14 = 0.25 / v13
    a14 = torch.where(~torch.isnan(s14) & (s14 > 0), a14 ** 1.3, a14)
    a14 = torch.where(~torch.isnan(s14) & (s14 < -0.5), a14 * 0.5, a14)
    alloc[13] = torch.clamp(a14, 0.0, 1.0)
    a15 = 0.28 / _guard(d20, 0.001, 0.25)
    a15 = torch.where(bull, a15 ** 1.2, a15)
    brake15 = torch.where(torch.isnan(s5) | torch.isnan(s20), False,
                          s5 > 1.5 * s20)
    alloc[14] = torch.clamp(torch.where(brake15, a15 * 0.5, a15), 0.0, 1.0)
    vr16 = s5 / s60
    crisis16 = (vix > 25.0) | torch.where(torch.isnan(vr16), False,
                                          vr16 > 1.5)
    target16 = pick(crisis16, 0.08, 0.30)
    alloc[15] = torch.where(torch.isnan(s5) | (s5 < 0.001), 0.5,
                            torch.clamp(target16 / s5, 0.0, 1.2))
    vol17 = _guard(s20, 0.001, 0.25)
    dvol17 = torch.where(torch.isnan(d20) | (d20 < 0.001), vol17 * 0.6, d20)
    skew17 = _nan_to(_prev(sig.tqqq_skew60), 0.0)
    mean17 = _nan_to(_prev(sig.tqqq_mean60_ann), 0.08)
    eff17 = torch.where(skew17 < -0.5, dvol17 * 1.5,
                        torch.where(skew17 < 0, dvol17 * 1.2,
                                    torch.where(skew17 > 0.5, vol17 * 0.9,
                                                vol17)))
    pen17 = pick(skew17 < -0.5, 0.6,
                 pick(skew17 < 0, 0.8, pick(skew17 > 0.5, 1.2, 1.0)))
    kelly17 = torch.where(eff17 > 0.01,
                          torch.clamp((mean17 - 0.03) / (eff17 ** 2) * 0.7,
                                      0.2, 2.0), 1.0)
    alloc[16] = torch.clamp((0.30 / eff17) * pen17 * (kelly17 / 1.5), 0.0,
                            1.5)
    mom = _nan_to(_prev(sig.spy_sum126), 0.0)
    vf18 = _guard(s10, 0.001, 0.30)
    vs = _guard(s60, 0.001, 0.25)
    mm18 = pick(mom > 0.05, 1.3, pick(mom > 0, 1.0, 0.5))
    vr18 = vf18 / vs
    vm18 = pick(vr18 < 0.8, 1.2, pick(vr18 > 1.3, 0.6, 1.0))
    eff18 = torch.where((vr18 < 0.8) | (vr18 > 1.3), vf18, vs)
    alloc[17] = torch.clamp(0.28 * mm18 * vm18 / eff18, 0.0, 1.5)
    for i, a in alloc.items():
        rets[i], traded[i] = _vol_family(a, _after_day(a), r_tqqq, cash,
                                         apply_costs)
        jr[i - TAX_OFFSET] = (traded[i], a, tqqq_price, IDX_TQQQ)

    # ---- S19 conviction compounder: candidate from signals ----
    dv19 = _guard(d20, 0.001, 0.20)
    vf19 = _guard(s5, 0.001, 0.30)
    mom_score = pick(mom > 0.15, 1.0,
                     pick(mom > 0.05, 0.7, pick(mom > 0, 0.4, 0.0)))
    trend_score = pick(_bull(pp, _prev(sig.spy_sma100_mp1)), 0.5, 0.0)
    vr19 = vf19 / vs
    vol_score = pick(vr19 < 0.9, 0.5, pick(vr19 < 1.2, 0.3, 0.0))
    conviction = mom_score + trend_score + vol_score
    cand19 = torch.clamp((0.32 / dv19) * (0.3 + conviction * 0.55), 0.0, 1.5)

    # ---- the day loop: S19's threshold, S6's sleeves, equities ----
    rets[18] = torch.zeros_like(r_tqqq)      # made in the loop, as S6's
    eq, mdd, value, traded[18] = emit_days(
        torch.stack(rets, dim=1), cand19, r_tqqq, r_tmf, cash, emb[0],
        emb[1], cashflows, apply_costs)
    jr[12] = (traded[18], cand19, tqqq_price, IDX_TQQQ)

    trades = torch.stack(traded, dim=1)[1:].sum(0, dtype=torch.int32)
    trades[5] *= 2                                  # S6 counts 2 per rebalance
    cols = [jr[c] for c in range(N_TAX)]
    return StrategyResults(
        final_wealth=eq.t(), num_trades=trades.t(), max_dd=mdd.t(),
        tj_alloc=torch.stack([torch.where(do & ~first, a, float("nan"))
                              for do, a, _, _ in cols], dim=-1),
        tj_value=value.permute(0, 2, 1),
        tj_price=torch.stack([p for _, _, p, _ in cols], dim=-1),
        tj_asset=torch.stack(
            [torch.full((S, B), a, dtype=torch.int8, device=dev)
             if isinstance(a, int) else a for _, _, _, a in cols], dim=-1))


def run_all(path, apply_costs: bool = True, emit_trades: bool = False,
            cashflows=None) -> StrategyResults:
    """Convenience: compute signals then run the batched strategies."""
    sig = compute_signals(path)
    return run_strategies_batch(path, sig, apply_costs=apply_costs,
                                emit_trades=emit_trades, cashflows=cashflows)
