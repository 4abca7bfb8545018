"""Host-side (NumPy) strategy engine: the host strategy oracle.

Port of ``letf_tpu/strategies/host.py`` on the port's day frame
(``utils/frame.Frame``; no pandas). Three roles:
1. Parity oracle for the batched engine (``strategies/engine.py``, kernel
   K4): tests compare per path.
2. Historical backtests: ``historical.run_strategy_on_history`` runs a
   strategy on the market history with it (the reference's
   historical.py:96-102).
3. Trade-journal construction for the tax engine: ``TradeJournal`` and
   ``trades_from_emission``, which turns the engine's per-day journal
   emission into reference-format trade dicts.

``run_strategy_fixed`` mirrors the reference's behavior branch by branch
(letf/strategy.py:55-1277), including its quirks: S7 earns no cash on the
idle fraction, S8 charges no costs, S9 freezes on NaN-signal days, S19's
5% rebalance threshold, S6's single-day embedded-leverage estimate. The
pandas operations of the JAX package's copy are ``utils/frame``'s, equal
to pandas 3.0's bit for bit except the rolling skew (S14, S17), which
agrees to a few ulps and is read only through comparisons. It returns the
equity curve as a float64 numpy array where the JAX package returns a
``pd.Series`` on the frame's index (the same values).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.utils.frame import (
    Frame,
    bfill,
    diff,
    fillna,
    pct_change,
    rolling_mean,
    rolling_skew,
    rolling_std,
    rolling_sum,
    shift,
)
from letf_tpu_torch.utils.regime import infer_regime_from_vix


# ---------------------------------------------------------------------------
# Trade journal (reference letf/trade.py:6-91)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trade:
    day_index: int
    asset: str
    action: str
    shares: float
    price: float
    dollar_amount: float


class TradeJournal:
    """Share-exact position tracking: trades are recorded as the share
    difference between the target and the currently held position."""

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
        action = "BUY" if change > 0 else "SELL"
        shares = abs(change)
        self.trades.append(Trade(day, asset, action, shares, price,
                                 shares * price))
        self.positions[asset] = target_shares

    def get_summary(self) -> dict:
        if not self.trades:
            return {"count": 0, "volume": 0}
        return {"count": len(self.trades),
                "volume": sum(t.dollar_amount for t in self.trades)}

    def get_full_trades(self) -> List[Dict]:
        return [dataclasses.asdict(t) for t in self.trades]


def compute_transaction_costs(daily_ret: float, regime: int, leverage: float,
                              trade_size_pct: float = 0.0) -> float:
    """Regime-dependent spread + rebalance cost + sqrt market impact."""
    spread_cost = cfg.BASE_SPREAD_BPS.get(regime, 2.0) / 10000.0
    rebalance_cost = cfg.REBALANCE_COST_PER_DOLLAR * leverage * abs(daily_ret)
    if trade_size_pct > 0.01:
        regime_multiplier = {0: 1.0, 1: 2.0, 2: 4.0}.get(regime, 1.0)
        size_multiplier = 1 + np.sqrt(trade_size_pct) * 2
        market_impact = spread_cost * (regime_multiplier - 1) * (size_multiplier - 1)
    else:
        market_impact = 0.0
    return spread_cost + rebalance_cost + market_impact


_SPREAD = 0.0003


def _vol_family_loop(df, ret_col, alloc_fn, apply_costs, trade_journal,
                     asset: str, include_cash: bool = True,
                     threshold: float = 1e-4):
    """Shared per-day loop for the vol-targeting strategy family."""
    n = len(df)
    equity = np.full(n, cfg.INITIAL_CAPITAL)
    r = df[ret_col]
    cash = df["Cash_Ret"]
    price = df[f"{asset}_Price"]
    prev_alloc = 0.0
    num_trades = 0
    for i in range(1, n):
        alloc = alloc_fn(i, prev_alloc)
        if alloc is None:  # skip day (S9 NaN semantics)
            equity[i] = equity[i - 1]
            continue
        turnover = abs(alloc - prev_alloc)
        if turnover > threshold:
            num_trades += 1
            if trade_journal is not None:
                trade_journal.log_allocation_change(
                    day=i, asset=asset, prev_allocation=prev_alloc,
                    new_allocation=alloc, portfolio_value=equity[i - 1],
                    price=price[i])
            cost = turnover * _SPREAD
        else:
            cost = 0.0
        prev_alloc = alloc
        if include_cash:
            ret = alloc * r[i] + (1 - alloc) * cash[i]
        else:
            ret = alloc * r[i]
        if apply_costs:
            ret -= cost
        equity[i] = equity[i - 1] * (1 + ret)
    return equity, num_trades


def _lagged_std(x, window: int, min_periods: Optional[int] = None):
    """``x.rolling(window, min_periods).std().shift(1)``."""
    return shift(rolling_std(x, window, min_periods))


def _lagged_mean(x, window: int, min_periods: Optional[int] = None):
    """``x.rolling(window, min_periods).mean().shift(1)``."""
    return shift(rolling_mean(x, window, min_periods))


def _negative_part(x):
    """``x.where(x < 0, 0)``."""
    return np.where(x < 0, x, 0.0)


def run_strategy_fixed(df: Frame, strategy_id: str, regime_path,
                       correlation_matrices=None, apply_costs: bool = True,
                       trade_journal: Optional[TradeJournal] = None):
    """Run one strategy over a simulated or historical frame.

    Returns (equity curve [n] float64 numpy, num_trades); the JAX package
    returns the curve as a ``pd.Series`` on the frame's index. When
    ``regime_path`` is None or mismatched, regimes are inferred from VIX
    (probabilistic stress model with hysteresis) exactly like the
    reference bug-fix path.
    """
    if regime_path is None or len(regime_path) != len(df):
        if "VIX" in df:
            realized_vol = (fillna(bfill(rolling_std(df["SPY_Ret"], 20, 5)),
                                   0) * np.sqrt(252))
            term_spread = None
            if "TNX" in df and "IRX" in df:
                term_spread = df["TNX"] - df["IRX"]
            regime_path = infer_regime_from_vix(
                df["VIX"], realized_vol, term_spread)
        else:
            regime_path = np.zeros(len(df), dtype=int)

    config = cfg.STRATEGIES[strategy_id]
    stype = config["type"]
    n = len(df)
    sq = np.sqrt(252)

    # ---- benchmarks ----
    if stype == "benchmark":
        ret_col = f"{config['asset']}_Ret"
        if ret_col not in df:
            return np.full(n, cfg.INITIAL_CAPITAL), 0
        return cfg.INITIAL_CAPITAL * np.cumprod(1 + fillna(df[ret_col], 0)), 0

    # ---- SMA state machines ----
    if stype in ("sma", "sma_band"):
        asset = config["asset"]
        ret_col = f"{asset}_Ret"
        if ret_col not in df:
            return np.full(n, cfg.INITIAL_CAPITAL), 0
        period = config.get("sma_period", 200)
        price_prev = shift(df["SPY_Price"])
        sma_prev = _lagged_mean(df["SPY_Price"], period, 1)
        if stype == "sma":       # NaN compares false: the fillna(False)
            buy = price_prev >= sma_prev
            sell = price_prev < sma_prev
        else:
            band = config.get("band", 0.02)
            buy = price_prev >= sma_prev * (1 - band)
            sell = price_prev < sma_prev * (1 - band)

        position = np.zeros(n, dtype=int)
        for i in range(1, n):
            if position[i - 1] == 0:
                position[i] = 1 if buy[i] else 0
            else:
                position[i] = 0 if sell[i] else 1
        flips = np.abs(np.diff(position, prepend=position[0]))
        num_trades = int(flips.sum())

        equity = np.full(n, float(cfg.INITIAL_CAPITAL))
        lev = cfg.ASSETS[asset].leverage
        r = df[ret_col]
        cash = df["Cash_Ret"]
        for i in range(1, n):
            ret = r[i] if position[i] == 1 else cash[i]
            if apply_costs and flips[i] > 0:
                ret -= compute_transaction_costs(r[i], int(regime_path[i]), lev)
            equity[i] = equity[i - 1] * (1 + ret)
        return equity, num_trades

    # ---- portfolio with leverage-drift turnover ----
    if stype == "portfolio":
        weights = config["assets"]
        freq = config.get("rebalance_freq", 21)
        positions = {a: cfg.INITIAL_CAPITAL * w for a, w in weights.items()}
        emb = {a: cfg.ASSETS[a].leverage for a in weights}
        equity = np.full(n, float(cfg.INITIAL_CAPITAL))
        num_trades = 0
        rcols = {a: df[f"{a}_Ret"] for a in weights}
        for i in range(1, n):
            for a in weights:
                ret = rcols[a][i]
                positions[a] *= (1 + ret)
                lev = cfg.ASSETS[a].leverage
                if lev > 1.0:
                    u = ret / lev
                    if abs(1 + lev * u) > 0.01:
                        emb[a] = lev * (1 + u) / (1 + lev * u)
                    else:
                        emb[a] = lev
                else:
                    emb[a] = 1.0
            total = sum(positions.values())
            equity[i] = total
            if i % freq == 0:
                cw = {a: positions[a] / total for a in weights}
                w_turn = sum(abs(cw[a] - weights[a]) for a in weights)
                lev_turn = sum(abs(emb[a] - cfg.ASSETS[a].leverage)
                               / cfg.ASSETS[a].leverage * cw[a] for a in weights)
                tot = w_turn + lev_turn
                if apply_costs and tot > 0.01:
                    total -= tot * cfg.REBALANCE_COST_PER_DOLLAR * total
                    equity[i] = total
                positions = {a: total * w for a, w in weights.items()}
                emb = {a: cfg.ASSETS[a].leverage for a in weights}
                num_trades += len(weights)
        return equity, num_trades

    # ---- S7 vol targeting (no cash blend; unshifted vol) ----
    if stype == "vol_targeting":
        asset = config["asset"]
        rv = rolling_std(df[f"{asset}_Ret"], config.get("lookback", 20)) * sq
        target = config["target_vol"]

        def alloc7(i, prev):
            v = rv[i]
            if np.isnan(v) or v < 0.01:
                return 1.0
            return float(np.clip(target / v, 0.2, 2.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc7, apply_costs,
                                trade_journal, asset, include_cash=False)

    # ---- S8 composite (no costs) ----
    if stype == "composite":
        risky, safe = config["asset"], config["defensive_asset"]
        sma_v = rolling_mean(df["SPY_Price"], config["sma_period"])
        delta = diff(df["SPY_Price"])
        gain = rolling_mean(np.where(delta > 0, delta, 0.0),
                            config["rsi_period"])
        loss = rolling_mean(-_negative_part(delta), config["rsi_period"])
        with np.errstate(divide="ignore", invalid="ignore"):
            rsi_v = 100 - 100 / (1 + gain / loss)
        price = df["SPY_Price"]
        vix = df["VIX"]
        r_risky = df[f"{risky}_Ret"]
        r_safe = df[f"{safe}_Ret"]
        cash = df["Cash_Ret"]
        p_risky = df[f"{risky}_Price"] if f"{risky}_Price" in df else np.full(n, 100.0)
        p_safe = df[f"{safe}_Price"] if f"{safe}_Price" in df else np.full(n, 100.0)

        equity = np.full(n, float(cfg.INITIAL_CAPITAL))
        pos = "CASH"
        num_trades = 0
        for i in range(1, n):
            score = 0
            if price[i - 1] > sma_v[i - 1]:
                score += 1
            if 40 < rsi_v[i - 1] < 80:
                score += 1
            if vix[i - 1] < config["vix_threshold"]:
                score += 1
            if score == 3:
                ret, target = r_risky[i], "RISKY"
            elif score == 2:
                ret, target = r_safe[i], "SAFE"
            else:
                ret, target = cash[i], "CASH"
            if target != pos:
                num_trades += 1
                if trade_journal is not None:
                    position_map = {"RISKY": (risky, 1.0), "SAFE": (safe, 1.0),
                                    "CASH": ("SPY", 0.0)}
                    trade_asset, new_alloc = position_map[target]
                    _, prev_alloc_val = position_map[pos]
                    ap = p_risky[i] if trade_asset == risky else p_safe[i]
                    trade_journal.log_allocation_change(
                        day=i, asset=trade_asset,
                        prev_allocation=prev_alloc_val,
                        new_allocation=new_alloc,
                        portfolio_value=equity[i - 1], price=ap)
                pos = target
            equity[i] = equity[i - 1] * (1 + ret)
        return equity, num_trades

    # ---- S9 adaptive vol (skips NaN days) ----
    if stype == "adaptive_vol":
        asset = config["asset"]
        rv = _lagged_std(df[f"{asset}_Ret"], config["lookback"]) * sq
        sma = _lagged_mean(df["SPY_Price"], config["sma_period"])
        price_prev = shift(df["SPY_Price"])

        def alloc9(i, prev):
            v, s, p = rv[i], sma[i], price_prev[i]
            if np.isnan(v) or np.isnan(s) or v < 0.001:
                return None
            target = config["bull_target"] if p > s else config["bear_target"]
            return float(np.clip(target / v, 0.0, 1.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc9, apply_costs,
                                trade_journal, asset)

    # ---- S10 downside vol ----
    if stype == "downside_vol":
        asset = config["asset"]
        neg = _negative_part(df[f"{asset}_Ret"])
        dv = _lagged_std(neg, config["lookback"]) * sq
        target = config["target_downside_vol"]

        def alloc10(i, prev):
            v = dv[i]
            if np.isnan(v) or v < 0.001:
                return 1.0
            return float(np.clip(target / v, 0.0, 1.5))

        return _vol_family_loop(df, f"{asset}_Ret", alloc10, apply_costs,
                                trade_journal, asset)

    # ---- S11 convex vol ----
    if stype == "convex_vol":
        asset = config["asset"]
        rv = _lagged_std(df[f"{asset}_Ret"], 20, 1) * sq
        sma = _lagged_mean(df["SPY_Price"], config["sma_period"], 1)
        price = df["SPY_Price"]
        target, p_val = config["target_vol"], config["power"]

        def alloc11(i, prev):
            v = rv[i]
            if np.isnan(v) or v < 0.001:
                v = 0.5
            alloc = target / v
            if price[i - 1] > sma[i]:
                alloc = alloc ** p_val
            return float(np.clip(alloc, 0.0, 1.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc11, apply_costs,
                                trade_journal, asset)

    # ---- S12 vol velocity ----
    if stype == "vol_velocity":
        asset = config["asset"]
        vs = _lagged_std(df[f"{asset}_Ret"], 20, 1) * sq
        vf = _lagged_std(df[f"{asset}_Ret"], 5, 1) * sq
        target = config["target_vol"]

        def alloc12(i, prev):
            v = max(vs[i], vf[i])  # NaN propagates like python max on floats
            if np.isnan(v) or v < 0.001:
                v = 0.5
            return float(np.clip(target / v, 0.0, 1.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc12, apply_costs,
                                trade_journal, asset)

    # ---- S13 vol-of-vol momentum ----
    if stype == "vol_mom":
        asset = config["asset"]
        vs = _lagged_std(df[f"{asset}_Ret"], 20, 1) * sq
        vm = pct_change(vs, 5)
        target = config["target_vol"]

        def alloc13(i, prev):
            v = vs[i]
            if np.isnan(v) or v < 0.001:
                v = 0.5
            alloc = target / v
            if not np.isnan(vm[i]) and vm[i] < -0.10:
                alloc *= 1.2
            if not np.isnan(vm[i]) and vm[i] > 0.10:
                alloc *= 0.7
            return float(np.clip(alloc, 0.0, 1.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc13, apply_costs,
                                trade_journal, asset)

    # ---- S14 skew convex ----
    if stype == "skew_convex":
        asset = config["asset"]
        skew = shift(rolling_skew(df[f"{asset}_Ret"], 60, 1))
        rv = _lagged_std(df[f"{asset}_Ret"], 20, 1) * sq
        target = config["target_vol"]

        def alloc14(i, prev):
            v, s = rv[i], skew[i]
            if np.isnan(v) or v < 0.001:
                v = 0.5
            alloc = target / v
            if not np.isnan(s) and s > 0:
                alloc = alloc ** 1.3
            elif not np.isnan(s) and s < -0.5:
                alloc *= 0.5
            return float(np.clip(alloc, 0.0, 1.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc14, apply_costs,
                                trade_journal, asset)

    # ---- S15 meta ensemble ----
    if stype == "meta_ensemble":
        asset = config["asset"]
        dv = _lagged_std(_negative_part(df[f"{asset}_Ret"]), 20, 1) * sq
        sma = _lagged_mean(df["SPY_Price"], 200, 1)
        vf = _lagged_std(df[f"{asset}_Ret"], 5, 1) * sq
        vs = _lagged_std(df[f"{asset}_Ret"], 20, 1) * sq
        price = df["SPY_Price"]
        target = config["target_vol"]

        def alloc15(i, prev):
            d = dv[i]
            if np.isnan(d) or d < 0.001:
                d = 0.25
            alloc = target / d
            if price[i - 1] > sma[i]:
                alloc = alloc ** 1.2
            if vf[i] > 1.5 * vs[i]:
                alloc *= 0.5
            return float(np.clip(alloc, 0.0, 1.0))

        return _vol_family_loop(df, f"{asset}_Ret", alloc15, apply_costs,
                                trade_journal, asset)

    # ---- S16 crisis alpha ----
    if stype == "regime_asymmetric":
        asset = config["asset"]
        vf = _lagged_std(df[f"{asset}_Ret"], config["lookback_fast"], 1) * sq
        vs = _lagged_std(df[f"{asset}_Ret"], config["lookback_slow"], 1) * sq
        vix = df["VIX"]

        def alloc16(i, prev):
            vr = vf[i] / vs[i]
            crisis = (vix[i] > config["vix_alarm_level"]) or \
                     (not np.isnan(vr) and vr > config["vol_expansion_threshold"])
            target = config["crisis_target_vol"] if crisis else config["base_target_vol"]
            v = vf[i]
            if np.isnan(v) or v < 0.001:
                return 0.5
            return float(np.clip(target / v, 0.0, 1.2))

        return _vol_family_loop(df, f"{asset}_Ret", alloc16, apply_costs,
                                trade_journal, asset)

    # ---- S17 skew-aware Kelly ----
    if stype == "skew_kelly":
        asset = config["asset"]
        ret = df[f"{asset}_Ret"]
        rv = _lagged_std(ret, config["vol_lookback"], 1) * sq
        skew = shift(rolling_skew(ret, config["skew_lookback"], 1))
        dv = _lagged_std(_negative_part(ret), config["vol_lookback"], 1) * sq
        mean_r = _lagged_mean(ret, config["skew_lookback"], 1) * 252
        base = config["base_target_vol"]
        kf = config["kelly_fraction"]

        def alloc17(i, prev):
            vol, d_vol, s, mr = rv[i], dv[i], skew[i], mean_r[i]
            if np.isnan(vol) or vol < 0.001:
                vol = 0.25
            if np.isnan(d_vol) or d_vol < 0.001:
                d_vol = vol * 0.6
            if np.isnan(s):
                s = 0.0
            if np.isnan(mr):
                mr = 0.08
            if s < -0.5:
                eff, pen = d_vol * 1.5, 0.6
            elif s < 0:
                eff, pen = d_vol * 1.2, 0.8
            elif s > 0.5:
                eff, pen = vol * 0.9, 1.2
            else:
                eff, pen = vol, 1.0
            if eff > 0.01:
                kelly = float(np.clip((mr - 0.03) / eff ** 2 * kf, 0.2, 2.0))
            else:
                kelly = 1.0
            return float(np.clip((base / eff) * pen * (kelly / 1.5), 0.0, 1.5))

        return _vol_family_loop(df, f"{asset}_Ret", alloc17, apply_costs,
                                trade_journal, asset)

    # ---- S18 momentum-vol convergence ----
    if stype == "mom_vol_convergence":
        asset = config["asset"]
        mom = shift(rolling_sum(df["SPY_Ret"], config["momentum_lookback"], 1))
        vf = _lagged_std(df[f"{asset}_Ret"], config["vol_fast"], 1) * sq
        vs = _lagged_std(df[f"{asset}_Ret"], config["vol_slow"], 1) * sq
        base = config["base_target_vol"]
        thr = config["momentum_threshold"]

        def alloc18(i, prev):
            m, f, s = mom[i], vf[i], vs[i]
            if np.isnan(m):
                m = 0.0
            if np.isnan(f) or f < 0.001:
                f = 0.30
            if np.isnan(s) or s < 0.001:
                s = 0.25
            mm = 1.3 if m > thr else (1.0 if m > 0 else 0.5)
            vr = f / s
            if vr < 0.8:
                vm_, eff = 1.2, f
            elif vr > 1.3:
                vm_, eff = 0.6, f
            else:
                vm_, eff = 1.0, s
            return float(np.clip(base * mm * vm_ / eff, 0.0, 1.5))

        return _vol_family_loop(df, f"{asset}_Ret", alloc18, apply_costs,
                                trade_journal, asset)

    # ---- S19 conviction compounder (5% rebalance threshold) ----
    if stype == "conviction_compounder":
        asset = config["asset"]
        mom = shift(rolling_sum(df["SPY_Ret"], config["momentum_lookback"], 1))
        dv = _lagged_std(_negative_part(df[f"{asset}_Ret"]),
                         config["vol_lookback"], 1) * sq
        vf = _lagged_std(df[f"{asset}_Ret"], 5, 1) * sq
        vs = _lagged_std(df[f"{asset}_Ret"], 60, 1) * sq
        sma = _lagged_mean(df["SPY_Price"], config["trend_sma"], 1)
        price = df["SPY_Price"]
        base = config["base_target_vol"]
        thr = config["rebalance_threshold"]

        n = len(df)
        equity = np.full(n, float(cfg.INITIAL_CAPITAL))
        r = df[f"{asset}_Ret"]
        cash = df["Cash_Ret"]
        ap = df[f"{asset}_Price"]
        prev_alloc = 0.0
        num_trades = 0
        for i in range(1, n):
            m, d, f, s = mom[i], dv[i], vf[i], vs[i]
            if np.isnan(m):
                m = 0.0
            if np.isnan(d) or d < 0.001:
                d = 0.20
            if np.isnan(f) or f < 0.001:
                f = 0.30
            if np.isnan(s) or s < 0.001:
                s = 0.25
            mom_score = 1.0 if m > 0.15 else (0.7 if m > 0.05 else (0.4 if m > 0 else 0.0))
            trend_score = 0.5 if price[i - 1] > sma[i] else 0.0
            vr = f / s
            vol_score = 0.5 if vr < 0.9 else (0.3 if vr < 1.2 else 0.0)
            conviction = mom_score + trend_score + vol_score
            alloc = float(np.clip((base / d) * (0.3 + conviction * 0.55), 0.0, 1.5))
            turnover = abs(alloc - prev_alloc)
            if turnover > thr:
                num_trades += 1
                if trade_journal is not None:
                    trade_journal.log_allocation_change(
                        day=i, asset=asset, prev_allocation=prev_alloc,
                        new_allocation=alloc, portfolio_value=equity[i - 1],
                        price=ap[i])
                cost = turnover * _SPREAD
                prev_alloc = alloc
            else:
                alloc = prev_alloc
                cost = 0.0
            ret = alloc * r[i] + (1 - alloc) * cash[i]
            if apply_costs:
                ret -= cost
            equity[i] = equity[i - 1] * (1 + ret)
        return equity, num_trades

    # ---- default ----
    return cfg.INITIAL_CAPITAL * np.cumprod(1 + fillna(df["SPY_Ret"], 0)), 0


def sim_df_from_path(path, trial: int) -> Frame:
    """Build a reference-format sim frame (``{asset}_Ret/_Price``, Cash_Ret,
    TLT_Ret/_Price, VIX — engine.py:538-550) from one trial of the port's
    PathOutputs (``etf_ret`` [A, S, B], the others [S, B]; torch tensors on
    any device), copied to the host in float64, for host-side
    strategy/validation code. The index counts days from 1970-01-01 (the
    reference's frame has a RangeIndex)."""
    def host(t):
        return t[..., trial].detach().to("cpu", dtype=torch.float64).numpy()

    etf = host(path.etf_ret)                                  # [A, S]
    df = Frame(index=np.arange(etf.shape[1]).astype("datetime64[D]"))
    for i, name in enumerate(cfg.ASSET_NAMES):
        df[f"{name}_Ret"] = etf[i]
        df[f"{name}_Price"] = np.cumprod(1 + etf[i]) * 100.0
    tlt = host(path.tlt_ret)
    df["TLT_Ret"] = tlt
    df["TLT_Price"] = np.cumprod(1 + tlt) * 100.0
    df["Cash_Ret"] = host(path.cash_ret)
    df["VIX"] = host(path.vix)
    return df



# ---------------------------------------------------------------------------
# Device-emission -> reference-format trade lists
# ---------------------------------------------------------------------------

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
