"""Historical validation: simulated distributions vs realized history.

The port's copy of ``letf_tpu/historical.py`` on the history frame
(``utils/frame.Frame``; no pandas):
- validate_monte_carlo_vs_historical / calculate_historical_rolling_cagrs:
  rolling real-data CAGR windows (monthly stride) vs the simulated
  distribution
- find_percentile_rank, calculate_distribution_overlap (histogram
  intersection), calculate_percentile_correlation (Spearman + Pearson of
  percentile curves)
- compare_simulated_vs_historical: 0-100 quality score, percentile rank
  tables and the strategy-on-history backtest
- calculate_rolling_cagrs_all_data + compare_simulated_vs_synthetic_historical:
  the same comparison against the full synthetic-reconstruction history,
  with extreme-event percentile ranking
- backtest_strategies_on_history: all 19 strategies on the rolling
  windows of history in one batch on the device: the windows become the
  trial axis of the port's PathOutputs, the regimes come from
  ``utils/regime.infer_regime_from_vix_batched``, and the strategies run
  through ``strategies/engine.run_strategies_batch`` without emission,
  that is kernel K4 (any window count).

- run_strategy_on_history: one strategy on the history with the host
  strategy oracle (``strategies/host.run_strategy_fixed``, numpy), its
  regimes inferred from VIX.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.utils.device import glue_dtype, resolve_device
from letf_tpu_torch.utils.frame import Frame, bfill, fillna, rolling_std


# ---------------------------------------------------------------------------
# Rolling CAGRs
# ---------------------------------------------------------------------------

def _rolling_cagrs_from_returns(returns: np.ndarray, horizon_years: int,
                                stride: int = 21) -> np.ndarray:
    """All `horizon`-year compound annual growth rates at `stride`-day
    starts: exp(diff of cumulative log1p) ** (1/y) - 1, vectorized."""
    window = int(horizon_years * 252)
    r = np.asarray(returns, float)
    r = np.where(np.isfinite(r), r, 0.0)
    n = len(r)
    if n < window + 1:
        return np.array([])
    logc = np.concatenate([[0.0], np.cumsum(np.log1p(np.clip(r, -0.999, None)))])
    starts = np.arange(0, n - window + 1, stride)
    total = np.exp(logc[starts + window] - logc[starts])
    return total ** (1.0 / horizon_years) - 1.0


def calculate_historical_rolling_cagrs(df: Frame, asset: str,
                                       horizon_years: int,
                                       real_only: bool = True,
                                       stride: int = 21) -> np.ndarray:
    """Rolling CAGRs from the historical frame; ``real_only`` restricts to
    post-inception (non-synthetic) observations (historical.py:158-268)."""
    col = f"{asset}_Ret"
    if col not in df:
        return np.array([])
    data = df
    if real_only and f"{asset}_IsSynthetic" in df:
        data = df.take(~np.asarray(df[f"{asset}_IsSynthetic"], bool))
    return _rolling_cagrs_from_returns(data[col], horizon_years, stride)


def calculate_rolling_cagrs_all_data(df: Frame, asset: str,
                                     horizon_years: int,
                                     stride: int = 21) -> np.ndarray:
    """Rolling CAGRs over the FULL history including synthetic
    reconstruction (historical.py:632-764)."""
    return calculate_historical_rolling_cagrs(df, asset, horizon_years,
                                              real_only=False, stride=stride)


# ---------------------------------------------------------------------------
# Distribution comparison metrics
# ---------------------------------------------------------------------------

def find_percentile_rank(value: float, distribution: np.ndarray) -> float:
    """Percentile of `value` within `distribution` (0-100)."""
    dist = np.asarray(distribution, float)
    dist = dist[np.isfinite(dist)]
    if len(dist) == 0:
        return 50.0
    return float(np.mean(dist <= value) * 100.0)


def calculate_distribution_overlap(a: np.ndarray, b: np.ndarray,
                                   bins: int = 30) -> float:
    """Histogram-intersection overlap in [0, 1] (historical.py:294-327)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    a, b = a[np.isfinite(a)], b[np.isfinite(b)]
    if len(a) == 0 or len(b) == 0:
        return 0.0
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    if hi <= lo:
        return 1.0
    edges = np.linspace(lo, hi, bins + 1)
    ha, _ = np.histogram(a, bins=edges, density=False)
    hb, _ = np.histogram(b, bins=edges, density=False)
    ha = ha / max(ha.sum(), 1)
    hb = hb / max(hb.sum(), 1)
    return float(np.minimum(ha, hb).sum())


def calculate_percentile_correlation(a: np.ndarray, b: np.ndarray) -> Dict:
    """Correlation of the two distributions' percentile curves
    (historical.py:330-361)."""
    from scipy.stats import spearmanr

    a = np.asarray(a, float)
    b = np.asarray(b, float)
    a, b = a[np.isfinite(a)], b[np.isfinite(b)]
    if len(a) < 5 or len(b) < 5:
        return {"pearson": 0.0, "spearman": 0.0}
    qs = np.linspace(1, 99, 50)
    pa = np.percentile(a, qs)
    pb = np.percentile(b, qs)
    pearson = float(np.corrcoef(pa, pb)[0, 1])
    spearman = float(spearmanr(pa, pb).statistic)
    return {"pearson": pearson, "spearman": spearman}


# ---------------------------------------------------------------------------
# Quality-scored comparison
# ---------------------------------------------------------------------------

def _sim_cagrs(mc_results: Dict[str, List[Dict]], sid: str,
               horizon: int) -> np.ndarray:
    results = mc_results.get(sid, [])
    if not results:
        return np.array([])
    wealth = np.array([r["Final_Wealth"] for r in results], float)
    wealth = np.maximum(wealth, 0.0)
    return (wealth / cfg.INITIAL_CAPITAL) ** (1.0 / horizon) - 1.0


def _score_comparison(hist: np.ndarray, sim: np.ndarray) -> Dict:
    """0-100 quality score (historical.py:520-576 criteria):
    median containment in the sim IQR, histogram overlap, percentile-curve
    correlation, and median closeness."""
    out = {
        "quality_score": 0.0, "overlap": 0.0,
        "median_hist": float("nan"), "median_sim": float("nan"),
        "median_in_iqr": False, "percentile_corr": {"pearson": 0, "spearman": 0},
        "median_diff": float("nan"), "n_hist": len(hist), "n_sim": len(sim),
    }
    if len(hist) < 5 or len(sim) < 5:
        return out

    med_h = float(np.median(hist))
    med_s = float(np.median(sim))
    q25, q75 = np.percentile(sim, [25, 75])
    in_iqr = bool(q25 <= med_h <= q75)
    overlap = calculate_distribution_overlap(hist, sim)
    corr = calculate_percentile_correlation(hist, sim)
    med_diff = abs(med_h - med_s)

    score = 0.0
    score += 30.0 if in_iqr else max(0.0, 30.0 - 100.0 * med_diff)
    score += 30.0 * min(overlap / 0.5, 1.0)
    score += 25.0 * max(corr["spearman"], 0.0)
    score += 15.0 * max(0.0, 1.0 - med_diff / 0.03)

    out.update({
        "quality_score": float(np.clip(score, 0, 100)),
        "overlap": overlap, "median_hist": med_h, "median_sim": med_s,
        "median_in_iqr": in_iqr, "percentile_corr": corr,
        "median_diff": med_diff,
    })
    return out


_BENCHMARK_ASSETS = {"S1": "TQQQ", "S2": "SPY", "S3": "SSO"}


def validate_monte_carlo_vs_historical(df: Frame,
                                       mc_results: Dict[str, List[Dict]],
                                       horizon: int) -> Dict:
    """Benchmark strategies vs realized rolling CAGRs (historical.py:22-153)."""
    out = {}
    for sid, asset in _BENCHMARK_ASSETS.items():
        hist = calculate_historical_rolling_cagrs(df, asset, horizon)
        sim = _sim_cagrs(mc_results, sid, horizon)
        out[sid] = _score_comparison(hist, sim)
    return out


_TABLE_PCTS = (5, 10, 25, 50, 75, 90, 95)


def _percentile_table(hist: np.ndarray, sim: np.ndarray) -> Dict[str, Dict]:
    """Percentile-by-percentile rank table (historical.py:509-518)."""
    table = {}
    for p in _TABLE_PCTS:
        hv = float(np.percentile(hist, p))
        sv = float(np.percentile(sim, p))
        table[f"p{p}"] = {"historical": hv, "simulated": sv,
                          "difference": sv - hv}
    return table


def _print_percentile_table(table: Dict[str, Dict]) -> None:
    print(f"     {'Percentile':<12} {'Historical':>12} {'Simulated':>12} "
          f"{'Difference':>12}")
    print(f"     {'-' * 50}")
    for name, row in table.items():
        print(f"     {name.upper():<12} {row['historical'] * 100:>+11.2f}% "
              f"{row['simulated'] * 100:>+11.2f}% "
              f"{row['difference'] * 100:>+11.2f}%")


def _rankings(hist: np.ndarray, sim: np.ndarray) -> Dict[str, float]:
    """Cross percentile rankings (historical.py:473-481)."""
    return {
        "hist_median_percentile_in_sim": find_percentile_rank(
            float(np.median(hist)), sim),
        "sim_median_percentile_in_hist": find_percentile_rank(
            float(np.median(sim)), hist),
    }


def backtest_strategies_on_history(df: Frame, horizon: int,
                                   stride: int = 21,
                                   max_windows: int | None = None,
                                   real_only: bool = True,
                                   flag_asset: str = "TQQQ", *,
                                   device="cuda",
                                   out_path: Optional[Dict] = None
                                   ) -> Dict[str, np.ndarray]:
    """ALL 19 strategies backtested on rolling `horizon`-year windows of
    history in ONE batch on ``device``: the windows become the trial axis
    of the strategy engine (windows -> [S, W] market channels -> signals
    -> kernel K4), with regimes inferred from VIX per window (the
    reference's regime_path=None path, historical.py:96-102).

    Monthly stride like the reference's rolling windows. Returns {sid: [W]
    window CAGRs, oldest -> newest}. The glue runs in the device's glue
    dtype (float64 on the CPU, float32 on the card), the strategies in
    float32 (K4). ``out_path``, when given, receives the windows' path
    ("path", the port's PathOutputs) and their [W, 19] "final_wealth".

    Signal parity note: device signals derive SPY price as
    cumprod(1+SPY_Ret) while the host oracle reads the historical price
    column -- SMA ratios and RSI are scale-invariant, so decisions match.
    Non-finite historical returns (missing rows) are treated as 0."""
    from letf_tpu_torch.ops.path_batched import PathOutputs
    from letf_tpu_torch.strategies.engine import run_strategies_batch
    from letf_tpu_torch.strategies.signals import compute_signals
    from letf_tpu_torch.utils.regime import (
        _prep_inputs_np,
        infer_regime_from_vix_batched,
    )

    dev = resolve_device(device)
    dt = glue_dtype(dev)
    data = df
    syn_col = f"{flag_asset}_IsSynthetic"
    if real_only and syn_col in df:
        data = df.take(~np.asarray(df[syn_col], bool))
    window = int(horizon * 252)
    n = len(data)
    if n < window + 1:
        return {}
    starts = np.arange(0, n - window + 1, stride)
    if max_windows is not None:
        starts = starts[-max_windows:]
    W = len(starts)

    def col(name, default):
        return (np.asarray(data[name], float) if name in data
                else np.full(n, default))

    assets = sorted(cfg.ASSET_INDEX, key=cfg.ASSET_INDEX.get)
    etf = np.stack([col(f"{a}_Ret", 0.0) for a in assets], axis=-1)
    etf = np.where(np.isfinite(etf), etf, 0.0)
    cash = col("Cash_Ret", 0.04 / 252.0)
    cash = np.where(np.isfinite(cash), cash, 0.0)
    vix = col("VIX", 18.0)
    realized_vol = fillna(bfill(rolling_std(data["SPY_Ret"], 20, 5)),
                          0.0) * np.sqrt(252)
    term = (col("TNX", 0.0) - col("IRX", 0.0)
            if ("TNX" in data and "IRX" in data) else None)
    rf = col("IRX", 4.0) / 100.0

    idx = (starts[None, :] + np.arange(window)[:, None])      # [S, W]

    def tb(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

    # Regime inference runs PER WINDOW (the EWMA + hysteresis scan over
    # [S, W]), matching the reference's per-backtest regime_path=None
    # inference; a globally-inferred path sliced per window would carry
    # smoothing state into each window's start.
    vix_c, rv_c, ts_c = _prep_inputs_np(vix, realized_vol, term)
    regime = infer_regime_from_vix_batched(tb(vix_c[idx]), tb(rv_c[idx]),
                                           tb(ts_c[idx]))
    ew = etf[idx]                                            # [S, W, A]
    zeros = torch.zeros(W, dtype=dt, device=dev)
    path = PathOutputs(
        etf_ret=tb(ew.transpose(2, 0, 1)),
        tlt_ret=tb(ew[..., cfg.ASSET_INDEX.get("TMF", 0)]),
        spy_ret=tb(ew[..., cfg.ASSET_INDEX["SPY"]]),
        qqq_ret=tb(ew[..., cfg.ASSET_INDEX["QQQ"]]),
        vix=tb(vix[idx]), regime=regime,
        cash_ret=tb(cash[idx]), risk_free=tb(rf[idx]),
        start_offset=torch.as_tensor(starts, device=dev),
        start_regime=torch.zeros(W, dtype=torch.int32, device=dev),
        initial_vix=tb(vix[starts]),
        jump_days=torch.zeros(W, dtype=torch.int32, device=dev),
        liq_mean=zeros, credit_mean=zeros,
        valid=torch.ones(W, dtype=torch.bool, device=dev),
        repaired=torch.zeros(W, dtype=torch.bool, device=dev),
        path_finite=torch.ones(W, dtype=torch.bool, device=dev),
        vix_ok=torch.ones(W, dtype=torch.bool, device=dev))
    res = run_strategies_batch(path, compute_signals(path), apply_costs=True)
    fw = res.final_wealth.cpu().numpy().astype(np.float64)   # [W, 19]
    if out_path is not None:
        out_path.update(path=path, final_wealth=fw)
    out = {}
    for sid, k in cfg.STRATEGY_INDEX.items():
        total = fw[:, k] / cfg.INITIAL_CAPITAL
        good = total > 0
        cagrs = np.where(good, np.maximum(total, 1e-12) ** (1.0 / horizon)
                         - 1.0, np.nan)
        out[sid] = cagrs[np.isfinite(cagrs)]
    return out


def backtest_strategy_on_history(df: Frame, sid: str, horizon: int,
                                 max_windows: int | None = None,
                                 real_only: bool = True,
                                 stride: int = 21, *,
                                 device="cuda") -> np.ndarray:
    """Single-strategy view of backtest_strategies_on_history."""
    return backtest_strategies_on_history(
        df, horizon, stride=stride, max_windows=max_windows,
        real_only=real_only, device=device).get(sid, np.array([]))


def run_strategy_on_history(df: Frame, strategy_id: str):
    """Backtest a strategy on historical data (regime inferred from VIX via
    the stress model — the reference's regime_path=None path,
    historical.py:96-102 / strategy.py:64-78). Returns (equity curve numpy
    array, num_trades)."""
    from letf_tpu_torch.strategies.host import run_strategy_fixed
    return run_strategy_fixed(df, strategy_id, regime_path=None)


def compare_simulated_vs_historical(df: Frame,
                                    mc_results: Dict[str, List[Dict]],
                                    horizon: int,
                                    backtest_sids: tuple | None = None, *,
                                    device="cuda") -> Dict:
    """Real-data (post-inception) comparison with quality scores,
    percentile rank tables, and strategy-on-history backtests
    (historical.py:364-629 + :85-104)."""
    print(f"\n{'=' * 90}")
    print(f"HISTORICAL VALIDATION ({horizon}Y rolling windows, real data only)")
    print(f"{'=' * 90}")
    out = {}
    for sid, asset in _BENCHMARK_ASSETS.items():
        hist = calculate_historical_rolling_cagrs(df, asset, horizon)
        sim = _sim_cagrs(mc_results, sid, horizon)
        score = _score_comparison(hist, sim)
        out[sid] = score
        if np.isnan(score["median_hist"]):
            print(f"  {sid} ({asset:>4}): insufficient real history for "
                  f"{horizon}Y windows (n={score['n_hist']})")
            continue
        score["rankings"] = _rankings(hist, sim)
        score["percentile_table"] = _percentile_table(hist, sim)
        print(f"\n  {sid} ({asset:>4}): hist median {score['median_hist']:+.1%} "
              f"vs sim {score['median_sim']:+.1%} | overlap "
              f"{score['overlap']:.0%} | spearman "
              f"{score['percentile_corr']['spearman']:.2f} | "
              f"quality {score['quality_score']:.0f}/100")
        rk = score["rankings"]
        print(f"     Historical median would be "
              f"P{rk['hist_median_percentile_in_sim']:.0f} in simulation; "
              f"simulated median would be "
              f"P{rk['sim_median_percentile_in_hist']:.0f} in history")
        _print_percentile_table(score["percentile_table"])

    # Strategy-on-history: backtest non-benchmark strategies on real data
    # and rank each realized window inside the simulated distribution
    # (reference historical.py:96-102 via run_strategy_fixed with
    # VIX-inferred regimes). One batched device run covers every strategy
    # at monthly stride, so the default is ALL non-benchmark strategies
    # present in the MC results.
    if backtest_sids is None:
        backtest_sids = tuple(
            sid for sid in mc_results
            if cfg.STRATEGIES.get(sid, {}).get("type") != "benchmark")
    bt = (backtest_strategies_on_history(df, horizon, device=device)
          if backtest_sids else {})
    for sid in backtest_sids:
        if sid not in mc_results:
            continue
        sim = _sim_cagrs(mc_results, sid, horizon)
        hist = bt.get(sid, np.array([]))
        entry = {"n_windows": len(hist), "n_sim": len(sim)}
        if len(hist) > 0 and len(sim) >= 5:
            ranks = [find_percentile_rank(c, sim) for c in hist]
            entry.update({
                "hist_cagrs": hist.tolist(),
                "hist_median": float(np.median(hist)),
                "sim_median": float(np.median(sim)),
                "window_sim_percentiles": ranks,
                "median_sim_percentile": float(np.median(ranks)),
            })
            name = cfg.STRATEGIES[sid]["name"]
            print(f"\n  {sid} ({name}) backtested on history: "
                  f"{len(hist)} window(s), median CAGR "
                  f"{entry['hist_median']:+.1%} -> "
                  f"P{entry['median_sim_percentile']:.0f} of its simulated "
                  f"distribution (sim median {entry['sim_median']:+.1%})")
        else:
            print(f"\n  {sid}: insufficient real history for a "
                  f"{horizon}Y strategy backtest")
        out[f"{sid}_backtest"] = entry
    return out


def compare_simulated_vs_synthetic_historical(df: Frame,
                                              mc_results: Dict[str, List[Dict]],
                                              horizon: int) -> Dict:
    """Full-history (synthetic reconstruction included) comparison with
    extreme-event percentile ranking (historical.py:767-1096)."""
    print(f"\n{'=' * 90}")
    print(f"SYNTHETIC-HISTORY VALIDATION ({horizon}Y rolling windows, "
          f"1926+ reconstruction)")
    print(f"{'=' * 90}")
    out = {}
    for sid, asset in _BENCHMARK_ASSETS.items():
        hist = calculate_rolling_cagrs_all_data(df, asset, horizon)
        sim = _sim_cagrs(mc_results, sid, horizon)
        score = _score_comparison(hist, sim)

        # Extreme-event ranking: where do the worst/best realized windows
        # fall within the simulated distribution, and WHEN did they start
        # (historical.py:1005-1032 narrative)?
        extremes = {}
        if len(hist) >= 5 and len(sim) >= 5:
            worst_i, best_i = int(np.argmin(hist)), int(np.argmax(hist))
            worst, best = float(hist[worst_i]), float(hist[best_i])
            extremes = {
                "worst_window_cagr": worst,
                "worst_window_sim_percentile": find_percentile_rank(worst, sim),
                "best_window_cagr": best,
                "best_window_sim_percentile": find_percentile_rank(best, sim),
            }
            # Window start dates: rolling windows stride 21 days over the
            # full frame (same construction as the CAGR computation).
            starts = df.index[::21]
            if worst_i < len(starts):
                extremes["worst_window_start"] = str(starts[worst_i])[:10]
            if best_i < len(starts):
                extremes["best_window_start"] = str(starts[best_i])[:10]
        score["extreme_events"] = extremes
        out[sid] = score
        if np.isnan(score["median_hist"]):
            print(f"  {sid} ({asset:>4}): insufficient history")
            continue
        score["rankings"] = _rankings(hist, sim)
        score["percentile_table"] = _percentile_table(hist, sim)
        print(f"\n  {sid} ({asset:>4}): hist median {score['median_hist']:+.1%}"
              f" vs sim {score['median_sim']:+.1%} | overlap "
              f"{score['overlap']:.0%} | quality "
              f"{score['quality_score']:.0f}/100")
        _print_percentile_table(score["percentile_table"])
        if extremes:
            w_start = extremes.get("worst_window_start", "")
            b_start = extremes.get("best_window_start", "")
            print(f"     Worst {horizon}Y window "
                  f"{extremes['worst_window_cagr']:+.2%}"
                  + (f" (starting {w_start})" if w_start else "")
                  + f" -> sim P{extremes['worst_window_sim_percentile']:.0f}")
            print(f"     Best  {horizon}Y window "
                  f"{extremes['best_window_cagr']:+.2%}"
                  + (f" (starting {b_start})" if b_start else "")
                  + f" -> sim P{extremes['best_window_sim_percentile']:.0f}")

    # Overall ranked summary (historical.py:1066-1096).
    scored = {sid: s for sid, s in out.items()
              if not np.isnan(s.get("median_hist", np.nan))}
    if scored:
        avg_quality = float(np.mean([s["quality_score"]
                                     for s in scored.values()]))
        avg_overlap = float(np.mean([s["overlap"] for s in scored.values()]))
        avg_corr = float(np.mean([s["percentile_corr"]["spearman"]
                                  for s in scored.values()]))
        ranked = sorted(scored.items(), key=lambda kv: -kv[1]["quality_score"])
        print(f"\n  {'-' * 70}")
        print("  RANKED ASSET SUMMARY (by quality score)")
        for rank, (sid, s) in enumerate(ranked, 1):
            print(f"    {rank}. {sid} ({_BENCHMARK_ASSETS[sid]:>4}): "
                  f"quality {s['quality_score']:.0f}/100, overlap "
                  f"{s['overlap']:.0%}, spearman "
                  f"{s['percentile_corr']['spearman']:.2f}")
        print(f"  Average quality {avg_quality:.0f}/100 | overlap "
              f"{avg_overlap:.0%} | spearman {avg_corr:.3f}")
        if avg_quality >= 70:
            print("  SIMULATION VALIDATED: Monte Carlo matches "
                  "synthetic+historical patterns well")
        elif avg_quality >= 50:
            print("  SIMULATION PARTIALLY VALIDATED: some discrepancies "
                  "with synthetic history")
        else:
            print("  SIMULATION CONCERNS: significant differences from "
                  "synthetic historical patterns")
        out["summary"] = {
            "avg_quality_score": avg_quality,
            "avg_overlap": avg_overlap,
            "avg_spearman": avg_corr,
            "ranking": [sid for sid, _ in ranked],
        }
    return out

