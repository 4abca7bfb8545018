"""Data layer: the historical market history.

The port's copy of ``letf_tpu/data.py``: the network loaders
(``fetch_fama_french_data``, :52; ``fetch_market_data``, :79), the splice
(``combine_data_sources``, :220), the deterministic synthetic history
(``generate_synthetic_history``, :130), the backfill branches (the
dynamic-factor ones through ``utils/finance.py``), the synthetic
pre-inception LETF reconstruction (``reconstruct_letf_columns``, :237),
the indicators (SMA200, EWMA and 20-day vol), the trim to the analysis
range and the cache (``fetch_historical_data``, :300). Host numpy/scipy
with the reference's own ``default_rng`` seeds and draw order, on
``utils/frame.Frame`` in place of a pandas DataFrame: the columns are the
reference's bits, and the rolling and EWM columns follow pandas' own
algorithms.

Each loader is a download and a function that makes its frame. The
download imports its package (``pandas_datareader``, ``yfinance``) only
when it is called, and gives ``None`` where the package cannot be
imported, as the reference does; a download that fails prints the
reference's ``[WARN]`` and gives ``None``, which sends
``fetch_historical_data`` to the synthetic history as in the reference. The frame functions (``fama_french_frame``,
``market_frame``) read the downloaded table by duck typing (``.index``,
``[column]``, ``.to_numpy()``), so the port never imports pandas.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from typing import Optional

import numpy as np

from letf_tpu_torch import config as cfg
from letf_tpu_torch.utils.cache import load_cache, save_cache
from letf_tpu_torch.utils.finance import (
    fill_missing_with_dynamic_factor,
    get_borrow_cost_series,
)
from letf_tpu_torch.utils.frame import (
    Frame,
    bdate_range,
    cumprod,
    ewm_std,
    fillna,
    ffill,
    interpolate_both,
    pct_change,
    rolling_mean,
    rolling_std,
)
from letf_tpu_torch.utils.guard import guarded


# ---------------------------------------------------------------------------
# Network loaders: download, then build the frame
# ---------------------------------------------------------------------------

def _network_module(name: str):
    """The module ``name`` of a network loader, imported now, or None
    where its package cannot be imported."""
    top = name.split(".")[0]
    if top not in sys.modules and importlib.util.find_spec(top) is None:
        return None
    return importlib.import_module(name)


def _dates(table) -> np.ndarray:
    return np.asarray(table.index.to_numpy()).astype("datetime64[D]")


def _column(table, name) -> np.ndarray:
    return np.asarray(table[name].to_numpy(), np.float64)


def fetch_fama_french_data(start_date: str, end_date: str) -> Optional[Frame]:
    """Daily market returns from the Fama-French library (1926+), through
    ``pandas_datareader``; None without it or when the download fails."""
    web = _network_module("pandas_datareader.data")
    if web is None:
        return None
    ff, err = guarded(lambda: web.DataReader(
        "F-F_Research_Data_Factors_daily", "famafrench", start=start_date,
        end=end_date)[0])
    if err is not None:
        print(f"  [WARN] Fama-French fetch failed: {err}")
        return None
    return fama_french_frame(ff)


def fama_french_frame(ff) -> Frame:
    """The reference's frame of the Fama-French daily factors table
    (columns "Mkt-RF" and "RF", in percent): market return = Mkt-RF + RF;
    IRX proxied from annualized RF; synthetic VIX from 20-day rolling vol;
    NASDAQ ~ 1.25x SPY; TLT ~ -0.25x SPY + carry."""
    mkt, rf = _column(ff, "Mkt-RF"), _column(ff, "RF")
    out = Frame(index=_dates(ff))
    out["SPY_Ret"] = (mkt + rf) / 100.0
    out["RF"] = rf / 100.0
    out["IRX"] = rf * 252.0
    out["SPY_Price"] = cumprod(1 + out["SPY_Ret"]) * 100
    out["NASDAQ_Ret"] = out["SPY_Ret"] * 1.25
    out["QQQ_Ret"] = out["NASDAQ_Ret"]
    rolling_vol = rolling_std(out["SPY_Ret"], 20) * np.sqrt(252) * 100
    out["VIX"] = fillna(rolling_vol, 20.0)
    out["TLT_Ret"] = out["SPY_Ret"] * -0.25 + out["RF"]
    out["Data_Source"] = "Fama-French"
    return out


MARKET_TICKERS = ["^GSPC", "^IXIC", "^VIX", "^IRX", "^TNX", "TLT", "QQQ",
                  "TQQQ", "UPRO", "SSO"]


def fetch_market_data(start_date: str, end_date: str) -> Optional[Frame]:
    """1950+ market data through ``yfinance``: indices, VIX, rates, TLT,
    QQQ and real LETF prices (TQQQ/UPRO/SSO); None without it or when the
    download fails."""
    yf = _network_module("yfinance")
    if yf is None:
        return None
    data, err = guarded(lambda: yf.download(
        MARKET_TICKERS, start=start_date, end=end_date, progress=False,
        auto_adjust=True))
    if err is not None:
        print(f"  [WARN] market data fetch failed: {err}")
        return None
    return market_frame(data)


def market_frame(data) -> Frame:
    """The reference's frame of a ``yf.download`` table (its "Close"
    prices by ticker)."""
    close = data["Close"]
    df = Frame(index=_dates(close))
    n = len(df)
    if "^GSPC" in close:
        df["SPY_Price"] = _column(close, "^GSPC")
        df["SPY_Ret"] = pct_change(df["SPY_Price"])
    if "^IXIC" in close:
        df["NASDAQ_Price"] = _column(close, "^IXIC")
        df["NASDAQ_Ret"] = pct_change(df["NASDAQ_Price"])
    if "QQQ" in close:
        df["QQQ_Price"] = _column(close, "QQQ")
        df["QQQ_Ret"] = pct_change(df["QQQ_Price"])
    for etf in ("TQQQ", "UPRO", "SSO"):
        if etf in close:
            df[f"{etf}_Real_Price"] = _column(close, etf)
            df[f"{etf}_Real_Ret"] = pct_change(df[f"{etf}_Real_Price"])
    if "^VIX" in close:
        df["VIX"] = _column(close, "^VIX")
    if "SPY_Ret" in df:
        vol = rolling_std(df["SPY_Ret"], 20) * np.sqrt(252) * 100
        df["VIX"] = fillna(fillna(df.get("VIX", np.full(n, np.nan)), vol),
                           20.0)
    if "^IRX" in close:
        df["IRX"] = _column(close, "^IRX")
    df["IRX"] = fillna(df.get("IRX", np.full(n, 4.5)), 4.5)
    if "^TNX" in close:
        df["TNX"] = _column(close, "^TNX")
    df["Cash_Ret"] = df["IRX"] / 100 / 252
    if "TLT" in close:
        df["TLT_Price"] = _column(close, "TLT")
        df["TLT_Ret"] = pct_change(df["TLT_Price"])
    df["Data_Source"] = "yfinance"
    return df


# ---------------------------------------------------------------------------
# Offline synthetic history (deterministic)
# ---------------------------------------------------------------------------

def generate_synthetic_history(start_date: str = cfg.DATA_START_DATE,
                               end_date: str = cfg.DATA_END_DATE,
                               seed: int = 20260816) -> Frame:
    """Deterministic ~100y daily market history with the reference schema.

    A 2-state regime chain drives SPY/QQQ/TLT returns (regime-dependent
    vol + correlation), a mean-reverting VIX coupled to equity shocks, and
    slow-moving IRX/TNX rates. Post-inception ``*_Real_*`` LETF columns are
    built from the true daily-rebalance relation (L*r - ER/252 - borrow)
    plus small AR(1) noise. The draws are the reference's, in its order:
    a block of draws equals the reference's draws one at a time.
    """
    rng = np.random.default_rng(seed)
    dates = bdate_range(start_date, end_date)
    n = len(dates)

    # Regime chain: ~85% calm / 15% stressed.
    p_enter, p_exit = 0.012, 0.075
    regime = np.zeros(n, np.int8)
    r = 0
    for t, u in enumerate(rng.random(n).tolist()):
        r = (1 if u < p_enter else 0) if r == 0 else (0 if u < p_exit else 1)
        regime[t] = r

    mu = np.where(regime == 0, 0.00045, -0.0006)
    sig = np.where(regime == 0, 0.0085, 0.022)
    z = rng.standard_t(6, size=(n, 3))
    rho_eq = np.where(regime == 0, 0.85, 0.95)
    rho_b = np.where(regime == 0, -0.2, -0.05)
    spy = mu + sig * z[:, 0]
    qqq = mu * 1.15 + sig * 1.32 * (rho_eq * z[:, 0]
                                    + np.sqrt(1 - rho_eq ** 2) * z[:, 1])
    tlt = 0.00015 + 0.006 * (rho_b * z[:, 0] + np.sqrt(1 - rho_b ** 2) * z[:, 2])

    spy_l, sig_l, reg_l = spy.tolist(), sig.tolist(), regime.tolist()
    vix = [16.0] * n
    for t, noise in enumerate(rng.normal(0, 1.1, max(n - 1, 0)).tolist(), 1):
        target = 15.0 if reg_l[t] == 0 else 33.0
        shock = max(-spy_l[t], 0.0) / max(sig_l[t], 1e-4)
        jump = 7.0 * max(0.0, shock - 2.0)
        vix[t] = max(9.0, 0.92 * vix[t - 1] + 0.08 * target + jump + noise)
    vix = np.asarray(vix[:n])

    irx = [4.0] * n
    for t, noise in enumerate(rng.normal(0, 0.02, max(n - 1, 0)).tolist(), 1):
        target = 4.2 if reg_l[t] == 0 else 1.8
        irx[t] = min(max(0.999 * irx[t - 1] + 0.001 * target + noise, 0.0),
                     15.0)
    irx = np.asarray(irx[:n])
    tnx = np.clip(irx + np.where(vix > 30, -0.25, 1.1)
                  + rng.normal(0, 0.05, n), 0.0, 18.0)

    df = Frame({"SPY_Ret": spy, "QQQ_Ret": qqq, "NASDAQ_Ret": qqq,
                "TLT_Ret": tlt, "VIX": vix, "IRX": irx, "TNX": tnx}, dates)
    df["RF"] = df["IRX"] / 100 / 252
    df["Cash_Ret"] = df["RF"]
    df["SPY_Price"] = cumprod(1 + df["SPY_Ret"]) * 100
    df["QQQ_Price"] = cumprod(1 + df["QQQ_Ret"]) * 100
    df["NASDAQ_Price"] = df["QQQ_Price"]
    df["TLT_Price"] = cumprod(1 + df["TLT_Ret"]) * 100

    # Real post-inception LETF columns from the true daily relation.
    for asset in ("TQQQ", "UPRO", "SSO"):
        ac = cfg.ASSETS[asset]
        mask = df.index >= np.datetime64(ac.inception, "D")
        under = df["QQQ_Ret"] if asset == "TQQQ" else df["SPY_Ret"]
        borrow = ((ac.leverage - 1.0)
                  * np.maximum(df["IRX"] / 100.0 + ac.borrow_spread, 0) / 252.0)
        te = [0.0] * n
        tdraws = (rng.standard_t(5, n) * ac.tracking_error_base).tolist()
        for t in range(1, n):
            te[t] = 0.25 * te[t - 1] + tdraws[t]
        real = (ac.leverage * under - ac.expense_ratio / 252.0 - borrow
                + np.asarray(te))
        real = np.where(mask, real, np.nan)
        df[f"{asset}_Real_Ret"] = real
        price = cumprod(np.where(mask, 1 + fillna(real, 0), np.nan)) * 100
        df[f"{asset}_Real_Price"] = np.where(mask, price, np.nan)

    df["Data_Source"] = "synthetic-offline"
    return df


# ---------------------------------------------------------------------------
# Splice + reconstruction
# ---------------------------------------------------------------------------

def combine_data_sources(ff_data: Frame, market_data: Frame,
                         cutoff_date: str = cfg.YFINANCE_START_DATE) -> Frame:
    """Fama-French before the cutoff, market data from it on; a column of
    one source only is NaN in the other's rows; the rows sorted by date,
    and a continuous SPY price. A date that repeats (only possible inside
    one source) keeps its last row in that source's order: the sort is
    stable. (The reference's ``sort_index`` is not stable, so which row
    of a repeated date it keeps is left to numpy's quicksort.)"""
    cutoff = np.datetime64(cutoff_date, "D")
    before = ff_data.take(ff_data.index < cutoff)
    after = market_data.take(market_data.index >= cutoff)
    for col in after.columns:
        if col not in before:
            before[col] = np.full(len(before), np.nan)
    cols = before.columns + [c for c in after.columns if c not in before]
    index = np.concatenate([before.index, after.index])
    order = np.argsort(index, kind="stable")
    dates = index[order]
    last = np.ones(len(order), bool)
    last[:-1] = dates[1:] != dates[:-1]
    rows = order[last]
    combined = Frame(index=index[rows])
    for c in cols:
        a = before[c]
        b = after[c] if c in after else np.full(len(after), np.nan)
        combined[c] = np.concatenate([a, b])[rows]
    if "SPY_Ret" in combined:
        combined["SPY_Price"] = cumprod(1 + fillna(combined["SPY_Ret"],
                                                   0)) * 100
    return combined


def reconstruct_letf_columns(df: Frame) -> Frame:
    """Synthetic LETF series for every asset with correct vol-drag
    compounding (drag emerges from geometric compounding of
    L*r - expense/252 - dynamic borrow, NOT a per-day subtraction), plus
    multiplicative AR(1) fat-tailed tracking error; real post-inception data
    overrides; ``_IsSynthetic`` flags mark reconstruction. The tracking
    draws are the reference's (``scipy.stats.t.rvs`` one day at a time is
    ``Generator.standard_t`` in a block)."""
    n = len(df)
    for asset_id, ac in cfg.ASSETS.items():
        if ac.underlying == cfg.UNDERLYING_QQQ:
            underlying = df["QQQ_Ret"]
        elif ac.underlying == cfg.UNDERLYING_TLT:
            underlying = df["TLT_Ret"]
        else:
            underlying = df["SPY_Ret"]
        beta = ac.beta_to_spy
        if beta != 1.0 and asset_id not in ("TMF", "TQQQ"):
            underlying = underlying * beta

        daily_expense = ac.expense_ratio / 252.0
        borrow = get_borrow_cost_series(df, ac.leverage, ac.borrow_spread)
        net_before_te = ac.leverage * underlying - daily_expense - borrow

        # Display-only synthetic TE (fixed seed; nothing downstream
        # calibrates on these columns).
        te_rng = np.random.default_rng(42 + ord(asset_id[0]))
        vix_mult = (df["VIX"] / 20.0) ** 1.5
        innovation = (te_rng.standard_t(ac.tracking_error_df,
                                        size=max(n - 1, 0))
                      * ac.tracking_error_base * vix_mult[1:])
        u = underlying[1:]
        innovation = np.where(np.isnan(u), innovation,
                              innovation * (1 + 10 * np.abs(u))).tolist()
        te = [0.0] * n
        for i in range(1, n):
            te[i] = 0.3 * te[i - 1] + innovation[i - 1]

        synthetic = (1 + net_before_te) * (1 + np.asarray(te)) - 1
        df[f"{asset_id}_Ret"] = synthetic
        df[f"{asset_id}_Price"] = cumprod(1 + fillna(synthetic, 0)) * 100

        inception = np.datetime64(ac.inception, "D")
        rp, rr = f"{asset_id}_Real_Price", f"{asset_id}_Real_Ret"
        if rp in df and rr in df:
            real_mask = (df.index >= inception) & ~np.isnan(df[rp])
            if real_mask.any():
                ret = df[f"{asset_id}_Ret"].copy()
                price = df[f"{asset_id}_Price"].copy()
                ret[real_mask] = df[rr][real_mask]
                pre_mask = ~real_mask
                if pre_mask.any():
                    pre_prices = cumprod(1 + fillna(ret[pre_mask], 0))
                    first_real = df[rp][real_mask][0]
                    scale = first_real / pre_prices[-1]
                    price[pre_mask] = pre_prices * scale
                price[real_mask] = df[rp][real_mask]
                df[f"{asset_id}_Ret"] = ret
                df[f"{asset_id}_Price"] = price
            df[f"{asset_id}_IsSynthetic"] = ~real_mask
        else:
            df[f"{asset_id}_IsSynthetic"] = df.index < inception
    return df


def _has_gaps(df: Frame, col: str) -> bool:
    """Whether ``col`` has a NaN day; an absent column is added as NaN
    first, as the reference does."""
    if col not in df:
        df[col] = np.full(len(df), np.nan)
    return bool(np.isnan(df[col]).any())


def fetch_historical_data(force_synthetic: bool = False) -> Frame:
    """Full data pipeline with caching: fetch (or synthesize) -> splice ->
    backfill -> reconstruct LETFs -> indicators -> trim to analysis
    range."""
    cached = load_cache(cfg.DATA_CACHE)
    if cached is not None:
        print("[OK] Using cached historical data")
        return cached

    print(f"\n{'=' * 80}")
    print("FETCHING HISTORICAL DATA")
    print(f"{'=' * 80}")

    df = None
    if not force_synthetic:
        ff = fetch_fama_french_data(cfg.DATA_START_DATE,
                                    cfg.FAMA_FRENCH_END_DATE)
        mkt = fetch_market_data(cfg.YFINANCE_START_DATE, cfg.DATA_END_DATE)
        if ff is not None and mkt is not None and len(mkt) > 0:
            df = combine_data_sources(ff, mkt)
        elif mkt is not None and len(mkt) > 0:
            df = mkt
        elif ff is not None:
            df = ff
    if df is None or "SPY_Ret" not in df or np.isnan(df["SPY_Ret"]).all():
        print("  [INFO] Network data unavailable - generating deterministic "
              "SYNTHETIC market history (offline mode)")
        df = generate_synthetic_history()

    # Backfills (dynamic factor models; reference data.py:360-414).
    if _has_gaps(df, "NASDAQ_Ret"):
        df["NASDAQ_Ret"] = fill_missing_with_dynamic_factor(
            df, "NASDAQ_Ret", "SPY_Ret", default_beta=1.25, seed=1101)
    if _has_gaps(df, "QQQ_Ret"):
        df["QQQ_Ret"] = fill_missing_with_dynamic_factor(
            df, "QQQ_Ret", "NASDAQ_Ret", default_beta=1.0, seed=1102)
    if _has_gaps(df, "VIX"):
        vol = rolling_std(df["SPY_Ret"], 20) * np.sqrt(252) * 100
        df["VIX"] = fillna(fillna(df["VIX"], vol), 20.0)
    if _has_gaps(df, "IRX"):
        if "RF" in df:
            df["IRX"] = fillna(df["IRX"], df["RF"] * 252 * 100)
        if "TNX" in df:
            df["IRX"] = fillna(df["IRX"], np.maximum(0.55 * df["TNX"], 0.0))
        df["IRX"] = fillna(ffill(interpolate_both(df["IRX"])), 3.0)
    if "Cash_Ret" not in df:
        df["Cash_Ret"] = df["IRX"] / 100 / 252
    if _has_gaps(df, "TLT_Ret"):
        filled = fill_missing_with_dynamic_factor(
            df, "TLT_Ret", "SPY_Ret", default_beta=-0.20, seed=1103)
        df["TLT_Ret"] = fillna(filled, df["IRX"] / 100 / 252)

    df = reconstruct_letf_columns(df)

    # Indicators.
    df["SMA200"] = rolling_mean(df["SPY_Price"], 200, 1)
    df["Market_Vol_EWMA"] = ewm_std(df["SPY_Ret"], 20) * np.sqrt(252)
    df["Market_Vol_20d"] = rolling_std(df["SPY_Ret"], 20) * np.sqrt(252)
    df["Market_Vol"] = df["Market_Vol_EWMA"]

    df = df.between(cfg.ANALYSIS_START_DATE, cfg.ANALYSIS_END_DATE)
    df = df.dropna(["SPY_Ret", "VIX"])

    print(f"[OK] Data ready: {len(df):,} trading days "
          f"({len(df) / 252:.1f} years), source="
          f"{df['Data_Source'][-1] if 'Data_Source' in df else 'unknown'}")
    for asset_id in ("TQQQ", "UPRO", "SSO"):
        col = f"{asset_id}_IsSynthetic"
        if col in df:
            n_syn = int(df[col].sum())
            print(f"  {asset_id}: {len(df) - n_syn:,} real days, "
                  f"{n_syn:,} SYNTHETIC days")
    print("  WARNING: pre-inception LETF data is SYNTHETIC reconstruction.")

    cfg.init_cache()
    save_cache(df, cfg.DATA_CACHE)
    return df
