"""The port's network data route against the JAX package's.

- ``utils/frame.rolling_cov`` is pandas' ``Rolling.cov`` bit for bit on a
  seeded fuzz of short series with NaN and infinite values. The rule,
  probed from the installed pandas (3.0.3) and read in its source: each
  series first takes the other's NaNs (``x + 0 * y``), infinite values
  become NaN, then ``(mean(x * y) - mean(x) * mean(y)) * n / (n - ddof)``
  from three rolling means (its online rule) and the rolling count of the
  rows where both are present.
- ``utils/finance.fill_missing_with_dynamic_factor`` on a ``Frame`` equals
  the JAX function on the same pandas frame bit for bit: NaN holes, the
  fewer-than-40 shortcut, a factor of zero variance, too few residuals, an
  absent target and an infinite factor value.
- The frame functions behind the loaders (``fama_french_frame``,
  ``market_frame``) and ``combine_data_sources`` equal the JAX package's
  loaders and splice on the same downloaded tables (fakes of
  ``pandas_datareader`` and ``yfinance`` cut from the committed offline
  history, with its real pre-inception gaps and NaN holes); a failed
  download prints the reference's ``[WARN]`` and gives None in both.
- The whole ``fetch_historical_data(force_synthetic=False)`` through both
  packages on those fakes (in the JAX package through ``monkeypatch`` of
  its module globals, in the port through ``sys.modules``), each cache in
  a temporary directory: every column bit for bit, NaNs included.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from letf_tpu import config as jcfg
from letf_tpu import data as jdata
from letf_tpu.utils import fill_missing_with_dynamic_factor as jax_fill
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import data as tdata
from letf_tpu_torch.utils import frame as F
from letf_tpu_torch.utils.finance import fill_missing_with_dynamic_factor
from test_torch_data import CACHE_NAMES, as_frame, assert_frame_matches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "letf_tpu_cache_v1" / "historical_data.pkl"
# Each ticker's first day (its inception or the index's first quote).
FIRST_QUOTE = {"^IXIC": "1971-02-05", "^VIX": "1990-01-02",
               "^TNX": "1962-01-02", "TLT": "2002-07-30",
               "QQQ": "1999-03-10"}


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' cache paths in fresh temporary directories."""
    for c, d in ((tcfg, tmp_path / "port"), (jcfg, tmp_path / "jax")):
        monkeypatch.setattr(c, "CACHE_DIR", d)
        for name in CACHE_NAMES:
            monkeypatch.setattr(c, name, d / getattr(c, name).name)


@pytest.fixture(scope="module")
def history():
    return pd.read_pickle(COMMITTED)


def ff_table(history, start="1926-07-01", end="1949-12-31"):
    """The Fama-French daily factors as DataReader returns them (percent)."""
    h = history.loc[start:end]
    return pd.DataFrame({"Mkt-RF": (h["SPY_Ret"] - h["RF"]) * 100.0,
                         "RF": h["RF"] * 100.0}, index=h.index)


def yf_table(history, start="1950-01-01", end="2025-12-31",
             tickers=tdata.MARKET_TICKERS, seed=0):
    """A ``yf.download`` table: the "Close" prices by ticker, NaN before
    each ticker's first quote and in a few seeded holes."""
    h = history.loc[start:end]
    src = {"^GSPC": "SPY_Price", "^IXIC": "NASDAQ_Price", "^VIX": "VIX",
           "^IRX": "IRX", "^TNX": "TNX", "TLT": "TLT_Price",
           "QQQ": "QQQ_Price", "TQQQ": "TQQQ_Real_Price",
           "UPRO": "UPRO_Real_Price", "SSO": "SSO_Real_Price"}
    rng = np.random.default_rng(seed)
    close = {}
    for t in tickers:
        v = h[src[t]].to_numpy().copy()
        if t in FIRST_QUOTE:
            v[h.index < pd.Timestamp(FIRST_QUOTE[t])] = np.nan
        v[rng.random(len(v)) < 0.002] = np.nan
        close[t] = v
    return pd.concat({"Close": pd.DataFrame(close, index=h.index)}, axis=1)


def fake_web(table, fail=False):
    def DataReader(name, source, start=None, end=None):
        assert (name, source) == ("F-F_Research_Data_Factors_daily",
                                  "famafrench")
        if fail:
            raise ConnectionError("no route to host")
        return {0: table.loc[start:end]}

    mod = types.ModuleType("pandas_datareader.data")
    mod.DataReader = DataReader
    return mod


def fake_yf(table, fail=False):
    def download(tickers, start=None, end=None, progress=True,
                 auto_adjust=False):
        assert tickers == tdata.MARKET_TICKERS and auto_adjust
        if fail:
            raise ConnectionError("no route to host")
        return table.loc[start:end]

    mod = types.ModuleType("yfinance")
    mod.download = download
    return mod


def install(monkeypatch, web=None, yf=None):
    """The fakes as both packages see them: the JAX package's module
    globals, the port's sys.modules."""
    monkeypatch.setattr(tdata, "_network_module", NETWORK_MODULE)
    for name, mod, flag, attr in (("yfinance", yf, "_YFINANCE", "yf"),
                                  ("pandas_datareader", web, "_DATAREADER",
                                   "web")):
        monkeypatch.setattr(jdata, flag, mod is not None)
        monkeypatch.setattr(jdata, attr, mod, raising=False)
        if mod is None:
            monkeypatch.setattr(tdata, "_network_module",
                                _without(name, tdata._network_module))
            continue
        monkeypatch.setitem(sys.modules, name, mod if name == "yfinance"
                            else types.ModuleType(name))
        if name == "pandas_datareader":
            sys.modules[name].data = mod
            monkeypatch.setitem(sys.modules, "pandas_datareader.data", mod)


NETWORK_MODULE = tdata._network_module


def _without(name, inner):
    return lambda m: None if m.split(".")[0] == name else inner(m)


_VALS = [0.0, 1.0, 1e-3, -0.5, 1e7, 3.3, 2.5e-4, np.nan, np.inf, -np.inf]


@pytest.mark.parametrize("part", range(4))
def test_rolling_cov_is_pandas_bit_for_bit(part):
    rng = np.random.default_rng(100 + part)
    for _ in range(600):
        n = int(rng.integers(1, 70))
        w = int(rng.integers(1, 9))
        mp = int(rng.integers(0, w + 1)) if rng.random() < 0.7 else None
        x = (rng.choice(_VALS, n) if rng.random() < 0.5
             else np.round(rng.normal(size=n), 2))
        y = (rng.choice(_VALS[:-1], n) if rng.random() < 0.5
             else np.round(rng.normal(size=n), 3))
        x[rng.random(n) < 0.15] = np.nan
        want = pd.Series(x).rolling(w, min_periods=mp).cov(pd.Series(y))
        np.testing.assert_array_equal(F.rolling_cov(x, y, w, mp),
                                      want.to_numpy(), err_msg=(w, mp))
    r = np.random.default_rng(part).normal(0, 0.01, (2, 3000))
    r[0, r[0] > 0.015] = np.nan
    np.testing.assert_array_equal(
        F.rolling_cov(r[0], r[1], 252, 40),
        pd.Series(r[0]).rolling(252, min_periods=40).cov(
            pd.Series(r[1])).to_numpy())


FILL_CASES = ("holes", "short", "zero_variance", "few_residuals", "absent",
              "inf_factor", "leading_gap")


@pytest.mark.parametrize("case", FILL_CASES)
def test_dynamic_factor_fill_equals_jax(case):
    rng = np.random.default_rng(FILL_CASES.index(case))
    n = 900
    idx = pd.bdate_range("1990-01-01", periods=n)
    f = rng.normal(0.0004, 0.011, n)
    t = 1.3 * f + rng.normal(0, 0.004, n)
    t[rng.random(n) < 0.2] = np.nan
    f[rng.random(n) < 0.03] = np.nan
    if case == "short":
        t[35:] = np.nan
    elif case == "zero_variance":
        f[:400] = 0.0
    elif case == "few_residuals":
        t[:] = np.nan
        t[rng.choice(n, 41, replace=False)] = 0.001
        f[:] = np.where(np.isnan(t), f, 0.002)
    elif case == "inf_factor":
        f[500] = np.inf
    elif case == "leading_gap":
        t[:600] = np.nan
    cols = {"F": f} if case == "absent" else {"T": t, "F": f}
    want = jax_fill(pd.DataFrame(cols, index=idx), "T", "F", 1.25,
                    seed=1101).to_numpy()
    frame = F.Frame({k: v.copy() for k, v in cols.items()}, idx.values)
    got = fill_missing_with_dynamic_factor(frame, "T", "F", 1.25, seed=1101)
    np.testing.assert_array_equal(got, want)
    assert "T" in frame and got.dtype == np.float64
    if case not in ("absent", "short"):
        assert np.isnan(want).sum() < np.isnan(t).sum()


def test_loader_frames_equal_jax(monkeypatch, history, capsys):
    ff, mk = ff_table(history), yf_table(history, seed=1)
    install(monkeypatch, web=fake_web(ff), yf=fake_yf(mk))
    for fn, args in ((
            "fetch_fama_french_data", ("1926-07-01", "1949-12-31")),
            ("fetch_market_data", ("1950-01-01", "2025-12-31"))):
        got = getattr(tdata, fn)(*args)
        want = getattr(jdata, fn)(*args)
        assert_frame_matches(got, want)
    # Without ^VIX and ^IRX: the rolling-vol VIX and the 4.5 IRX.
    partial = yf_table(history, "2000-01-01", "2001-12-31",
                       tickers=["^GSPC", "QQQ", "TLT"])
    install(monkeypatch, yf=fake_yf(partial))
    assert_frame_matches(
        tdata.fetch_market_data("2000-01-01", "2001-12-31"),
        jdata.fetch_market_data("2000-01-01", "2001-12-31"))
    install(monkeypatch, web=fake_web(ff, fail=True),
            yf=fake_yf(mk, fail=True))
    capsys.readouterr()
    for mod in (tdata, jdata):
        assert mod.fetch_fama_french_data("1926-07-01", "1949-12-31") is None
        assert mod.fetch_market_data("1950-01-01", "2025-12-31") is None
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] == [
        "  [WARN] Fama-French fetch failed: no route to host",
        "  [WARN] market data fetch failed: no route to host"]


def test_combine_equals_jax_and_keeps_a_repeated_dates_last_row(history):
    ff_pd = _jax_ff(history.loc["1949-06-01":"1950-03-31"])
    mk_pd = _jax_mk(history.loc["1949-09-01":"1950-06-30"])
    want = jdata.combine_data_sources(ff_pd, mk_pd)
    got = tdata.combine_data_sources(as_frame(ff_pd), as_frame(mk_pd))
    assert_frame_matches(got, want)
    assert len(got) == len(want) == (
        (ff_pd.index < "1950-01-01").sum() + (mk_pd.index >= "1950-01-01")
        .sum())
    # A date repeated inside one source keeps its last row there.
    mk = as_frame(mk_pd)
    rows = np.r_[0:150, 120, 150:len(mk)]
    dup = mk.take(rows)
    dup["VIX"] = np.where(np.arange(len(dup)) == 150, -1.0, dup["VIX"])
    got = tdata.combine_data_sources(as_frame(ff_pd), dup)
    at = got.index == mk.index[120]
    assert mk.index[120] >= np.datetime64("1950-01-01")
    assert at.sum() == 1 and got["VIX"][at][0] == -1.0
    assert (np.diff(got.index.astype(np.int64)) > 0).all()


def _jax_ff(h):
    return pd.DataFrame({"SPY_Ret": h["SPY_Ret"], "RF": h["RF"],
                         "IRX": h["IRX"], "VIX": h["VIX"],
                         "Data_Source": "Fama-French"}, index=h.index)


def _jax_mk(h):
    return pd.DataFrame({"SPY_Price": h["SPY_Price"],
                         "SPY_Ret": h["SPY_Ret"], "VIX": h["VIX"],
                         "TNX": h["TNX"], "Data_Source": "yfinance"},
                        index=h.index)


@pytest.mark.parametrize("sources", ["both", "market_only", "ff_only"])
def test_network_route_equals_jax(monkeypatch, history, sources):
    """fetch_historical_data(force_synthetic=False) on the fakes: the
    splice (or one source alone), the dynamic-factor backfills of NASDAQ,
    QQQ and TLT, the VIX and IRX backfills, the reconstruction, the
    indicators and the trim, every column bit for bit."""
    web = fake_web(ff_table(history)) if sources != "market_only" else None
    yf = fake_yf(yf_table(history)) if sources != "ff_only" else None
    install(monkeypatch, web=web, yf=yf)
    if sources == "ff_only":
        for c in (jcfg, tcfg):
            monkeypatch.setattr(c, "ANALYSIS_END_DATE", "1949-12-31")
    got = tdata.fetch_historical_data(force_synthetic=False)
    want = jdata.fetch_historical_data(force_synthetic=False)
    assert_frame_matches(got, want)
    source = {"both": "yfinance", "market_only": "yfinance",
              "ff_only": "Fama-French"}[sources]
    assert got["Data_Source"][-1] == source
    assert np.isfinite(got["TLT_Ret"]).all()
    assert np.isfinite(got["QQQ_Ret"]).all()
