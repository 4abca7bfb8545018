"""The port's offline data layer against the JAX package and pandas.

- ``generate_synthetic_history`` and ``reconstruct_letf_columns`` equal the
  JAX package's bit for bit, column by column (same seeds, same draws).
- The full-range ``fetch_historical_data(force_synthetic=True)`` equals
  the committed ``letf_tpu_cache_v1/historical_data.pkl`` (read here with
  pandas): the generated and reconstructed columns bit for bit, the
  rolling and EWM indicator columns within rtol 1e-12.
- The frame operations of ``utils/frame.py`` equal pandas' on series with
  NaNs made by hypothesis: the fills, diff, cumprod, shift and pct_change
  exactly; rolling means, sums, variances and EWM std exactly.
- The rolling variance equals pandas 3.0's bit for bit on a seeded fuzz of
  3,000 short series with mixed magnitudes (values from {0, 1, 1e-3,
  2.5e-4, 0.97, -0.5, 1e7, 3.3} or rounded normals, windows 2-5; a
  sliding Welford rule without the recompute misses 387 of them), in six
  parametrised chunks, and on three named examples; the host strategy
  oracle's other frame operations on the same fuzz; ``rolling_skew`` (pandas 2's moments, not
  pandas 3.0's rule) within 1e-12 of pandas on return-like series with
  the same NaN pattern.
- The network loaders return None where their packages cannot be
  imported, and build their frames where they can (fakes); the route
  itself is held to the JAX package in tests/test_torch_data_route.py.
Every cache path of the port points at a temporary directory.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from letf_tpu import config as jcfg
from letf_tpu import data as jdata
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import data as tdata
from letf_tpu_torch.utils import frame as F
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "letf_tpu_cache_v1" / "historical_data.pkl"
INDICATORS = ("SMA200", "Market_Vol_EWMA", "Market_Vol_20d", "Market_Vol")
CACHE_NAMES = ("DATA_CACHE", "REGIME_MODEL_CACHE", "CORRELATION_CACHE",
               "VALIDATION_RESULTS", "JOINT_RETURN_MODEL_CACHE",
               "FUNDING_MODEL_CACHE", "TRACKING_RESIDUAL_CACHE",
               "STRESS_STATE_CACHE", "BOOTSTRAP_CACHE")


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    """Every cache path of the port in a fresh temporary directory."""
    monkeypatch.setattr(tcfg, "CACHE_DIR", tmp_path)
    for name in CACHE_NAMES:
        monkeypatch.setattr(tcfg, name, tmp_path / getattr(tcfg, name).name)
    return tmp_path


def as_frame(df: pd.DataFrame) -> F.Frame:
    return F.Frame({c: df[c].to_numpy() for c in df.columns},
                   df.index.values.astype("datetime64[D]"))


def assert_frame_matches(got: F.Frame, ref: pd.DataFrame, loose=()):
    assert got.columns == list(ref.columns)
    np.testing.assert_array_equal(got.index,
                                  ref.index.values.astype("datetime64[D]"))
    for c in ref.columns:
        want = ref[c].to_numpy()
        if c == "Data_Source":
            assert (got[c] == want.astype(str)).all()
        elif c in loose:
            np.testing.assert_allclose(got[c], want, rtol=1e-12, err_msg=c)
        else:
            assert got[c].dtype == want.dtype, c
            np.testing.assert_array_equal(got[c], want, err_msg=c)


@pytest.fixture(scope="module")
def short():
    """The JAX package's and the port's 2000-2025 synthetic history."""
    return (jdata.generate_synthetic_history("2000-01-01", "2025-12-31"),
            tdata.generate_synthetic_history("2000-01-01", "2025-12-31"))


def test_synthetic_history_equals_jax_bit_for_bit(short):
    ref, got = short
    assert len(got) == 6783
    assert_frame_matches(got, ref)


def test_reconstruction_equals_jax_bit_for_bit(short):
    ref, got = short
    assert_frame_matches(tdata.reconstruct_letf_columns(got.copy()),
                         jdata.reconstruct_letf_columns(ref.copy()))


def test_full_history_equals_the_committed_pickle(port_cache):
    """The 1926-2025 offline history: 25,960 days x 38 columns, the
    committed JAX-package cache's values; a second call reads the port's
    own cache and nothing is written into the JAX package's."""
    before = {p.name: p.stat().st_mtime_ns
              for p in COMMITTED.parent.iterdir()}
    got = tdata.fetch_historical_data(force_synthetic=True)
    ref = pd.read_pickle(COMMITTED)
    assert len(got) == 25_960 and len(got.columns) == 38
    assert_frame_matches(got, ref, loose=INDICATORS)
    assert (port_cache / "historical_data.pkl").exists()
    again = tdata.fetch_historical_data(force_synthetic=True)
    for c in got.columns:
        np.testing.assert_array_equal(again[c], got[c])
    assert {p.name: p.stat().st_mtime_ns
            for p in COMMITTED.parent.iterdir()} == before


def test_offline_fetch_without_loaders_is_the_synthetic_route(monkeypatch):
    """force_synthetic=False with neither loader importable takes the
    synthetic route, as the reference does offline."""
    monkeypatch.setattr(tcfg, "ANALYSIS_START_DATE", "2020-01-01")
    got = tdata.fetch_historical_data(force_synthetic=False)
    assert str(got.index[0]) == "2020-01-01"
    assert (got["Data_Source"] == "synthetic-offline").all()


def test_network_loaders_gate(monkeypatch):
    """Without their packages the loaders give None, as the reference's;
    where the packages import (fakes here), they download and build the
    reference's frames (held to the JAX package's in
    tests/test_torch_data_route.py)."""
    import sys
    import types

    real = importlib.util.find_spec
    if real("pandas_datareader") is None and real("yfinance") is None:
        assert tdata.fetch_fama_french_data("1926-07-01", "1949-12-31") is None
        assert tdata.fetch_market_data("1950-01-01", "2025-12-31") is None
        assert jdata.fetch_market_data("1950-01-01", "2025-12-31") is None

    idx = pd.bdate_range("1949-12-01", "1950-02-28")
    ff = pd.DataFrame({"Mkt-RF": np.linspace(-1, 1, len(idx)),
                       "RF": np.full(len(idx), 0.01)}, index=idx)
    close = pd.DataFrame({"^GSPC": np.linspace(16.0, 17.0, len(idx))},
                         index=idx)
    web = types.ModuleType("pandas_datareader.data")
    web.DataReader = lambda *a, **k: {0: ff}
    yf = types.ModuleType("yfinance")
    yf.download = lambda *a, **k: pd.concat({"Close": close}, axis=1)
    monkeypatch.setitem(sys.modules, "pandas_datareader",
                        types.ModuleType("pandas_datareader"))
    monkeypatch.setitem(sys.modules, "pandas_datareader.data", web)
    monkeypatch.setitem(sys.modules, "yfinance", yf)
    got = tdata.fetch_fama_french_data("1926-07-01", "1949-12-31")
    assert len(got) == len(idx) and got["Data_Source"][0] == "Fama-French"
    mkt = tdata.fetch_market_data("1950-01-01", "2025-12-31")
    assert mkt.columns == ["SPY_Price", "SPY_Ret", "VIX", "IRX", "Cash_Ret",
                           "Data_Source"]
    assert (mkt["IRX"] == 4.5).all() and np.isnan(mkt["SPY_Ret"][0])


def test_backfill_branches(monkeypatch):
    """The VIX and IRX backfills of the offline route equal the
    reference's pandas expressions; the dynamic-factor backfills of TLT,
    NASDAQ and QQQ equal the JAX package's route on the same frame."""
    gen = tdata.generate_synthetic_history
    df = gen("2024-01-01", "2025-12-31")
    rng = np.random.default_rng(3)
    holes = rng.random(len(df)) < 0.1
    vix, irx = df["VIX"].copy(), df["IRX"].copy()
    vix[holes] = np.nan
    irx[holes] = np.nan
    irx[:5] = np.nan
    df["VIX"], df["IRX"] = vix, irx
    rf = df["RF"].copy()
    rf[rng.random(len(df)) < 0.5] = np.nan
    df["RF"] = rf
    spy, tnx = df["SPY_Ret"].copy(), df["TNX"].copy()
    monkeypatch.setattr(tdata, "generate_synthetic_history", lambda: df)
    monkeypatch.setattr(tcfg, "ANALYSIS_START_DATE", "2024-01-01")
    got = tdata.fetch_historical_data(force_synthetic=True)

    s = pd.Series(vix)
    want_vix = s.fillna(pd.Series(spy).rolling(20).std()
                        * np.sqrt(252) * 100).fillna(20.0)
    w = pd.Series(irx).fillna(pd.Series(rf) * 252 * 100)
    w = w.fillna((0.55 * pd.Series(tnx)).clip(lower=0.0))
    want_irx = w.interpolate(limit_direction="both").ffill().fillna(3.0)
    np.testing.assert_array_equal(got["VIX"], want_vix.to_numpy())
    np.testing.assert_array_equal(got["IRX"], want_irx.to_numpy())

    # The dynamic-factor backfills, against the JAX package's route on the
    # same frame (its cache redirected too).
    df2 = gen("2024-01-01", "2025-12-31")
    jdf2 = jdata.generate_synthetic_history("2024-01-01", "2025-12-31")
    for col, row in (("TLT_Ret", 3), ("NASDAQ_Ret", 7), ("QQQ_Ret", 9)):
        v = df2[col].copy()
        v[row] = np.nan
        df2[col] = v
        jdf2.iloc[row, jdf2.columns.get_loc(col)] = np.nan
    monkeypatch.setattr(tdata, "generate_synthetic_history", lambda: df2)
    monkeypatch.setattr(jdata, "generate_synthetic_history", lambda: jdf2)
    jdir = Path(tcfg.CACHE_DIR) / "jax"
    monkeypatch.setattr(jcfg, "CACHE_DIR", jdir)
    monkeypatch.setattr(jcfg, "DATA_CACHE", jdir / "historical_data.pkl")
    monkeypatch.setattr(jcfg, "ANALYSIS_START_DATE", "2024-01-01")
    Path(tcfg.DATA_CACHE).unlink()
    got = tdata.fetch_historical_data(force_synthetic=True)
    want = jdata.fetch_historical_data(force_synthetic=True)
    for col in ("TLT_Ret", "NASDAQ_Ret", "QQQ_Ret"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(),
                                      err_msg=col)
        assert np.isfinite(got[col]).all(), col


def test_bdate_range_and_frame_selection():
    for a, b in (("1926-07-01", "2025-12-31"), ("2024-02-28", "2024-03-04")):
        np.testing.assert_array_equal(
            F.bdate_range(a, b),
            pd.bdate_range(a, b).values.astype("datetime64[D]"))
    idx = pd.bdate_range("2020-01-01", "2020-03-31")
    x = np.arange(len(idx), dtype=float)
    x[[3, 7]] = np.nan
    ref = pd.DataFrame({"a": x, "b": -x}, index=idx)
    got = as_frame(ref)
    sel = got.between("2020-01-15", "2020-02-20")
    np.testing.assert_array_equal(
        sel["a"], ref.loc["2020-01-15":"2020-02-20", "a"].to_numpy())
    np.testing.assert_array_equal(
        got.dropna(["a"])["b"], ref.dropna(subset=["a"])["b"].to_numpy())
    np.testing.assert_array_equal(got.take(x > 10)["a"],
                                  ref.loc[x > 10, "a"].to_numpy())


_value = hst.one_of(hst.floats(-1.0, 1.0, allow_nan=False, width=64),
                    hst.just(float("nan")), hst.just(0.25))


@settings(max_examples=80, deadline=None)
@given(hst.lists(_value, min_size=1, max_size=120),
       hst.sampled_from([1, 2, 3, 5, 20]), hst.sampled_from([None, 1, 2, 5]),
       hst.sampled_from([1e-3, 1.0, 1e3]))
def test_frame_ops_equal_pandas(values, window, min_periods, scale):
    x = np.asarray(values) * scale
    s = pd.Series(x)
    if min_periods is not None and min_periods > window:
        min_periods = window
    same = np.testing.assert_array_equal
    same(F.rolling_mean(x, window, min_periods),
         s.rolling(window, min_periods=min_periods).mean().to_numpy())
    same(F.ewm_std(x, 20), s.ewm(span=20, adjust=False).std().to_numpy())
    same(F.rolling_std(x, window, min_periods),
         s.rolling(window, min_periods=min_periods).std().to_numpy())
    same(F.rolling_sum(x, window, min_periods),
         s.rolling(window, min_periods=min_periods).sum().to_numpy())
    same(F.shift(x), s.shift(1).to_numpy())
    same(F.pct_change(x, 5), s.pct_change(5).to_numpy())
    same(F.ffill(x), s.ffill().to_numpy())
    same(F.bfill(x), s.bfill().to_numpy())
    same(F.fillna(x, 0.5), s.fillna(0.5).to_numpy())
    same(F.fillna(x, -x), s.fillna(pd.Series(-x)).to_numpy())
    same(F.interpolate_both(x),
         s.interpolate(limit_direction="both").to_numpy())
    same(F.diff(x), s.diff().to_numpy())
    same(F.cumprod(1 + x), (1 + s).cumprod().to_numpy())


def test_rolling_std_long_series_bitwise():
    """On NaN-free return series of history length the online algorithm is
    pandas' bit for bit (the regime inference's thresholds see the same
    realized vol)."""
    x = np.random.default_rng(5).standard_t(4, 26_000) * 0.01
    s = pd.Series(x)
    for w, mp in ((20, None), (20, 5), (200, 1)):
        np.testing.assert_array_equal(
            F.rolling_std(x, w, mp),
            s.rolling(w, min_periods=mp).std().to_numpy())
        np.testing.assert_array_equal(
            F.rolling_mean(x, w, mp),
            s.rolling(w, min_periods=mp).mean().to_numpy())


_POOL = (0.0, 1.0, 1e-3, 2.5e-4, 0.97, -0.5, 1e7, 3.3)
_FUZZ_CHUNKS, _FUZZ_PER_CHUNK = 6, 500


def _fuzz_series(chunk):
    """Chunk ``chunk`` of the 3,000-series fuzz: 3-12 values drawn from
    _POOL or rounded normals of a random decade, a window of 2-5."""
    rng = np.random.default_rng([2026, chunk])
    for _ in range(_FUZZ_PER_CHUNK):
        size = int(rng.integers(3, 13))
        if rng.random() < 0.5:
            x = rng.choice(_POOL, size)
        else:
            x = np.round(rng.normal(size=size)
                         * 10.0 ** int(rng.integers(-3, 4)),
                         int(rng.integers(0, 5)))
        yield x, int(rng.integers(2, 6))


@pytest.mark.parametrize("chunk", range(_FUZZ_CHUNKS))
def test_rolling_var_fuzz_equals_pandas(chunk):
    bad = [(x.tolist(), w) for x, w in _fuzz_series(chunk)
           if not np.array_equal(F.rolling_var(x, w),
                                 pd.Series(x).rolling(w).var().to_numpy(),
                                 equal_nan=True)]
    assert not bad, (len(bad), bad[:3])


@pytest.mark.parametrize("chunk", range(_FUZZ_CHUNKS))
def test_frame_helpers_fuzz_equal_pandas(chunk):
    """The host strategy oracle's frame operations on the same fuzz:
    shift, rolling sums, rolling means and stds with min_periods 1 then
    bfill().fillna(0), and the where-masked rolling mean of S8's RSI."""
    same = np.testing.assert_array_equal
    for x, w in _fuzz_series(chunk):
        s = pd.Series(x)
        same(F.shift(x), s.shift(1).to_numpy())
        same(F.rolling_sum(x, w, 1), s.rolling(w, min_periods=1).sum()
             .to_numpy())
        same(F.fillna(F.bfill(F.rolling_mean(x, w, 1)), 0),
             s.rolling(w, min_periods=1).mean().bfill().fillna(0).to_numpy())
        same(F.fillna(F.bfill(F.rolling_std(x, w, 1)), 0),
             s.rolling(w, min_periods=1).std().bfill().fillna(0).to_numpy())
        same(F.rolling_mean(np.where(x > 0, x, 0.0), w),
             s.where(s > 0, 0).rolling(w).mean().to_numpy())


@pytest.mark.parametrize("values, want_last", [
    # pandas' bits of the window [0, 0, 2.5e-4].
    ([1e-3, 0.0, 0.0, 2.5e-4], 2.0833333333333338e-08),
    # 1e7 leaves the window: pandas recomputes [2.5e-4, 1, 3.3] afresh.
    ([1e7, 2.5e-4, 1.0, 3.3], 2.862975020833333),
    # Three equal values: no equal-values shortcut to 0.
    ([0.0, 0.97, 1.0, 1.0, 1.0], 9.107298248878238e-17),
], ids=["small_values", "large_value_leaves", "equal_values"])
def test_rolling_var_named_examples(values, want_last):
    x = np.asarray(values)
    want = pd.Series(x).rolling(3).var().to_numpy()
    assert want[-1] == want_last
    np.testing.assert_array_equal(F.rolling_var(x, 3), want)
    np.testing.assert_array_equal(F.rolling_std(x, 3),
                                  pd.Series(x).rolling(3).std().to_numpy())


def test_host_oracle_frame_ops_equal_pandas():
    """The pandas expressions of the host strategy oracle on return and
    price series with a NaN head: rolling means and stds with min_periods
    then bfill().fillna(0), the where-masked rolling means of S8's RSI
    (-0.0 included), lagged rolling sums, pct_change of a lagged std;
    the rolling skew within 1e-12 with pandas' NaN pattern."""
    rng = np.random.default_rng(11)
    r = rng.standard_t(4, 1500) * 0.012
    r[:3] = np.nan
    s = pd.Series(r)
    price = pd.Series(np.cumprod(1 + np.nan_to_num(r)) * 100)
    same = np.testing.assert_array_equal
    same(F.fillna(F.bfill(F.rolling_std(r, 20, 5)), 0),
         s.rolling(20, min_periods=5).std().bfill().fillna(0).to_numpy())
    same(F.fillna(F.bfill(F.rolling_mean(r, 20, 5)), 0),
         s.rolling(20, min_periods=5).mean().bfill().fillna(0).to_numpy())
    delta = F.diff(price.to_numpy())
    pdelta = price.diff()
    same(F.rolling_mean(np.where(delta > 0, delta, 0.0), 14),
         pdelta.where(pdelta > 0, 0).rolling(14).mean().to_numpy())
    same(F.rolling_mean(-np.where(delta < 0, delta, 0.0), 14),
         (-pdelta.where(pdelta < 0, 0)).rolling(14).mean().to_numpy())
    neg = np.where(r < 0, r, 0.0)
    same(F.shift(F.rolling_std(neg, 20, 1)),
         s.where(s < 0, 0).rolling(20, min_periods=1).std().shift(1)
         .to_numpy())
    same(F.shift(F.rolling_sum(r, 126, 1)),
         s.rolling(126, min_periods=1).sum().shift(1).to_numpy())
    vs = F.shift(F.rolling_std(r, 20, 1))
    same(F.pct_change(vs, 5),
         s.rolling(20, min_periods=1).std().shift(1).pct_change(5).to_numpy())
    got = F.rolling_skew(r, 60, 1)
    want = s.rolling(60, min_periods=1).skew().to_numpy()
    same(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-12)
