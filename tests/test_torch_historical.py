"""The port's historical validation, the rest of the validation battery
and the date UI against the JAX package's, on the CPU.

Both packages read the same history: the port's offline frame
(``fetch_historical_data(force_synthetic=True)`` into a temporary cache)
and a pandas DataFrame built from its columns.

- The new frame operations against pandas: ``df[~df[flag]]`` (a boolean
  ``take``), ``iloc`` slices (``take`` of a slice) and
  ``rolling(20, min_periods=5).std().bfill().fillna(0)`` on a series with
  NaN gaps, bit for bit.
- ``infer_regime_from_vix_batched`` against the JAX package's vmapped
  ``infer_regime_from_vix_jax``: regimes exact in float64 and float32.
- ``backtest_strategies_on_history`` (1 y, the last 24 monthly windows):
  the windows' market channels and regimes exactly the JAX package's (its
  engine's input, captured); the strategies run in float32 (K4's plain
  version) where the JAX package's CPU route scans in float64, so each
  window's CAGR agrees within 5e-5 absolute (float32 rounding of a year of
  compounding).
- ``compare_simulated_vs_historical`` and
  ``compare_simulated_vs_synthetic_historical`` on the same results list:
  every score, table and rank exactly the JAX package's but the strategy
  backtests' (window counts exact, medians within 5e-5).
- ``run_strategy_on_history`` on the history's first 1,000 rows: each
  strategy's equity curve and trade count bitwise the JAX package's (the
  host strategy oracle on both sides, regimes inferred from VIX).
- ``run_institutional_sanity_checks`` and
  ``run_rolling_oos_calibration_backtest``: the checks equal; the
  out-of-sample numbers within rtol 1e-9 (both fit in float64).
- ``get_start_date_interactive`` and
  ``validate_time_horizons_for_start_date`` (the clock pinned).
"""

import contextlib
import datetime as _dt
import io
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from letf_tpu import config as jcfg
from letf_tpu import historical as jhist
from letf_tpu import ui as jui
from letf_tpu import validation as jvalidation
from letf_tpu.strategies import engine as jengine
from letf_tpu.utils.regime import infer_regime_from_vix_jax
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import historical, ui, validation
from letf_tpu_torch.data import fetch_historical_data
from letf_tpu_torch.utils import frame
from letf_tpu_torch.utils.regime import infer_regime_from_vix_batched
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CACHES = ("DATA_CACHE", "REGIME_MODEL_CACHE", "CORRELATION_CACHE",
          "VALIDATION_RESULTS", "JOINT_RETURN_MODEL_CACHE",
          "FUNDING_MODEL_CACHE", "TRACKING_RESIDUAL_CACHE",
          "STRESS_STATE_CACHE")
FITS = Path(__file__).resolve().parents[1] / "letf_tpu_cache_v1"
CAGR_ATOL = 5e-5


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    """(the port's Frame since 2005, the same as a pandas DataFrame)."""
    tmp = tmp_path_factory.mktemp("cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "CACHE_DIR", tmp)
        for name in CACHES:
            mp.setattr(tcfg, name, tmp / getattr(tcfg, name).name)
        with contextlib.redirect_stdout(io.StringIO()):
            df = fetch_historical_data(force_synthetic=True)
    df = df.between("2005-01-01", "2025-12-31")
    pdf = pd.DataFrame({c: df[c] for c in df.columns},
                       index=pd.DatetimeIndex(df.index))
    return df, pdf


def test_frame_operations_equal_pandas(history):
    df, pdf = history
    flag = "TQQQ_IsSynthetic"
    real = df.take(~np.asarray(df[flag], bool))
    preal = pdf[~pdf[flag]]
    assert len(real) == len(preal) and 0 < len(real) < len(df)
    np.testing.assert_array_equal(real.index,
                                  preal.index.values.astype("datetime64[D]"))
    for c in ("SPY_Ret", "TQQQ_Ret", "VIX"):
        np.testing.assert_array_equal(real[c], preal[c].to_numpy())
    part = df.take(slice(300, 300 + 2016)).copy()
    ppart = pdf.iloc[300:300 + 2016].copy()
    assert len(part) == 2016
    np.testing.assert_array_equal(part["IRX"], ppart["IRX"].to_numpy())
    np.testing.assert_array_equal(part.index,
                                  ppart.index.values.astype("datetime64[D]"))
    x = real["SPY_Ret"].copy()
    x[[0, 1, 2, 40, 41, 300]] = np.nan           # a head gap and holes
    x[500:530] = np.nan                          # a gap past the window
    got = frame.fillna(frame.bfill(frame.rolling_std(x, 20, 5)), 0.0)
    ref = (pd.Series(x).rolling(20, min_periods=5).std().bfill()
           .fillna(0).to_numpy())
    np.testing.assert_array_equal(got, ref)
    ok = ~np.isnan(real["SPY_Ret"])
    np.testing.assert_array_equal(
        frame.fillna(frame.bfill(frame.rolling_std(real["SPY_Ret"][ok], 20,
                                                   5)), 0.0),
        pd.Series(real["SPY_Ret"][ok]).rolling(20, min_periods=5).std()
        .bfill().fillna(0).to_numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_regime_scan_equals_the_reference(history, dtype):
    from letf_tpu_torch.utils.regime import _prep_inputs_np

    df, _ = history
    rv = frame.fillna(frame.bfill(frame.rolling_std(df["SPY_Ret"], 20, 5)),
                      0.0) * np.sqrt(252)
    vix, rv, ts = _prep_inputs_np(df["VIX"], rv, df["TNX"] - df["IRX"])
    idx = np.arange(0, 3000, 97)[None, :] + np.arange(504)[:, None]
    ins = [a[idx].astype(dtype) for a in (vix, rv, ts)]
    got = infer_regime_from_vix_batched(*(torch.from_numpy(a) for a in ins))
    ref = jax.vmap(infer_regime_from_vix_jax)(
        *(jnp.asarray(a.T) for a in ins))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).T)
    assert 0 < float(got.float().mean()) < 1


@pytest.fixture(scope="module")
def backtests(history):
    """(the port's backtest, its path; the JAX package's, its engine input)
    at 1 y over the last 24 windows."""
    df, pdf = history
    seen = {}
    inner = jengine.run_strategies_batch

    def spy(path, sig, **kw):
        seen["path"] = path
        return inner(path, sig, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "run_strategies_batch", spy)
        ref = jhist.backtest_strategies_on_history(pdf, 1, max_windows=24)
    path = {}
    got = historical.backtest_strategies_on_history(df, 1, max_windows=24,
                                                    device="cpu",
                                                    out_path=path)
    return got, path, ref, seen["path"]


def test_backtest_equals_the_reference(backtests):
    got, path, ref, jpath = backtests
    p = path["path"]
    assert p.etf_ret.dtype == torch.float64
    np.testing.assert_array_equal(p.etf_ret.numpy().transpose(2, 1, 0),
                                  np.asarray(jpath.etf_ret))
    for f in ("tlt_ret", "spy_ret", "qqq_ret", "vix", "regime", "cash_ret",
              "risk_free"):
        np.testing.assert_array_equal(getattr(p, f).numpy().T,
                                      np.asarray(getattr(jpath, f)), f)
    for f in ("start_offset", "initial_vix"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(jpath, f)), f)
    assert set(got) == set(ref)
    worst = 0.0
    for sid in ref:
        assert len(got[sid]) == len(ref[sid]) == 24, sid
        worst = max(worst, float(np.abs(got[sid] - ref[sid]).max()))
    assert worst < CAGR_ATOL, worst


def mc_results(n=64, seed=4):
    g = np.random.default_rng(seed)
    out = {}
    for k, sid in enumerate(tcfg.STRATEGIES):
        w = 10_000.0 * np.exp(g.normal(0.05 * (k % 5), 0.4 + 0.05 * k, n))
        out[sid] = [{"Final_Wealth": float(v)} for v in w]
    return out


def assert_same(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            assert_same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(got), path
    else:
        assert got == ref, (path, got, ref)


def test_comparisons_equal_the_reference(history):
    df, pdf = history
    mc = mc_results()
    outs = []
    for mod, d, kw in ((historical, df, {"device": "cpu"}),
                       (jhist, pdf, {})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            real = mod.compare_simulated_vs_historical(
                d, mc, 10, backtest_sids=("S4", "S9", "S19"), **kw)
            syn = mod.compare_simulated_vs_synthetic_historical(d, mc, 10)
            val = mod.validate_monte_carlo_vs_historical(d, mc, 5)
        outs.append((real, syn, val, buf.getvalue()))
    (real, syn, val, text), (jreal, jsyn, jval, jtext) = outs
    assert_same(syn, jsyn)
    assert_same(val, jval)
    assert syn["S1"]["extreme_events"]["worst_window_start"][:2] in ("19",
                                                                     "20")
    for sid in ("S1", "S2", "S3"):
        assert_same(real[sid], jreal[sid])
    for sid in ("S4", "S9", "S19"):
        a, b = real[f"{sid}_backtest"], jreal[f"{sid}_backtest"]
        assert a["n_windows"] == b["n_windows"] > 50
        assert a["n_sim"] == b["n_sim"] == 64
        np.testing.assert_allclose(a["hist_cagrs"], b["hist_cagrs"], rtol=0,
                                   atol=CAGR_ATOL)
        assert abs(a["hist_median"] - b["hist_median"]) < CAGR_ATOL
    lines = [ln for ln in text.splitlines() if "backtested" not in ln]
    jlines = [ln for ln in jtext.splitlines() if "backtested" not in ln]
    assert lines == jlines
    a = np.array([1.0, 2, 3, np.nan, 5, 6, 7])
    b = np.array([2.0, 1, 4, 3, 9, 8, 7, np.inf])
    assert historical.calculate_percentile_correlation(a, b) == \
        jhist.calculate_percentile_correlation(a, b)
    assert historical.calculate_distribution_overlap(a, b, 4) == \
        jhist.calculate_distribution_overlap(a, b, 4)
    assert historical.find_percentile_rank(4.0, a) == \
        jhist.find_percentile_rank(4.0, a)
    for h in (1, 3):
        np.testing.assert_array_equal(
            historical.calculate_rolling_cagrs_all_data(df, "SSO", h),
            jhist.calculate_rolling_cagrs_all_data(pdf, "SSO", h))


@pytest.mark.parametrize("sid", ["S4", "S7", "S8", "S17", "S19"])
def test_run_strategy_on_history_equals_the_reference(history, sid):
    df, pdf = history
    ec, nt = historical.run_strategy_on_history(df.take(slice(0, 1000)), sid)
    jec, jnt = jhist.run_strategy_on_history(pdf.iloc[:1000], sid)
    assert len(ec) == 1000 and np.isfinite(ec).all()
    np.testing.assert_array_equal(ec, jec.to_numpy())
    assert nt == jnt


def committed(name):
    return pickle.loads((FITS / f"{name}.pkl").read_bytes())


def test_sanity_checks_equal_the_reference():
    regime = committed("regime_model")
    funding = committed("funding_spread_model")
    tracking = committed("tracking_residual_model")
    cases = [(regime, funding, tracking),
             (regime, dict(funding, beta_vix=0.0004), tracking),
             ({"transition_matrix": [[0.9, 0.2], [0.1, 0.9]]},
              dict(funding, beta_vix=0.0004),
              {"TQQQ": {"rho": 0.95, "base_scale": 0.001, "df": 5.0}}),
             ({}, funding, {})]
    seen = set()
    for regime_model, fm, tm in cases:
        got = validation.run_institutional_sanity_checks(regime_model, fm, tm,
                                                         device="cpu")
        ref = jvalidation.run_institutional_sanity_checks(regime_model, fm,
                                                          tm)
        assert got == ref
        seen.add(got["all_passed"])
    assert seen == {True, False}


def test_rolling_oos_equals_the_reference(history):
    df, pdf = history
    got = validation.run_rolling_oos_calibration_backtest(df, device="cpu")
    ref = jvalidation.run_rolling_oos_calibration_backtest(pdf)
    assert got["sufficient_data"] and got["splits_run"] == 3
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-9, abs=1e-15), k
        else:
            assert got[k] == v, k
    short = validation.run_rolling_oos_calibration_backtest(
        df.take(slice(0, 2000)), device="cpu")
    assert_same(short, jvalidation.run_rolling_oos_calibration_backtest(
        pdf.iloc[:2000]))
    assert not short["sufficient_data"]


class _Clock(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 3, 1)


@pytest.mark.parametrize("answers", [
    (), ("3",), ("7", "2001-02-29"), ("7", "1999-1-5"), ("x",), ("6",)])
def test_date_ui_equals_the_reference(monkeypatch, answers):
    cleared = []
    for c in (tcfg, jcfg):
        monkeypatch.setattr(c, "ANALYSIS_START_DATE", c.ANALYSIS_START_DATE)
        monkeypatch.setattr(c, "clear_all_caches",
                            lambda c=c: cleared.append(c))
    for mod in (ui, jui):
        monkeypatch.setattr(mod, "datetime", _Clock)
    outs = []
    for mod, c in ((ui, tcfg), (jui, jcfg)):
        if answers:
            monkeypatch.delenv("LETF_NON_INTERACTIVE", raising=False)
            monkeypatch.delenv("LETF_NONINTERACTIVE", raising=False)
            monkeypatch.setattr("sys.stdin.isatty", lambda: True)
            feed = iter(answers + ("",) * 4)
            monkeypatch.setattr("builtins.input", lambda *_: next(feed))
        else:
            monkeypatch.setenv("LETF_NON_INTERACTIVE", "1")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rng = mod.get_start_date_interactive()
            hz = mod.validate_time_horizons_for_start_date(
                c.ANALYSIS_START_DATE, [5, 10, 20, 30, 50, 80])
            bad = mod.validate_time_horizons_for_start_date(None, [10])
        outs.append((rng, hz, bad, buf.getvalue(), c.ANALYSIS_START_DATE))
    assert outs[0] == outs[1]
    assert cleared.count(tcfg) == cleared.count(jcfg)
