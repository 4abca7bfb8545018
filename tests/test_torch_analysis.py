"""The port's full analysis (``runner.run``) on the CPU, and the
signatures of the analysis modules against the JAX package's.

- Every ported entry takes the reference's parameters, in its names,
  defaults and order, plus the port's keyword-only ones (``device="cuda"``,
  ``stage_seconds``, ``out_path``).
- ``runner.run(horizons=[1], force_synthetic=True, device="cpu")`` at 8
  trials from a cold cache in a temporary directory: every step of the
  reference's timing summary, the battery's JSON in the port's cache, and
  the returned summary equal (rtol 1e-12) to the JAX package's
  ``create_summary_statistics`` on the same results list (captured). The
  zero-drift invariant runs at 256 paths here: it has its own test at the
  reference's 10,000 (tests/test_torch_validation.py), as the calibration
  has (tests/test_torch_calibration.py).

The CLI's branches run in tests/test_torch_cli.py.
"""

import contextlib
import functools
import inspect
import io
import json
import math

import pytest

from letf_tpu import historical as jhist
from letf_tpu import integration as jintegration
from letf_tpu import reporting as jreporting
from letf_tpu import ui as jui
from letf_tpu import validation as jvalidation
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu.tax import lot_selection as jlots
from letf_tpu.tax import marginal as jmarginal
from letf_tpu.tax import regimes as jregimes
from letf_tpu.tax import vectorized as jvectorized
from letf_tpu_torch import historical, integration, reporting, runner
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import ui, validation
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.tax import lot_selection, marginal, regimes, vectorized
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CACHES = ("DATA_CACHE", "REGIME_MODEL_CACHE", "CORRELATION_CACHE",
          "VALIDATION_RESULTS", "JOINT_RETURN_MODEL_CACHE",
          "FUNDING_MODEL_CACHE", "TRACKING_RESIDUAL_CACHE",
          "STRESS_STATE_CACHE", "BOOTSTRAP_CACHE")

ENTRIES = [
    (mc_runner.parallel_monte_carlo_fixed, jmc, ["device"]),
    (mc_runner.emit_regime_paths, jmc, ["device"]),
    (mc_runner.build_anchor_conditions, jmc, []),
    (reporting.create_summary_statistics, jreporting, ["stage_seconds"]),
    (reporting.get_tax_config_interactive, jreporting, []),
    (reporting.estimate_tax_simple, jreporting, []),
    (reporting.explain_percentile, jreporting, []),
    (historical.backtest_strategies_on_history, jhist,
     ["device", "out_path"]),
    (historical.backtest_strategy_on_history, jhist, ["device"]),
    (historical.compare_simulated_vs_historical, jhist, ["device"]),
    (historical.compare_simulated_vs_synthetic_historical, jhist, []),
    (historical.validate_monte_carlo_vs_historical, jhist, []),
    (historical.calculate_historical_rolling_cagrs, jhist, []),
    (historical.run_strategy_on_history, jhist, []),
    (validation.run_institutional_sanity_checks, jvalidation, ["device"]),
    (validation.run_rolling_oos_calibration_backtest, jvalidation,
     ["device"]),
    (validation.run_validation_tests, jvalidation, ["device"]),
    (ui.get_start_date_interactive, jui, []),
    (ui.validate_time_horizons_for_start_date, jui, []),
    (integration.process_trades_with_wired_engine, jintegration, []),
    (integration.process_monte_carlo_with_wired_engine, jintegration, []),
    (integration.generate_ultimate_report, jintegration, []),
    (vectorized.yearly_activity_from_trades, jvectorized, []),
    (lot_selection.get_lots_to_sell, jlots, []),
    (marginal.calculate_comprehensive_tax_v6, jmarginal, []),
    (regimes.monte_carlo_tax_regimes, jregimes, []),
]


def params(fn):
    return [(p.name, p.default, p.kind)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("fn,ref_mod,extra", ENTRIES,
                         ids=[e[0].__name__ for e in ENTRIES])
def test_signature_matches_the_reference(fn, ref_mod, extra):
    got = params(fn)
    ref = params(getattr(ref_mod, fn.__name__))
    assert got[:len(got) - len(extra)] == ref
    for name, default, kind in got[len(got) - len(extra):]:
        assert name in extra and kind == inspect.Parameter.KEYWORD_ONLY
        assert default == ("cuda" if name == "device" else None)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The port's caches in a temporary directory, 8 trials a horizon, the
    zero-drift invariant at 256 paths."""
    tmp = tmp_path_factory.mktemp("letf_tpu_torch_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "CACHE_DIR", tmp)
        for name in CACHES:
            mp.setattr(tcfg, name, tmp / getattr(tcfg, name).name)
        mp.setattr(tcfg, "NUM_SIMULATIONS", 8)
        mp.setattr(tcfg, "ANALYSIS_START_DATE", tcfg.ANALYSIS_START_DATE)
        mp.setattr(validation, "validate_zero_drift_vol_drag",
                   functools.partial(validation.validate_zero_drift_vol_drag,
                                     n_sims=256))
        mp.setenv("LETF_NON_INTERACTIVE", "1")
        yield tmp


def assert_close(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            assert_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, str):
        assert got == ref, path
    else:
        g, r = float(got), float(ref)
        if math.isnan(r):
            assert math.isnan(g), path
        else:
            assert g == pytest.approx(r, rel=1e-12, abs=1e-9), (path, g, r)


def test_run_on_the_cpu(cache, monkeypatch, capsys):
    seen = {}
    inner = mc_runner.parallel_monte_carlo_fixed

    def keep(*a, **kw):
        out = inner(*a, **kw)
        seen[kw["time_horizon"]] = out
        return out

    monkeypatch.setattr(mc_runner, "parallel_monte_carlo_fixed", keep)
    stages = {}
    summaries = runner.run(horizons=[1], seed=0, force_synthetic=True,
                           device="cpu", stage_seconds=stages)
    text = capsys.readouterr().out
    steps = ["Tax engine validation", "Date selection",
             "Fetch historical data", "Tax configuration",
             "Calibration (all models)", "Validation tests",
             "MC simulation 1Y", "Summary stats 1Y",
             "Historical comparison 1Y"]
    assert list(stages)[:len(steps)] == steps
    assert set(stages) == set(steps) | {"Summary stats 1Y: replay",
                                        "Summary stats 1Y: host tax chain"}
    timing = text[text.index("TIMING SUMMARY"):]
    for label in steps + ["replay", "host tax chain", "TOTAL"]:
        assert label in timing, label
    assert text.rstrip().endswith("ANALYSIS COMPLETE")
    for banner in ("GOLDEN-CASE REGRESSION TESTS", "RUNNING VALIDATION TESTS",
                   "MONTE CARLO: 8 sims x 1Y", "ROTH IRA COMPATIBLE - 1-YEAR",
                   "TAXABLE BROKERAGE - 1-YEAR HORIZON (California, "
                   "$150,000, single)", "HISTORICAL VALIDATION (1Y",
                   "SYNTHETIC-HISTORY VALIDATION (1Y"):
        assert banner in text, banner
    res = json.loads((cache / "validation_results.json").read_text())
    assert set(res) == {"zero_drift_test", "flat_market_test",
                        "institutional_sanity", "rolling_oos"}
    assert res["zero_drift_test"]["test_passed"]
    assert res["rolling_oos"]["splits_run"] == 3
    assert list(summaries) == [1]
    mc = seen[1]
    assert len(mc) == 19 and all(len(v) == 8 for v in mc.values())
    with contextlib.redirect_stdout(io.StringIO()):
        ref = jreporting.create_summary_statistics(
            mc, 1, tax_config=dict(jreporting.DEFAULT_TAX_CONFIG))
    assert_close(summaries[1], ref)
