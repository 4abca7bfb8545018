"""The validation battery: mathematical invariants on the port's kernels,
structural sanity checks and the rolling out-of-sample calibration.

Port of ``letf_tpu/validation.py``: the two Monte Carlo invariants
(``_neutral_model``, ``validate_zero_drift_vol_drag``,
``validate_flat_market_decay``) with the reference's tolerances (an
L-times daily-rebalanced fund on a zero-drift underlying of volatility
sigma realises a median annual return of -0.5 L^2 sigma^2),
``run_institutional_sanity_checks`` (transition matrix, the counter
streams' uniqueness, tracking bounds, the funding model's features
through ``ops/path_engine.borrow_spread_series``),
``run_rolling_oos_calibration_backtest`` (the port's funding and tracking
fits on ``Frame`` slices) and ``run_validation_tests``, which writes
``cfg.VALIDATION_RESULTS`` into the port's own cache directory.

- Zero-drift drag (3x, 15% vol, 252 days, within 1.5%): driven through
  kernel K3 (``compose_strategies``, the production chunk's kernel) with
  every cost, stress and tracking-error channel zeroed, as the reference
  drives its Pallas slab kernel; S1's final wealth is the compounded
  L-times return.
- Flat-market decay (2x and 3x, within 2%): driven through kernel K6
  (``gbm_buyhold``) with at least 65,536 paths on the card, as the
  reference drives its Pallas kernel, and over n_sims paths of its plain
  version elsewhere, as the reference's XLA route.

On a CUDA device the kernels launch; on the CPU their plain versions run.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import gbm, rng
from letf_tpu_torch.utils.device import glue_dtype, resolve_device
from letf_tpu_torch.utils.frame import Frame, fillna


def _neutral_model(leverage: float):
    """default_sim_model with every cost/stress/TE channel zeroed and all
    assets at ``leverage``: the clean zero-drift configuration."""
    model = tparams.default_sim_model()
    A = model.assets
    zero = np.zeros_like(np.asarray(A.expense_ratio, np.float64))
    st, fu, tr = model.stress, model.funding, model.tracking
    return model._replace(
        assets=A._replace(leverage=np.full_like(zero, leverage),
                          expense_ratio=zero, fallback_spread=zero,
                          beta=np.ones_like(zero)),
        stress=type(st)(*(np.zeros_like(v) for v in st)),
        funding=type(fu)(*(np.zeros_like(v) for v in fu)),
        tracking=tr._replace(rho=np.zeros_like(tr.rho),
                             te_scale=np.zeros_like(tr.te_scale),
                             clip_limit=np.zeros_like(tr.clip_limit)),
        cash_rate=np.zeros_like(np.asarray(model.cash_rate, np.float64)))


def _zero_drift_median(seed: int, leverage: float, daily_std: float,
                       n_sims: int, n_days: int, device) -> float:
    """Median S1 return of zero-drift normal underlyings (normal draws of
    key(seed), [n_sims, n_days] float32, times daily_std) through K3 with
    the neutral model: vix 20, irx 0, regime 0, costs off."""
    dev = resolve_device(device)
    model = _neutral_model(leverage)
    z = rng.normal(rng.key(seed, dev)[None], n_sims * n_days,
                   torch.float32)[0].reshape(n_sims, n_days)
    zs = (z * daily_std).t().contiguous()
    const = torch.full_like(zs, 20.0)
    zeros = torch.zeros_like(zs)
    fw = k3.compose_strategies(
        tparams.pack_stress_params(model).to(dev),
        tparams.pack_asset_params(model).to(dev),
        torch.arange(n_sims, dtype=torch.int32, device=dev), [0, 0],
        zs, zs, zs, const, zeros, zeros, apply_costs=False)[0]
    s1 = cfg.STRATEGY_INDEX["S1"]
    return float(torch.quantile(fw[:, s1] / cfg.INITIAL_CAPITAL - 1.0, 0.5))


def validate_zero_drift_vol_drag(n_sims: int = 10_000, seed: int = 42,
                                 device="cuda") -> Dict:
    """With zero drift and 15% vol a 3x daily-rebalanced LETF realises
    -0.5 L^2 sigma^2 a year: median within 1.5% absolute."""
    annual_vol, leverage, n_days = 0.15, 3.0, 252
    daily_std = annual_vol / np.sqrt(252)
    print(f"\n{'=' * 80}")
    print("VALIDATION: ZERO-DRIFT VOLATILITY DRAG "
          f"({n_sims:,} paths x {n_days}d, {leverage}x, vol {annual_vol:.0%})")
    print(f"{'=' * 80}")
    actual = _zero_drift_median(seed, leverage, daily_std, n_sims, n_days,
                                device)
    expected = -0.5 * leverage ** 2 * annual_vol ** 2
    err = abs(actual - expected)
    engine = ("compose_strategies_kernel"
              if torch.device(device).type == "cuda"
              else "compose_strategies_plain")
    print(f"  expected {expected * 100:+.2f}%  simulated {actual * 100:+.2f}%"
          f"  error {err * 100:.2f}%  [{engine}] "
          f"-> {'PASSED' if err < 0.015 else 'FAILED'}")
    return {"test_passed": bool(err < 0.015), "expected_drag": expected,
            "actual_drag": actual, "error_pct": err * 100, "engine": engine}


def validate_flat_market_decay(n_sims: int = 5_000, seed: int = 42,
                               device="cuda") -> Dict:
    """2x and 3x decay in a flat 15%-vol market vs -0.5 L^2 sigma^2, each
    median within 2% absolute. On the card over max(n_sims, 65,536) K6
    paths, as the reference's kernel route takes at least 65,536 (the
    median's sampling error ~0.2%, against ~0.8% at 5,000); elsewhere over
    n_sims paths of the plain version, as its XLA route does."""
    annual_vol, n_days = 0.15, 252
    daily_std = annual_vol / np.sqrt(252)
    on_card = torch.device(device).type == "cuda"
    n = max(n_sims, 65536) if on_card else n_sims
    engine = "gbm_kernel" if on_card else "gbm_plain"
    print(f"\n{'=' * 80}")
    print(f"VALIDATION: FLAT MARKET DECAY ({n_sims:,} paths x {n_days}d)")
    print(f"{'=' * 80}")
    results: Dict = {}
    all_passed = True
    for leverage in (2.0, 3.0):
        w, _ = gbm.gbm_buyhold(seed + int(leverage), n, n_days, 0.0,
                               float(daily_std), leverage, 0.0, device)
        actual = float(torch.quantile(w, 0.5)) - 1.0
        expected = -0.5 * leverage ** 2 * annual_vol ** 2
        err = abs(actual - expected)
        passed = err < 0.02
        all_passed &= passed
        print(f"  {leverage}x: expected {expected * 100:+.2f}% "
              f"simulated {actual * 100:+.2f}% error {err * 100:.2f}% "
              f"[{engine}] -> {'PASSED' if passed else 'FAILED'}")
        results[f"{leverage}x"] = {"expected": expected,
                                   "actual_median": actual, "error": err,
                                   "passed": bool(passed), "engine": engine}
    results["all_passed"] = bool(all_passed)
    return results


def run_institutional_sanity_checks(regime_model: Dict, funding_model: Dict,
                                    tracking_residual_model: Dict, *,
                                    device="cuda") -> Dict:
    """Deterministic structural checks (validation.py:191-261):
    transition-matrix hygiene, the uniqueness of the counter streams (the
    threefry trial keys and their stream folds, the analogue of the
    reference's seed-collision check), tracking parameter bounds, and the
    funding model's feature activation on ``device``."""
    from letf_tpu_torch.ops.path_engine import borrow_spread_series

    dev = resolve_device(device)
    checks = {
        "transition_matrix_finite": False,
        "transition_matrix_row_stochastic": False,
        "transition_matrix_nonnegative": False,
        "te_seed_collision_free": False,
        "tracking_model_params_valid": False,
        "funding_vix_activates": False,
        "funding_inv_curve_activates": False,
        "funding_liquidity_activates": False,
        "funding_credit_activates": False,
        "all_passed": False,
    }

    tm = np.asarray(regime_model.get("transition_matrix", np.array([])), float)
    if tm.size > 0:
        checks["transition_matrix_finite"] = bool(np.isfinite(tm).all())
        checks["transition_matrix_row_stochastic"] = bool(
            np.allclose(tm.sum(axis=1), 1.0, atol=1e-6))
        checks["transition_matrix_nonnegative"] = bool((tm >= -1e-12).all())

    # Counter-based streams: per-trial keys and per-stream folds must be
    # pairwise distinct (replaces _stable_asset_seed collision check).
    tks = rng.trial_key(rng.key(12345, dev),
                        torch.arange(4, dtype=torch.int64, device=dev))
    folds = torch.stack([rng.stream(tks, s) for s in range(10)], 1)
    keys = [tuple(k) for k in folds.reshape(-1, 2).tolist()]
    checks["te_seed_collision_free"] = len(keys) == len(set(keys))

    te_ok = True
    for _, p in (tracking_residual_model or {}).items():
        rho = float(p.get("rho", np.nan))
        scale = float(p.get("base_scale", np.nan))
        dfv = float(p.get("df", np.nan))
        if not (np.isfinite(rho) and 0.0 <= rho <= 0.9):
            te_ok = False
        if not (np.isfinite(scale) and scale > 0):
            te_ok = False
        if not (np.isfinite(dfv) and dfv > 2.0):
            te_ok = False
    checks["tracking_model_params_valid"] = te_ok

    # Funding feature activation probes on the device spread function.
    dt = glue_dtype(dev)
    model = tparams.from_numpy(
        tparams.build_sim_model({"funding_model": funding_model}), dev, dt)
    n = 10

    def full(v):
        return torch.full((n,), v, dtype=dt, device=dev)

    base_vix, rf, zeros = full(20.0), full(0.04), full(0.0)

    def mean_spread(vix, liq, cred):
        return float(torch.nanmean(
            borrow_spread_series(model, vix, rf, liq, cred)))

    base = mean_spread(base_vix, zeros, zeros)
    checks["funding_vix_activates"] = mean_spread(
        full(45.0), zeros, zeros) > base
    # Inverted curve is driven by credit stress in-sim (term = 1.25-1.1*cred);
    # credit > 1.14 flips the curve, activating both channels.
    checks["funding_inv_curve_activates"] = mean_spread(
        base_vix, zeros, full(2.0)) > base
    checks["funding_liquidity_activates"] = mean_spread(
        base_vix, full(2.5), zeros) > base
    checks["funding_credit_activates"] = mean_spread(
        base_vix, zeros, full(2.5)) > base

    checks["all_passed"] = all(v for k, v in checks.items() if k != "all_passed")
    return checks


def run_rolling_oos_calibration_backtest(df, n_splits: int = 3,
                                         train_years: int = 8,
                                         test_years: int = 2, *,
                                         device="cuda") -> Dict:
    """Rolling out-of-sample calibration drift (validation.py:264-332):
    the funding model's MAE and the tracking residual's std on held-out
    windows; the fits run on ``device``. ``df``: the history
    (``utils/frame.Frame``); ``iloc`` slices are ``Frame.take`` of a
    slice."""
    from letf_tpu_torch.calibration import (
        calibrate_funding_spread_model,
        calibrate_tracking_residual_model,
        predict_borrow_spread_series,
    )

    window_train = int(train_years * 252)
    window_test = int(test_years * 252)
    total_needed = window_train + window_test

    out = {
        "splits_run": 0,
        "funding_mae_mean": float("nan"),
        "tracking_residual_std_mean": float("nan"),
        "funding_beta_vix_drift": float("nan"),
        "sufficient_data": False,
    }
    if df is None or len(df) < total_needed + 252:
        return out

    starts = np.linspace(0, len(df) - total_needed, n_splits, dtype=int)
    maes, rstds, betas = [], [], []
    for start in starts:
        train_df = df.take(slice(start, start + window_train)).copy()
        test_df = df.take(slice(start + window_train,
                                start + total_needed)).copy()
        if len(train_df) < window_train or len(test_df) < window_test:
            continue
        funding = calibrate_funding_spread_model(train_df, bypass_cache=True,
                                                 device=device)
        calibrate_tracking_residual_model(train_df, funding_model=funding,
                                          bypass_cache=True, device=device)
        betas.append(float(funding.get("beta_vix", np.nan)))

        irx = test_df.get("IRX", np.full(len(test_df), 4.5))
        spread_input = Frame({"VIX": test_df["VIX"], "IRX": irx},
                             test_df.index)
        if "TNX" in test_df:
            spread_input["TNX"] = test_df["TNX"]
        test_spread = predict_borrow_spread_series(spread_input, funding)
        maes.append(float(np.nanmean(np.abs(test_spread - funding["base"]))))

        split_stds = []
        for asset in ("TQQQ", "UPRO", "SSO"):
            col = f"{asset}_Real_Ret"
            if col not in test_df:
                continue
            idx = (test_df["QQQ_Ret"] if (asset == "TQQQ"
                                          and "QQQ_Ret" in test_df)
                   else test_df["SPY_Ret"])
            lev = cfg.ASSETS[asset].leverage
            rf = fillna(irx, 4.5) / 100.0
            finance = (lev - 1.0) * (rf + test_spread) / 252.0
            expected = (lev * idx - finance
                        - cfg.ASSETS[asset].expense_ratio / 252.0)
            resid = test_df[col] - expected
            resid = resid[np.isfinite(resid)]
            if len(resid) > 20:
                split_stds.append(float(np.nanstd(resid)))
        if split_stds:
            rstds.append(float(np.nanmean(split_stds)))

    if maes:
        out["splits_run"] = len(maes)
        out["funding_mae_mean"] = float(np.nanmean(maes))
        out["tracking_residual_std_mean"] = (float(np.nanmean(rstds))
                                             if rstds else float("nan"))
        if len(betas) >= 2:
            out["funding_beta_vix_drift"] = float(np.nanmax(betas)
                                                  - np.nanmin(betas))
        out["sufficient_data"] = True
    return out


def run_validation_tests(df=None, regime_model: Optional[Dict] = None, *,
                         device="cuda") -> Dict:
    """Run the full battery on ``device`` and save it as JSON in the port's
    cache (``cfg.VALIDATION_RESULTS``; validation.py:335-392)."""
    print(f"\n{'=' * 80}")
    print("RUNNING VALIDATION TESTS")
    print(f"{'=' * 80}")

    results = {
        "zero_drift_test": validate_zero_drift_vol_drag(device=device),
        "flat_market_test": validate_flat_market_decay(device=device),
    }
    if regime_model is not None:
        results["institutional_sanity"] = run_institutional_sanity_checks(
            regime_model=regime_model,
            funding_model=regime_model.get("funding_model", {}),
            tracking_residual_model=regime_model.get(
                "tracking_residual_model", {}), device=device)
    if df is not None:
        results["rolling_oos"] = run_rolling_oos_calibration_backtest(
            df, device=device)

    cfg.init_cache()
    with open(cfg.VALIDATION_RESULTS, "w") as f:
        json.dump(results, f, indent=2, default=float)

    passed = results["zero_drift_test"]["test_passed"]
    print(f"\n  Zero-drift vol drag: {'PASSED' if passed else 'FAILED'}")
    if "institutional_sanity" in results:
        ok = results["institutional_sanity"].get("all_passed", False)
        print(f"  Institutional sanity: {'PASSED' if ok else 'FAILED'}")
    if "rolling_oos" in results:
        oos = results["rolling_oos"]
        if oos.get("sufficient_data"):
            print(f"  Rolling OOS: splits={oos['splits_run']}, "
                  f"funding MAE={oos['funding_mae_mean']:.6f}")
        else:
            print("  Rolling OOS: skipped (insufficient data)")
    return results
