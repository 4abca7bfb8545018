"""The mathematical invariants of the validation battery, on the port's
kernels.

Port of the two Monte Carlo invariants of ``letf_tpu/validation.py``
(``_neutral_model``, ``validate_zero_drift_vol_drag``,
``validate_flat_market_decay``) with the reference's tolerances: an
L-times daily-rebalanced fund on a zero-drift underlying of volatility
sigma realises a median annual return of -0.5 L^2 sigma^2.

- Zero-drift drag (3x, 15% vol, 252 days, within 1.5%): driven through
  kernel K3 (``compose_strategies``, the production chunk's kernel) with
  every cost, stress and tracking-error channel zeroed, as the reference
  drives its Pallas slab kernel; S1's final wealth is the compounded
  L-times return.
- Flat-market decay (2x and 3x, within 2%): driven through kernel K6
  (``gbm_buyhold``) with at least 65,536 paths, as the reference drives
  its Pallas kernel.

On a CUDA device the kernels launch; on the CPU their plain versions run.
The rest of the battery (structural sanity checks, rolling calibration,
the orchestration) waits for ROADMAP section 1 item 16.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import gbm, rng
from letf_tpu_torch.utils.device import resolve_device


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
    actual = _zero_drift_median(seed, leverage, daily_std, n_sims, n_days,
                                device)
    expected = -0.5 * leverage ** 2 * annual_vol ** 2
    err = abs(actual - expected)
    engine = ("compose_strategies_kernel"
              if torch.device(device).type == "cuda"
              else "compose_strategies_plain")
    return {"test_passed": bool(err < 0.015), "expected_drag": expected,
            "actual_drag": actual, "error_pct": err * 100, "engine": engine}


def validate_flat_market_decay(n_sims: int = 5_000, seed: int = 42,
                               device="cuda") -> Dict:
    """2x and 3x decay in a flat 15%-vol market vs -0.5 L^2 sigma^2, each
    median within 2% absolute, over max(n_sims, 65,536) K6 paths."""
    annual_vol, n_days = 0.15, 252
    daily_std = annual_vol / np.sqrt(252)
    n = max(n_sims, 65536)
    engine = ("gbm_kernel" if torch.device(device).type == "cuda"
              else "gbm_plain")
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
        results[f"{leverage}x"] = {"expected": expected,
                                   "actual_median": actual, "error": err,
                                   "passed": bool(passed), "engine": engine}
    results["all_passed"] = bool(all_passed)
    return results
