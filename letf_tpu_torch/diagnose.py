"""Diagnostics: layer-by-layer pipeline traces and drag decomposition.

Port of ``letf_tpu/diagnose.py``, the reference's three diagnostic
scripts: ``diagnose_pipeline`` (the path engine traced layer by layer with
a hand-built known-good joint model), ``diagnose_letf_drag`` (TQQQ's drag
sources on one path: perfect leverage, then costs, then tracking error)
and ``diagnose_tqqq_detailed`` (one path's daily TQQQ components). Each
runs the per-trial institutional engine (``ops/path_engine.py``) on
``device`` and returns its numbers as a dict.

    python -m letf_tpu_torch.diagnose [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models.params import (
    SimModel,
    default_sim_model,
    derive_joint_params,
    from_numpy,
)
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_engine import (
    draw_innovations_jit,
    generate_paths_batch,
    path_from_innovations_jit,
)
from letf_tpu_torch.utils.device import glue_dtype, resolve_device


def known_good_model() -> SimModel:
    """Hand-built joint model with benign, well-understood parameters
    (the reference diagnose.py:39-58 pattern): 8%/16% SPY, mild GARCH,
    nu=6."""
    base = default_sim_model()
    mu = np.array([[0.08, 0.10, 0.03], [0.08, 0.10, 0.03]]) / 252.0
    vol = np.array([[0.16, 0.22, 0.10], [0.22, 0.30, 0.13]])
    corr = np.array([[[1.0, 0.88, -0.2], [0.88, 1.0, -0.15],
                      [-0.2, -0.15, 1.0]]] * 2)
    dvol = vol / np.sqrt(252)
    cov = dvol[:, :, None] * dvol[:, None, :] * corr
    joint = derive_joint_params(mu=mu, cov=cov, nu=[6.0, 6.0],
                                alpha=[0.05, 0.05], beta=[0.90, 0.90],
                                dcc_a=[0.02, 0.02], dcc_b=[0.95, 0.95])
    return base._replace(joint=joint)


def _model_on(device):
    dev = resolve_device(device)
    return from_numpy(known_good_model(), dev, glue_dtype(dev)), dev


def _host(a: torch.Tensor) -> np.ndarray:
    return a.cpu().numpy()


def diagnose_pipeline(years: int = 5, n_trials: int = 64, seed: int = 0, *,
                      device="cuda") -> Dict:
    """Trace every layer with the known-good model and print sanity stats."""
    model, dev = _model_on(device)
    S = years * 252
    path = generate_paths_batch(
        model, rng.key(seed, dev), torch.arange(n_trials, device=dev),
        torch.zeros(n_trials, dtype=torch.bool, device=dev), sim_days=S,
        buffer_days=504)

    print("=" * 80)
    print("PIPELINE DIAGNOSTIC (known-good joint model)")
    print("=" * 80)
    out = {}

    spy = _host(path.spy_ret)
    out["spy_ann_mean"] = float(spy.mean() * 252)
    out["spy_ann_vol"] = float(spy.std() * np.sqrt(252))
    print(f"  L2 joint model : SPY ann mean {out['spy_ann_mean']:+.2%}, "
          f"vol {out['spy_ann_vol']:.2%} (targets ~+8%, ~16-20%)")

    reg = _host(path.regime)
    out["high_vol_frac"] = float((reg == 1).mean())
    print(f"  L3 regimes     : high-vol fraction {out['high_vol_frac']:.1%}")

    vix = _host(path.vix)
    out["vix_mean"] = float(vix.mean())
    print(f"  L3 VIX         : mean {out['vix_mean']:.1f}, "
          f"range [{vix.min():.1f}, {vix.max():.1f}]")

    etf = _host(path.etf_ret)                                 # [A, S, B]
    for i, name in enumerate(cfg.ASSET_NAMES):
        w = np.prod(1 + etf[i], axis=0)
        out[f"{name}_median_cagr"] = float(np.median(w) ** (1 / years) - 1)
    print("  L5 LETF layers : median CAGRs " + ", ".join(
        f"{n}={out[f'{n}_median_cagr']:+.1%}" for n in cfg.ASSET_NAMES))

    out["valid_frac"] = float(_host(path.valid).mean())
    print(f"  L7 layer checks: valid fraction {out['valid_frac']:.0%}")
    return out


def _one_path(years: int, seed: int, device):
    """Trial 0's path of ``years`` years (no random start) on the
    known-good model: its draws, then its path math."""
    model, dev = _model_on(device)
    S = years * 252
    innov = draw_innovations_jit(
        model, rng.key(seed, dev), torch.zeros(1, dtype=torch.int64,
                                               device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev), S, 0, "none")
    return path_from_innovations_jit(model, innov, S)


def diagnose_letf_drag(years: int = 10, seed: int = 0, *,
                       device="cuda") -> Dict:
    """Isolate TQQQ drag sources on ONE shared path: perfect 3x leverage,
    then +expense/borrow, then +tracking error (the full ETF return).
    Uses the known-good model so the decomposition stays off the -100%
    clip (the default fallback parameterization is deliberately harsh)."""
    path = _one_path(years, seed, device)
    qqq = _host(path.qqq_ret[:, 0])
    rf = _host(path.risk_free[:, 0])
    full = _host(path.etf_ret[cfg.ASSET_INDEX["TQQQ"], :, 0])
    ac = cfg.ASSETS["TQQQ"]

    perfect = 3.0 * qqq
    borrow = 2.0 * np.maximum(rf + ac.borrow_spread, 0) / 252.0
    with_costs = perfect - ac.expense_ratio / 252.0 - borrow

    def cagr(r):
        return float(np.prod(1 + np.clip(r, -0.999, None)) ** (1 / years)
                     - 1)

    out = {
        "qqq_cagr": cagr(qqq),
        "perfect_3x_cagr": cagr(perfect),
        "with_costs_cagr": cagr(with_costs),
        "full_etf_cagr": cagr(full),
    }
    out["vol_drag"] = out["perfect_3x_cagr"] - 3 * out["qqq_cagr"]
    out["cost_drag"] = out["with_costs_cagr"] - out["perfect_3x_cagr"]
    out["te_drag"] = out["full_etf_cagr"] - out["with_costs_cagr"]

    print("=" * 80)
    print(f"TQQQ DRAG DECOMPOSITION ({years}y single path)")
    print("=" * 80)
    print(f"  QQQ underlying CAGR     : {out['qqq_cagr']:+.2%}")
    print(f"  perfect 3x (compounded) : {out['perfect_3x_cagr']:+.2%}  "
          f"(vol drag vs 3x arithmetic: {out['vol_drag']:+.2%})")
    print(f"  + expense & borrow      : {out['with_costs_cagr']:+.2%}  "
          f"(cost drag {out['cost_drag']:+.2%})")
    print(f"  + tracking error        : {out['full_etf_cagr']:+.2%}  "
          f"(TE drag {out['te_drag']:+.2%})")
    return out


def diagnose_tqqq_detailed(years: int = 5, seed: int = 0, *,
                           device="cuda") -> Dict:
    """Single-path per-component daily means for TQQQ (the reference's
    detailed decomposition): underlying, leverage, expense, borrow, TE."""
    path = _one_path(years, seed, device)
    qqq = _host(path.qqq_ret[:, 0])
    rf = _host(path.risk_free[:, 0])
    vix = _host(path.vix[:, 0])
    full = _host(path.etf_ret[cfg.ASSET_INDEX["TQQQ"], :, 0])
    ac = cfg.ASSETS["TQQQ"]

    borrow = 2.0 * np.maximum(rf + ac.borrow_spread, 0) / 252.0
    expense = ac.expense_ratio / 252.0
    te = full - (3.0 * qqq - expense - borrow)

    out = {
        "daily_underlying_bps": float(qqq.mean() * 1e4),
        "daily_leveraged_bps": float(3 * qqq.mean() * 1e4),
        "daily_expense_bps": float(expense * 1e4),
        "daily_borrow_bps": float(borrow.mean() * 1e4),
        "daily_te_bps": float(te.mean() * 1e4),
        "te_std_bps": float(te.std() * 1e4),
        "vix_mean": float(vix.mean()),
        "annualized_cost_drag": float((expense + borrow.mean()) * 252),
    }
    print("=" * 80)
    print(f"TQQQ DETAILED DECOMPOSITION ({years}y single path, daily bps)")
    print("=" * 80)
    for k, v in out.items():
        print(f"  {k:<24}: {v:+.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    diagnose_pipeline(device=args.device)
    diagnose_letf_drag(device=args.device)
    diagnose_tqqq_detailed(device=args.device)
