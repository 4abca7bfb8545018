"""Income trajectories (career dynamics) and the wired tax engine's path.

The port's copy of ``letf_tpu/income.py`` (reference letf/income.py:14-168):
- ``simulate_income_trajectory``: the NumPy career model (career-stage
  growth with promotions, job changes, layoffs and recovery, a 50%-of-base
  floor and a 5x ceiling) with percentile summaries; ``get_year_income``;
- ``simulate_income_paths``: the batched device form of that model,
  counterpart of the JAX package's ``simulate_income_paths_jax``: one loop
  over the years carrying the [N] (income, recovering) state, on the
  port's threefry (``ops/rng.py``) with the JAX function's key layout, so
  its uniforms are ``jax.random``'s bit for bit and its normals within the
  samplers' bounds;
- ``simulate_wired_income_path``: the NumPy generator seeded with 42
  (promotions, job changes, setbacks with recovery, retirement drop) that
  the post-tax tables tax against.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from letf_tpu_torch.ops import rng


CAREER_PARAMS = {
    "early": {
        "base_growth_aggressive": 0.06, "base_growth": 0.05,
        "growth_volatility": 0.08,
        "promotion_rate": 0.25, "promotion_boost": (0.15, 0.25),
        "job_change_rate": 0.15, "job_change_boost": (0.10, 0.30),
        "layoff_rate": 0.03, "layoff_penalty": 0.20, "recovery_years": 1.5,
    },
    "mid": {
        "base_growth_aggressive": 0.04, "base_growth": 0.03,
        "growth_volatility": 0.05,
        "promotion_rate": 0.15, "promotion_boost": (0.12, 0.20),
        "job_change_rate": 0.08, "job_change_boost": (0.08, 0.20),
        "layoff_rate": 0.02, "layoff_penalty": 0.15, "recovery_years": 2.0,
    },
    "late": {
        "base_growth_aggressive": 0.025, "base_growth": 0.02,
        "growth_volatility": 0.03,
        "promotion_rate": 0.08, "promotion_boost": (0.08, 0.15),
        "job_change_rate": 0.04, "job_change_boost": (0.05, 0.15),
        "layoff_rate": 0.015, "layoff_penalty": 0.12, "recovery_years": 2.5,
    },
}


def simulate_income_trajectory(base_income: float, years: int,
                               num_simulations: int = 50,
                               career_stage: str = "mid",
                               aggressive: bool = True,
                               seed: int | None = None) -> Dict:
    """Monte Carlo income paths with percentile summaries."""
    rng = np.random.default_rng(seed)
    p = CAREER_PARAMS[career_stage]
    base_growth = p["base_growth_aggressive"] if aggressive else p["base_growth"]

    all_paths = np.empty((num_simulations, years + 1))
    for sim in range(num_simulations):
        income = base_income
        path = [income]
        recovering = 0
        for _ in range(years):
            growth = base_growth + rng.normal(0, p["growth_volatility"])
            roll = rng.random()
            if recovering > 0:
                growth += 0.10
                recovering -= 1
            elif roll < p["layoff_rate"]:
                growth -= p["layoff_penalty"]
                recovering = int(p["recovery_years"])
            elif roll < p["layoff_rate"] + p["promotion_rate"]:
                growth += rng.uniform(*p["promotion_boost"])
            elif roll < (p["layoff_rate"] + p["promotion_rate"]
                         + p["job_change_rate"]):
                growth += rng.uniform(*p["job_change_boost"])
            income *= (1 + growth)
            income = min(max(income, base_income * 0.5), base_income * 5)
            path.append(income)
        all_paths[sim] = path

    return {
        "p10": np.percentile(all_paths, 10, axis=0),
        "p25": np.percentile(all_paths, 25, axis=0),
        "p50": np.percentile(all_paths, 50, axis=0),
        "p75": np.percentile(all_paths, 75, axis=0),
        "p90": np.percentile(all_paths, 90, axis=0),
        "mean": np.mean(all_paths, axis=0),
        "all_paths": all_paths,
    }


def simulate_income_paths(key, base_income: float, years: int,
                          n_paths: int, career_stage: str = "mid",
                          aggressive: bool = True, *,
                          dtype: torch.dtype = torch.float32):
    """Batched income paths on the device of ``key`` (an ``ops/rng.key``):
    the JAX package's ``simulate_income_paths_jax`` (letf_tpu/income.py:86).
    Year k draws from the k-th key of ``split(key, years)``, itself split
    in three: the growth normal, the event roll and the boost uniform, as
    ``jax.random`` draws them; the event cascade and the career constants
    are ``simulate_income_trajectory``'s. ``dtype``: float32 draws as the
    JAX function does by default, float64 as it does in x64 mode. Returns
    [n_paths, years + 1]."""
    p = CAREER_PARAMS[career_stage]
    base_growth = (p["base_growth_aggressive"] if aggressive
                   else p["base_growth"])
    lay, promo, jobc = p["layoff_rate"], p["promotion_rate"], p["job_change_rate"]
    pb_lo, pb_hi = p["promotion_boost"]
    jb_lo, jb_hi = p["job_change_boost"]
    dev = key.device

    def const(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    zero = const(0.0)
    income = torch.full((n_paths,), float(base_income), dtype=dtype,
                        device=dev)
    recovering = torch.zeros((n_paths,), dtype=torch.int32, device=dev)
    path = [income]
    for k in rng.split(key, years):
        kz, kr, kb = rng.split(k, 3)
        growth = base_growth + p["growth_volatility"] * rng.normal(
            kz, n_paths, dtype)
        roll = rng.uniform(kr, n_paths, dtype)
        u = rng.uniform(kb, n_paths, dtype)
        in_rec = recovering > 0
        is_layoff = (~in_rec) & (roll < lay)
        is_promo = (~in_rec) & (~is_layoff) & (roll < lay + promo)
        is_jobc = (~in_rec) & (~is_layoff) & (~is_promo) \
            & (roll < lay + promo + jobc)
        growth = (growth
                  + torch.where(in_rec, const(0.10), zero)
                  - torch.where(is_layoff, const(p["layoff_penalty"]), zero)
                  + torch.where(is_promo, pb_lo + u * (pb_hi - pb_lo), zero)
                  + torch.where(is_jobc, jb_lo + u * (jb_hi - jb_lo), zero))
        income = torch.clamp(income * (1.0 + growth), base_income * 0.5,
                             base_income * 5.0)
        recovering = torch.where(
            is_layoff, torch.full_like(recovering, int(p["recovery_years"])),
            torch.clamp_min(recovering - 1, 0))
        path.append(income)
    return torch.stack(path, dim=1)


def get_year_income(income_trajectory, year: int) -> float:
    """Income for a specific year; extrapolates at 2% beyond the path."""
    if year >= len(income_trajectory):
        years_beyond = year - len(income_trajectory) + 1
        return float(income_trajectory[-1]) * (1.02 ** years_beyond)
    return float(income_trajectory[year])


def simulate_wired_income_path(base_income: float, years: int,
                               years_until_retirement: int | None = None,
                               retirement_income: float | None = None,
                               seed: int = 42) -> np.ndarray:
    """The income path used inside the wired tax engine — exact parity with
    the inline generator at letf/integration.py:258-328 (seed 42: promotions
    25%, job changes 10%, setbacks 3% with 2y recovery, ±clip [-0.5, 1.0],
    retirement drop to 50% of peak with 2% COLA)."""
    rng = np.random.default_rng(seed)
    path = [float(base_income)]
    in_recovery = 0
    peak = float(base_income)
    retirement_pct = 0.50

    for year in range(1, years + 1):
        current = path[-1]
        if years_until_retirement is not None and year > years_until_retirement:
            if retirement_income is None:
                if year == years_until_retirement + 1:
                    new_income = peak * retirement_pct
                else:
                    new_income = current * 1.02
            else:
                if year == years_until_retirement + 1:
                    new_income = float(retirement_income)
                else:
                    new_income = current * 1.02
        else:
            growth = 0.04 + rng.normal(0, 0.08)
            event = 0.0
            if rng.random() < 0.03 and in_recovery == 0:
                event = rng.uniform(-0.20, -0.10)
                in_recovery = 2
            elif rng.random() < 0.10:
                event = rng.uniform(0.10, 0.30)
            elif rng.random() < 0.25:
                event = rng.uniform(0.15, 0.25)
            recovery = 0.0
            if in_recovery > 0:
                recovery = 0.08
                in_recovery -= 1
            total = float(np.clip(growth + event + recovery, -0.50, 1.00))
            new_income = current * (1 + total)
            peak = max(peak, new_income)
        path.append(new_income)

    return np.asarray(path)
