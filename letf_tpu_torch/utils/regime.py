"""Probabilistic stress-regime inference on the host (the port's copy of
``letf_tpu/utils/regime.py:14-80``): the logistic stress score, its EWMA
smoothing and the hysteresis state machine, in float64 numpy, with the
frame operations of ``utils/frame.py`` in place of pandas.

``infer_regime_from_vix_batched`` is the device form of the JAX package's
``infer_regime_from_vix_jax`` (``:81``) vmapped over windows, as the
historical backtest runs it: a torch day loop over ``[T, W]`` windows at
once, in the caller's dtype, with the reference's order of operations
(near a threshold one ulp flips a regime).
"""

from __future__ import annotations

import numpy as np
import torch

from letf_tpu_torch.utils.frame import bfill, ffill, fillna, rolling_std


def _prep_inputs_np(vix_series, realized_vol, term_spread):
    vix = np.asarray(vix_series, dtype=float)
    n = len(vix)

    if realized_vol is None:
        rv = fillna(bfill(rolling_std(vix, 20, 5)), 0.0) / 100.0
    else:
        rv = np.asarray(realized_vol, dtype=float)
        rv = fillna(bfill(ffill(rv)), np.nanmedian(rv))

    if term_spread is None:
        ts = np.zeros(n)
    else:
        ts = np.asarray(term_spread, dtype=float)
        ts = fillna(bfill(ffill(ts)), 0.0)
    return vix, rv, ts


def stress_logit(vix, rv, ts, xp=np):
    """Raw logistic stress score: higher VIX, higher realized vol, and a
    flatter/inverted curve imply higher stress probability."""
    logit = (-4.0
             + 0.22 * (xp.nan_to_num(vix, nan=20.0) - 20.0)
             + 6.5 * (xp.nan_to_num(rv, nan=0.18) - 0.18)
             + 0.10 * xp.clip(-ts, -5, 5))
    return 1.0 / (1.0 + xp.exp(-xp.clip(logit, -20, 20)))


def compute_high_vol_probability(vix_series, realized_vol=None, term_spread=None,
                                 smoothing: float = 0.94) -> np.ndarray:
    """P(high-vol regime) in [0.001, 0.999]: logistic score + EWMA smoothing."""
    vix, rv, ts = _prep_inputs_np(vix_series, realized_vol, term_spread)
    raw = stress_logit(vix, rv, ts)

    smoothed = np.zeros_like(raw)
    if len(raw) > 0:
        smoothed[0] = raw[0]
        for i in range(1, len(raw)):
            smoothed[i] = smoothing * smoothed[i - 1] + (1 - smoothing) * raw[i]
    return np.clip(smoothed, 0.001, 0.999)


def infer_regime_from_vix(vix_series, realized_vol=None, term_spread=None,
                          hysteresis: float = 0.08) -> np.ndarray:
    """Regime path from the smoothed stress probability with hysteresis
    thresholds (enter at 0.5 + h/2, exit at 0.5 - h/2)."""
    p_high = compute_high_vol_probability(vix_series, realized_vol, term_spread)
    enter_high = 0.50 + hysteresis / 2
    exit_high = 0.50 - hysteresis / 2

    regimes = np.zeros(len(p_high), dtype=int)
    if len(p_high) == 0:
        return regimes
    current = 1 if p_high[0] >= 0.50 else 0
    regimes[0] = current
    for i in range(1, len(p_high)):
        if current == 0 and p_high[i] >= enter_high:
            current = 1
        elif current == 1 and p_high[i] <= exit_high:
            current = 0
        regimes[i] = current
    return regimes


def infer_regime_from_vix_batched(vix, rv, ts, hysteresis: float = 0.08,
                                  smoothing: float = 0.94) -> torch.Tensor:
    """Regimes of W windows at once: ``vix``, ``rv``, ``ts`` [T, W] tensors
    (pre-cleaned, finite) -> [T, W] int32. The logistic score for all days,
    then the EWMA and the hysteresis state machine as one day loop; each
    window starts afresh from its own first day."""
    raw = stress_logit(vix, rv, ts, xp=torch)
    enter_high = 0.50 + hysteresis / 2
    exit_high = 0.50 - hysteresis / 2
    smoothed = raw[0]
    current = (raw[0] >= 0.50).to(torch.int32)
    out = torch.empty(raw.shape, dtype=torch.int32, device=raw.device)
    out[0] = current
    one, zero = torch.ones_like(current), torch.zeros_like(current)
    for t in range(1, raw.shape[0]):
        smoothed = smoothing * smoothed + (1 - smoothing) * raw[t]
        current = torch.where((current == 0) & (smoothed >= enter_high), one,
                              torch.where((current == 1)
                                          & (smoothed <= exit_high),
                                          zero, current))
        out[t] = current
    return out
