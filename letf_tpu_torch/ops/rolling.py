"""Rolling-window statistics with pandas semantics (plain PyTorch).

Port of ``letf_tpu/ops/rolling.py``: causal window sums as cumsum
differences (O(T)), the ``min_periods`` NaN warm-up rules, and
``rolling_mean/std/skew``, ``rsi``, ``shift1``, ``pct_change``, ``cummax``,
``max_drawdown``. Every function takes the time axis (default -1); the
port's signals run on ``[S, B]`` tensors with ``axis=0``.
"""

from __future__ import annotations

import math

import torch


def _ax(x, axis: int) -> int:
    return axis if axis >= 0 else x.ndim + axis


def _causal_window_sum(x, window: int, axis: int = -1):
    """Sum over the trailing window [t-w+1, t] along ``axis`` (cumsum
    difference)."""
    axis = _ax(x, axis)
    T = x.shape[axis]
    c = torch.cumsum(x, dim=axis)
    if window >= T:
        return c
    lagged = torch.cat([torch.zeros_like(c.narrow(axis, 0, window)),
                        c.narrow(axis, 0, T - window)], dim=axis)
    return c - lagged


def _counts(x, window: int, axis: int):
    """Per-step in-window counts, broadcast-shaped along ``axis``."""
    axis = _ax(x, axis)
    T = x.shape[axis]
    n = torch.clamp_max(torch.arange(T, device=x.device) + 1, window).to(
        x.dtype)
    shape = [1] * x.ndim
    shape[axis] = T
    return n.reshape(shape)


def _nan_unless(ok, v):
    return torch.where(ok, v, math.nan)


def rolling_sum(x, window: int, min_periods: int = 1, axis: int = -1):
    s = _causal_window_sum(x, window, axis)
    return _nan_unless(_counts(x, window, axis) >= min_periods, s)


def rolling_mean(x, window: int, min_periods: int | None = None,
                 axis: int = -1):
    if min_periods is None:
        min_periods = window
    s = _causal_window_sum(x, window, axis)
    n = _counts(x, window, axis)
    return _nan_unless(n >= min_periods, s / n)


def rolling_std(x, window: int, min_periods: int | None = None,
                axis: int = -1):
    """Sample std (ddof=1), NaN where count < max(min_periods, 2)."""
    if min_periods is None:
        min_periods = window
    s1 = _causal_window_sum(x, window, axis)
    s2 = _causal_window_sum(x * x, window, axis)
    n = _counts(x, window, axis)
    mean = s1 / n
    var = torch.clamp_min(s2 - n * mean * mean, 0.0) / torch.clamp_min(n - 1,
                                                                      1)
    return _nan_unless((n >= min_periods) & (n >= 2), torch.sqrt(var))


def rolling_skew(x, window: int, min_periods: int | None = None,
                 axis: int = -1):
    """Adjusted Fisher-Pearson skew (pandas formula), NaN for n < 3."""
    if min_periods is None:
        min_periods = window
    s1 = _causal_window_sum(x, window, axis)
    s2 = _causal_window_sum(x * x, window, axis)
    s3 = _causal_window_sum(x * x * x, window, axis)
    n = _counts(x, window, axis)
    mean = s1 / n
    m2 = torch.clamp_min(s2 - n * mean ** 2, 0.0)
    m3 = s3 - 3.0 * mean * s2 + 2.0 * n * mean ** 3
    var = m2 / torch.clamp_min(n - 1, 1)
    s = torch.sqrt(var)
    denom = torch.clamp_min(n - 1, 1) * torch.clamp_min(n - 2, 1) * s ** 3
    g = n * m3 / _nan_unless(denom > 0, denom)
    return _nan_unless((n >= min_periods) & (n >= 3) & (s > 0), g)


def shift1(x, axis: int = -1):
    """pandas .shift(1) along ``axis`` (NaN at t=0)."""
    axis = _ax(x, axis)
    T = x.shape[axis]
    return torch.cat([torch.full_like(x.narrow(axis, 0, 1), math.nan),
                      x.narrow(axis, 0, T - 1)], dim=axis)


def pct_change(x, periods: int, axis: int = -1):
    """pandas .pct_change(periods) along ``axis``."""
    axis = _ax(x, axis)
    T = x.shape[axis]
    prev = torch.cat([torch.full_like(x.narrow(axis, 0, periods), math.nan),
                      x.narrow(axis, 0, T - periods)], dim=axis)
    return x / prev - 1.0


def rsi(price, period: int = 14, axis: int = -1):
    """Simple-moving-average RSI on price diffs; the t=0 diff counts as 0
    (pandas' ``delta.where(delta > 0, 0)``), so the first value lands at
    t = period - 1."""
    axis = _ax(price, axis)
    T = price.shape[axis]
    delta = price - torch.cat([price.narrow(axis, 0, 1),
                               price.narrow(axis, 0, T - 1)], dim=axis)
    gain = rolling_mean(torch.where(delta > 0, delta, 0.0), period, axis=axis)
    loss = rolling_mean(torch.where(delta < 0, -delta, 0.0), period,
                        axis=axis)
    rs = gain / loss
    return 100.0 - 100.0 / (1.0 + rs)


def cummax(x, axis: int = -1):
    return torch.cummax(x, dim=_ax(x, axis)).values


def max_drawdown(equity, axis: int = -1):
    """Max peak-to-trough drawdown of an equity curve (positive fraction)."""
    running = cummax(equity, axis)
    dd = (equity - running) / torch.where(running > 0, running, 1.0)
    return torch.abs(torch.amin(dd, dim=_ax(equity, axis)))
