"""A pandas-free day frame: the port's stand-in for the DataFrame of the
data and calibration layers and of the host strategy oracle.

``Frame`` holds 1-D columns (float64, bool or str) keyed by the
reference's column names over a ``datetime64[D]`` index. The functions
below are the pandas operations those layers use, on float64 numpy
arrays:

- ``rolling_mean`` / ``rolling_sum`` / ``rolling_var`` / ``rolling_std``:
  ``Series.rolling(w, min_periods)`` ``.mean()`` / ``.sum()`` / ``.var()``
  / ``.std()``, by pandas 3.0's own online algorithms (Kahan-summed adds
  and removes; Welford's variance with Kahan compensation and its
  from-scratch recompute of an unstable window), step for step, so the
  results are pandas' bits, NaN and ``min_periods`` rules included.
  ``rolling_skew``: pandas 2's moments, a few ulps from pandas 3.0's.
- ``ewm_std``: ``Series.ewm(span, adjust=False).std()``, pandas' weighted
  mean/covariance recurrence with its bias correction, step for step.
- ``ffill``, ``bfill``, ``fillna``, ``interpolate_both``
  (``interpolate(limit_direction="both")``: linear in position, constant
  beyond the ends), ``diff``, ``cumprod`` (NaN kept and skipped),
  ``shift``, ``pct_change``.
- ``bdate_range``: ``pd.bdate_range`` with no holidays (``np.is_busday``).

The two online algorithms are sequential Python loops over the days: a
100-year history is ~26,000 days, a few tens of milliseconds a column.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np

NaN = float("nan")


def bdate_range(start: str, end: str) -> np.ndarray:
    days = np.arange(np.datetime64(start, "D"),
                     np.datetime64(end, "D") + 1)
    return days[np.is_busday(days)]


class Frame:
    """Columns of equal length over a ``datetime64[D]`` index."""

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 index=None):
        self.index = np.asarray(index, "datetime64[D]")
        self._cols: Dict[str, np.ndarray] = {}
        for k, v in (columns or {}).items():
            self[k] = v

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name, value) -> None:
        a = np.asarray(value)
        if a.ndim == 0:
            a = np.full(len(self), a[()])
        if a.shape != (len(self),):
            raise ValueError(f"{name}: shape {a.shape}, frame has "
                             f"{len(self)} rows")
        self._cols[name] = a

    def get(self, name, default=None):
        return self._cols.get(name, default)

    def copy(self) -> "Frame":
        return Frame({k: v.copy() for k, v in self._cols.items()},
                     self.index.copy())

    def take(self, rows) -> "Frame":
        """The rows ``rows`` (a boolean mask or integer positions)."""
        return Frame({k: v[rows] for k, v in self._cols.items()},
                     self.index[rows])

    def between(self, start: str, end: str) -> "Frame":
        """``df.loc[start:end]`` on a sorted date index (both ends in)."""
        lo = np.searchsorted(self.index, np.datetime64(start, "D"), "left")
        hi = np.searchsorted(self.index, np.datetime64(end, "D"), "right")
        return self.take(slice(lo, hi))

    def dropna(self, subset: Iterable[str]) -> "Frame":
        """Rows where every column of ``subset`` is not NaN."""
        keep = np.ones(len(self), bool)
        for c in subset:
            keep &= ~np.isnan(self._cols[c])
        return self.take(keep)


# ---------------------------------------------------------------------------
# Rolling windows: pandas' online algorithms (window/aggregations.pyx)
# ---------------------------------------------------------------------------

def rolling_mean(x, window: int, min_periods: Optional[int] = None):
    """``Series.rolling(window, min_periods).mean()``."""
    minp = window if min_periods is None else min_periods
    vals = np.asarray(x, np.float64).tolist()
    out = np.empty(len(vals))
    nobs = neg_ct = 0
    sum_x = comp_add = comp_rem = 0.0
    same = 0
    prev = vals[0] if vals else NaN
    for i, val in enumerate(vals):
        if window <= 1:                     # each window starts afresh
            nobs = neg_ct = same = 0
            sum_x = comp_add = comp_rem = 0.0
            prev = val
        elif i >= window:                   # remove the day leaving
            old = vals[i - window]
            if old == old:
                nobs -= 1
                y = -old - comp_rem
                t = sum_x + y
                comp_rem = t - sum_x - y
                sum_x = t
                if math.copysign(1.0, old) < 0:
                    neg_ct -= 1
        if val == val:                      # add the day entering
            nobs += 1
            y = val - comp_add
            t = sum_x + y
            comp_add = t - sum_x - y
            sum_x = t
            if math.copysign(1.0, val) < 0:
                neg_ct += 1
            same = same + 1 if val == prev else 1
            prev = val
        if nobs >= minp and nobs > 0:
            r = sum_x / nobs
            if same >= nobs:
                r = prev
            elif neg_ct == 0 and r < 0:
                r = 0.0
            elif neg_ct == nobs and r > 0:
                r = 0.0
            out[i] = r
        else:
            out[i] = NaN
    return out


def rolling_var(x, window: int, min_periods: Optional[int] = None,
                ddof: int = 1):
    """``Series.rolling(window, min_periods).var(ddof)``, pandas 3.0's
    sliding rule step for step.

    Adds and removes are Welford's updates with Kahan compensation (one
    compensation for adds, one for removes). After every update pandas
    3.0 compares the new sum of squared deviations with the old: when it
    fell below 1000 machine epsilons of the old one (a large value left
    the window, or rounding drove it negative), the day's window is
    recomputed from scratch by fresh adds with both compensations reset.
    A window that empties by removal is not a restart: the compensations
    carry over. The result is ``ssqdm / (nobs - ddof)``, with no shortcut
    for equal values or a single value.
    """
    minp = max(window if min_periods is None else min_periods, 1)
    vals = np.asarray(x, np.float64).tolist()
    out = np.empty(len(vals))
    nobs = 0.0
    mean_x = ssqdm = comp_add = comp_rem = 0.0
    for i, val in enumerate(vals):
        lo = max(i - window + 1, 0)
        if i == 0 or window <= 1:
            unstable = True                 # a window with no overlap
        else:
            unstable = False
            old = vals[i - window] if i >= window else NaN
            if old == old:                  # remove the day leaving
                prior = ssqdm
                nobs -= 1
                if nobs:
                    prev_mean = mean_x - comp_rem
                    y = old - comp_rem
                    t = y - mean_x
                    comp_rem = t + mean_x - y
                    mean_x = mean_x - t / nobs
                    ssqdm = ssqdm - (old - prev_mean) * (old - mean_x)
                    unstable = ssqdm < _RESTART * prior
                else:
                    mean_x = ssqdm = 0.0
            if val == val:                  # add the day entering
                prior = ssqdm
                nobs += 1
                prev_mean = mean_x - comp_add
                y = val - comp_add
                t = y - mean_x
                comp_add = t + mean_x - y
                mean_x = mean_x + t / nobs
                ssqdm = ssqdm + (val - prev_mean) * (val - mean_x)
                unstable |= ssqdm < _RESTART * prior
        if unstable:                        # the window afresh
            nobs = 0.0
            mean_x = ssqdm = comp_add = comp_rem = 0.0
            for v in vals[lo:i + 1]:
                if v == v:
                    nobs += 1
                    prev_mean = mean_x - comp_add
                    y = v - comp_add
                    t = y - mean_x
                    comp_add = t + mean_x - y
                    mean_x = mean_x + t / nobs
                    ssqdm = ssqdm + (v - prev_mean) * (v - mean_x)
        if nobs >= minp and nobs > ddof:
            out[i] = ssqdm / (nobs - ddof)
        else:
            out[i] = NaN
    return out


_RESTART = 1e3 * float(np.finfo(np.float64).eps)


def _prep(x):
    """pandas' window input: float64, +-inf read as NaN."""
    a = np.asarray(x, np.float64)
    return np.where(np.isinf(a), NaN, a)


def rolling_cov(x, y, window: int, min_periods: Optional[int] = None,
                ddof: int = 1):
    """``Series.rolling(window, min_periods).cov(other)``, pandas 3.0's
    rule: each series first takes the other's NaNs (``x + 0 * y``, which
    also makes NaN of a finite value facing an infinite one), then the
    rolling means of x * y, x and y by ``rolling_mean``'s online rule, and
    the count of rows where both are present by ``rolling_sum``:
    ``(mean_xy - mean_x * mean_y) * count / (count - ddof)``."""
    a = np.asarray(x, np.float64)
    b = np.asarray(y, np.float64)
    with np.errstate(all="ignore"):
        xa, ya = _prep(a + 0 * b), _prep(b + 0 * a)
        minp = window if min_periods is None else min_periods
        mean_xy = rolling_mean(xa * ya, window, minp)
        mean_x = rolling_mean(xa, window, minp)
        mean_y = rolling_mean(ya, window, minp)
        count = rolling_sum((~np.isnan(xa + ya)).astype(np.float64), window,
                            0)
        return (mean_xy - mean_x * mean_y) * (count / (count - ddof))


def rolling_sum(x, window: int, min_periods: Optional[int] = None):
    """``Series.rolling(window, min_periods).sum()``: Kahan-summed adds and
    removes, a run of equal values read as ``value * nobs``."""
    minp = window if min_periods is None else min_periods
    vals = np.asarray(x, np.float64).tolist()
    out = np.empty(len(vals))
    nobs = same = 0
    sum_x = comp_add = comp_rem = 0.0
    prev = vals[0] if vals else NaN
    for i, val in enumerate(vals):
        if window <= 1:
            nobs = same = 0
            sum_x = comp_add = comp_rem = 0.0
            prev = val
        elif i >= window:
            old = vals[i - window]
            if old == old:
                nobs -= 1
                y = -old - comp_rem
                t = sum_x + y
                comp_rem = t - sum_x - y
                sum_x = t
        if val == val:
            nobs += 1
            y = val - comp_add
            t = sum_x + y
            comp_add = t - sum_x - y
            sum_x = t
            same = same + 1 if val == prev else 1
            prev = val
        if nobs == 0 == minp:
            out[i] = 0.0
        elif nobs >= minp:
            out[i] = prev * nobs if same >= nobs else sum_x
        else:
            out[i] = NaN
    return out


def rolling_skew(x, window: int, min_periods: Optional[int] = None):
    """``Series.rolling(window, min_periods).skew()`` by pandas 2's online
    moments: the series shifted by its rounded mean (when its minimum lies
    within 1e5 below it), Kahan-summed first, second and third powers, 0
    on a run of equal values and NaN below 3 values or a variance of at
    most 1e-14. pandas 3.0's sliding skew is another rule, not matched:
    the two agree to a few ulps (``tests/test_torch_data.py``), and the
    host oracle reads the skew only through comparisons with 0, 0.5 and
    -0.5."""
    minp = max(window if min_periods is None else min_periods, 3)
    raw = np.asarray(x, np.float64)
    out = np.empty(len(raw))
    ok = raw[raw == raw]
    vals = raw.tolist()
    shifted = vals
    if len(ok):
        mean_val = 0.0
        for v in ok.tolist():
            mean_val += v
        mean_val /= len(ok)
        if float(ok.min()) - mean_val > -1e5:
            shifted = (raw - round(mean_val)).tolist()
    nobs = same = 0
    sx = sxx = sxxx = 0.0
    ca = [0.0, 0.0, 0.0]
    cr = [0.0, 0.0, 0.0]
    prev = NaN

    def kahan(total, term, comp, k):
        y = term - comp[k]
        t = total + y
        comp[k] = t - total - y
        return t

    for i in range(len(vals)):
        if i == 0 or window <= 1:
            nobs = same = 0
            sx = sxx = sxxx = 0.0
            ca[:] = [0.0, 0.0, 0.0]
            cr[:] = [0.0, 0.0, 0.0]
            prev = vals[i]
        elif i >= window:
            old = shifted[i - window]
            if old == old:
                nobs -= 1
                sx = kahan(sx, -old, cr, 0)
                sxx = kahan(sxx, -(old * old), cr, 1)
                sxxx = kahan(sxxx, -(old * old * old), cr, 2)
        val = shifted[i]
        if val == val:
            nobs += 1
            sx = kahan(sx, val, ca, 0)
            sxx = kahan(sxx, val * val, ca, 1)
            sxxx = kahan(sxxx, val * val * val, ca, 2)
            same = same + 1 if val == prev else 1
            prev = val
        out[i] = NaN
        if nobs >= minp:
            dn = float(nobs)
            a = sx / dn
            b = sxx / dn - a * a
            c = sxxx / dn - a * a * a - 3 * a * b
            if nobs < 3:
                pass
            elif same >= nobs:
                out[i] = 0.0
            elif b > 1e-14:
                r = math.sqrt(b)
                out[i] = (math.sqrt(dn * (dn - 1.0)) * c) / ((dn - 2) * r * r * r)
    return out


def _zsqrt(v):
    out = np.sqrt(np.maximum(v, 0.0))
    out[np.isnan(v)] = NaN
    return out


def rolling_std(x, window: int, min_periods: Optional[int] = None,
                ddof: int = 1):
    """``Series.rolling(window, min_periods).std(ddof)``."""
    return _zsqrt(rolling_var(x, window, min_periods, ddof))


def ewm_std(x, span: float):
    """``Series.ewm(span=span, adjust=False).std()`` (bias-corrected,
    ``min_periods`` 0, NaNs not ignored)."""
    com = (span - 1.0) / 2.0
    alpha = 1.0 / (1.0 + com)
    old_wt_factor = 1.0 - alpha
    new_wt = alpha
    vals = np.asarray(x, np.float64).tolist()
    n = len(vals)
    out = np.empty(n)
    if n == 0:
        return out
    mean_x = vals[0]
    nobs = int(mean_x == mean_x)
    if not nobs:
        mean_x = NaN
    out[0] = NaN
    cov = 0.0
    sum_wt = sum_wt2 = old_wt = 1.0
    for i in range(1, n):
        cur = vals[i]
        is_obs = cur == cur
        nobs += is_obs
        if mean_x == mean_x:
            sum_wt *= old_wt_factor
            sum_wt2 *= old_wt_factor * old_wt_factor
            old_wt *= old_wt_factor
            if is_obs:
                old_mean = mean_x
                if mean_x != cur:
                    mean_x = ((old_wt * old_mean) + (new_wt * cur)) \
                        / (old_wt + new_wt)
                cov = ((old_wt * (cov + ((old_mean - mean_x)
                                         * (old_mean - mean_x))))
                       + (new_wt * ((cur - mean_x) * (cur - mean_x)))) \
                    / (old_wt + new_wt)
                sum_wt += new_wt
                sum_wt2 += new_wt * new_wt
                old_wt += new_wt
                sum_wt /= old_wt
                sum_wt2 /= old_wt * old_wt
                old_wt = 1.0
        elif is_obs:
            mean_x = cur
        if nobs >= 1:
            num = sum_wt * sum_wt
            den = num - sum_wt2
            out[i] = (num / den) * cov if den > 0 else NaN
        else:
            out[i] = NaN
    return _zsqrt(out)


# ---------------------------------------------------------------------------
# Fills and elementwise helpers
# ---------------------------------------------------------------------------

def ffill(x):
    """``Series.ffill()``: each NaN takes the last value before it."""
    x = np.asarray(x, np.float64)
    if len(x) == 0:
        return x.copy()
    ok = ~np.isnan(x)
    idx = np.maximum.accumulate(np.where(ok, np.arange(len(x)), 0))
    out = x[idx]
    out[~np.maximum.accumulate(ok)] = NaN
    return out


def bfill(x):
    """``Series.bfill()``: each NaN takes the next value after it."""
    return ffill(np.asarray(x, np.float64)[::-1])[::-1].copy()


def fillna(x, value):
    """``Series.fillna(value)``: a scalar, or an array of the same length
    (the aligned Series of the reference)."""
    x = np.asarray(x, np.float64)
    return np.where(np.isnan(x), value, x)


def interpolate_both(x):
    """``Series.interpolate(limit_direction="both")``: linear in position
    between valid values, the end values carried beyond the ends."""
    x = np.asarray(x, np.float64)
    ok = ~np.isnan(x)
    if ok.all() or not ok.any():
        return x.copy()
    pos = np.arange(len(x))
    return np.interp(pos, pos[ok], x[ok])


def diff(x):
    """``Series.diff()``."""
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    out[:1] = NaN
    out[1:] = x[1:] - x[:-1]
    return out


def cumprod(x):
    """``Series.cumprod()``: NaNs stay NaN and are skipped."""
    x = np.asarray(x, np.float64)
    nan = np.isnan(x)
    out = np.cumprod(np.where(nan, 1.0, x))
    out[nan] = NaN
    return out


def shift(x, periods: int = 1):
    """``Series.shift(periods)`` of a float series: NaN fills the gap."""
    x = np.asarray(x, np.float64)
    out = np.full_like(x, NaN)
    k = min(abs(periods), len(x))
    if periods >= 0:
        out[k:] = x[:len(x) - k]
    else:
        out[:len(x) - k] = x[k:]
    return out


def pct_change(x, periods: int = 1):
    """``Series.pct_change(periods)`` (pandas 3.0: no fill)."""
    x = np.asarray(x, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return x / shift(x, periods) - 1.0
