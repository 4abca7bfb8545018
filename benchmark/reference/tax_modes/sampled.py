"""``tax_mode="sampled"`` (the default report): the post-tax tables of the
13 taxable strategies, drawn from ``max_tax_sims`` trials a strategy at
evenly spaced sorted-wealth positions, each taxed exactly, the tax spread
over every trial by linear interpolation on the sampled wealths.

The report carries its sample (``post_tax_sample``: each strategy's rows,
their pre-tax wealth and exact tax, in sorted-wealth order). The numbers:

- ``sample_mismatch`` (exact): strategies whose sample is missing or is
  not ``min(max_tax_sims, trials)`` rows of ascending wealth, or whose
  table's ``n_sampled`` differs; with any, no other number is read;
- ``pick_mismatches`` (exact): pre-tax fans (held to float64 by the
  reduction numbers) outside the two sampled wealths whose sorted
  positions, ``linspace(0, N - 1, m)``, bracket the fan's rank;
- ``check_taxes_per_strategy`` sampled positions a strategy (the first,
  the last and the rest drawn from the seed) recomputed by the plain
  reference (``reference/post_tax``): ``sample_wealth_max_gap`` (pre-tax
  wealth, relative, against the nearer of the plain engine's K3 loop and
  the emitting replay), ``tax_median_gap`` (median of abs tax gap over
  max(gross traded, abs tax, 1)) and ``tax_gap_share`` (share of those
  above ``GAP_SHARE``); ``tax_strategy_gap``: the largest over strategies
  of the median over its pairs of abs tax gap over max(abs tax, 1), which
  sees a strategy's taxes off by a share of themselves (1% of a tax is
  ~1e-4 of a sampled row's gross traded, below what the two gross-relative
  numbers can tell from the sound spread);
- ``post_fan_max_gap``: how far each post-tax fan lies outside the
  values the sample allows at its rank, relative to max(pre-tax fan, 1):
  with T the program's interpolation of the sample's tax over its wealth
  (in float64), a sampled trial's post-tax wealth max(w - T(w), 0) is
  known and each of the trials between two neighbouring samples lies in
  the range of that stretch, so each order statistic, and the fan
  interpolated between two, lies between bounds (a point where every
  trial is sampled; where w - T(w) rises with w the fan is max(f - T(f),
  0), f the pre-tax fan); ``median_tax_gap``: the same for the median
  tax, relative to max(pre-tax median, 1).

The post-tax win rate needs every trial's SPY wealth and is held only by
the CPU tests. The reference runs in the glue dtype of the comparison:
float32 where a card is visible, float64 otherwise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import config as cfg
from benchmark.reference import post_tax

GAP_SHARE = 1e-3           # a tax gap above this share of gross counts
FAN_RTOL = 1e-6            # float32 rounding of a fan between two picks


def interp(w, xp, fp):
    """Linear interpolation of fp over ascending xp, clamped at the ends,
    ties taking the last tied node (the program's rule), in float64."""
    xp = np.asarray(xp, np.float64)
    fp = np.asarray(fp, np.float64)
    m = xp.shape[0]
    idx = np.searchsorted(xp, w, side="right")
    i0 = np.clip(idx - 1, 0, m - 1)
    i1 = np.clip(idx, 0, m - 1)
    x0, x1, f0, f1 = xp[i0], xp[i1], fp[i0], fp[i1]
    t = np.clip((w - x0) / np.where(x1 > x0, x1 - x0, 1.0), 0.0, 1.0)
    return f0 + t * (f1 - f0)


def segment_ranges(w, tax, post_tax: bool = False):
    """The program's interpolated tax T (or the post-tax wealth max(w -
    T(w), 0) with ``post_tax``) at each sampled wealth, and its range
    [lo, hi] over each stretch between two neighbouring samples: on the
    open stretch T is linear from the left sample's tax to the right
    one's; at a sampled wealth ties take the last tied sample."""
    node_t = interp(w, w, tax)
    if post_tax:
        node = np.maximum(w - node_t, 0.0)
        ends = [np.maximum(w[:-1] - tax[:-1], 0.0),
                np.maximum(w[1:] - tax[1:], 0.0), node[:-1], node[1:]]
    else:
        node = node_t
        ends = [tax[:-1], tax[1:], node[:-1], node[1:]]
    return node, np.minimum.reduce(ends), np.maximum.reduce(ends)


def quantile_bounds(node, lo, hi, pos, q: float):
    """Bounds of the linear-interpolation q-quantile over all N trials of
    a value known exactly at the sampled sorted positions ``pos`` and
    within [lo[j], hi[j]] for the pos[j+1] - pos[j] - 1 trials between
    samples j and j + 1 (an order statistic lies between those of the
    ranges' lower ends and of their upper ends)."""
    n = int(pos[-1]) + 1
    between = np.diff(pos) - 1
    counts = np.concatenate([np.ones(len(node)), between])

    def kth(vals, k):
        o = np.argsort(vals, kind="stable")
        at = np.searchsorted(np.cumsum(counts[o]), k, side="right")
        return vals[o][min(at, len(vals) - 1)]

    r = q * (n - 1)
    k = int(np.floor(r))
    t = r - k
    k1 = min(k + 1, n - 1)
    lows = np.concatenate([node, lo])
    highs = np.concatenate([node, hi])
    return ((1 - t) * kth(lows, k) + t * kth(lows, k1),
            (1 - t) * kth(highs, k) + t * kth(highs, k1))


def max_tax_sims(cell) -> int:
    """The traffic's ``max_tax_sims``; a configuration that states its
    estimator (``post_tax``) has to state the same number."""
    m = int(cell.traffic["max_tax_sims"])
    stated = cell.config.get("post_tax", {}).get("max_tax_sims", m)
    if int(stated) != m:
        raise ValueError(f"the traffic samples {m} trials a strategy; the "
                         f"configuration states {stated}")
    return m


def _well_formed(entry, m: int, n: int) -> bool:
    if not isinstance(entry, dict) or not {"rows", "wealth",
                                           "tax"} <= set(entry):
        return False
    rows, w, tax = (np.asarray(entry[k]) for k in ("rows", "wealth", "tax"))
    return (rows.shape == w.shape == tax.shape == (m,)
            and np.issubdtype(rows.dtype, np.integer)
            and bool(((rows >= 0) & (rows < n)).all())
            and bool(np.isfinite(w).all()) and bool(np.isfinite(tax).all())
            and bool((np.diff(w.astype(np.float64)) >= 0).all()))


def check_positions(seed: int, m: int, k: int) -> np.ndarray:
    """[13, k] sampled positions a strategy: 0, m - 1 and k - 2 drawn
    from the seed among the rest."""
    g = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7A5]))
    inner = np.arange(1, m - 1)
    out = []
    for _ in cfg.TAXABLE_IDS:
        take = g.choice(inner, size=min(k - 2, len(inner)), replace=False)
        out.append(np.unique(np.concatenate([[0, m - 1], take])))
    return np.array(out)


def sample_numbers(cell, report: dict) -> dict:
    """``sample_mismatch``, and with none the numbers of the tables
    against their own sample (``pick_mismatches``, ``post_fan_max_gap``,
    ``median_tax_gap``)."""
    n = int(report.get("n_trials", cell.traffic["trials"]))
    m = min(max_tax_sims(cell), n)
    sids = list(cfg.TAXABLE_IDS)
    sample = report.get("post_tax_sample")
    if not isinstance(sample, dict):
        return {"sample_mismatch": float(len(sids))}
    bad = sum(not _well_formed(sample.get(s), m, n)
              or report["strategies"][s].get("post_tax", {}).get(
                  "n_sampled") != m for s in sids)
    if bad:
        return {"sample_mismatch": float(bad)}
    pos = np.linspace(0, n - 1, m, dtype=int)
    picks = 0
    fan_gap = med_gap = 0.0
    for s in sids:
        w = np.asarray(sample[s]["wealth"], np.float64)
        tax = np.asarray(sample[s]["tax"], np.float64)
        st = report["strategies"][s]
        t_node, t_lo, t_hi = segment_ranges(w, tax)
        g_node, g_lo, g_hi = segment_ranges(w, tax, post_tax=True)
        for p in report["percentiles"]:
            # The pre-tax fan between its bracketing picks.
            f = float(st["wealth"][f"p{p}"])
            r = p / 100.0 * (n - 1)
            lo = w[np.searchsorted(pos, np.floor(r), side="right") - 1]
            hi = w[min(np.searchsorted(pos, np.ceil(r), side="left"), m - 1)]
            tol = FAN_RTOL * max(abs(f), 1.0)
            picks += not (lo - tol <= f <= hi + tol)
            # The post-tax fan within what the sample allows.
            lo, hi = quantile_bounds(g_node, g_lo, g_hi, pos, p / 100.0)
            got = float(st["post_tax"]["wealth"][f"p{p}"])
            fan_gap = max(fan_gap, max(lo - got, got - hi, 0.0)
                          / max(f, 1.0))
        lo, hi = quantile_bounds(t_node, t_lo, t_hi, pos, 0.5)
        got = float(st["post_tax"]["median_tax"])
        med_gap = max(med_gap, max(lo - got, got - hi, 0.0)
                      / max(float(st["wealth"]["p50"]), 1.0))
    return {"sample_mismatch": 0.0, "pick_mismatches": float(picks),
            "post_fan_max_gap": float(np.nan_to_num(fan_gap, nan=np.inf)),
            "median_tax_gap": float(np.nan_to_num(med_gap, nan=np.inf))}


def checked_pairs(cell, report: dict, seed: int):
    """The (row, sid) pairs the reference recomputes, with the report's
    sampled wealth and tax of each."""
    sample = report["post_tax_sample"]
    m = min(max_tax_sims(cell), int(report["n_trials"]))
    at = check_positions(seed, m,
                         int(cell.traffic["check_taxes_per_strategy"]))
    pairs, w, tax = [], [], []
    for i, s in enumerate(cfg.TAXABLE_IDS):
        for j in at[i]:
            pairs.append((int(sample[s]["rows"][j]), s))
            w.append(float(sample[s]["wealth"][j]))
            tax.append(float(sample[s]["tax"][j]))
    return pairs, np.asarray(w), np.asarray(tax)


def pair_numbers(pairs, wealth, tax, ref: dict) -> dict:
    """The sampled pairs' wealth and tax against the reference's."""
    # Against the nearer of the reference's two routes: at the tails a
    # trial near a threshold can part on one of them alone (a ruin on
    # K3's NumPy loop that the emitting replay and the program do not
    # share).
    wgap = np.minimum.reduce([
        np.abs(wealth - ref[k]) / np.maximum(np.abs(ref[k]), 1.0)
        for k in ("wealth", "replay_wealth")])
    dtax = np.abs(tax - ref["tax"])
    tgap = dtax / np.maximum.reduce([ref["gross"], np.abs(ref["tax"]),
                                     np.ones(len(pairs))])
    own = dtax / np.maximum(np.abs(ref["tax"]), 1.0)
    by_sid = np.array([s for _, s in pairs])
    strategy_gap = max(float(np.median(own[by_sid == s]))
                       for s in set(by_sid))
    return {
        "sample_wealth_max_gap": float(np.nan_to_num(wgap.max(),
                                                     nan=np.inf)),
        "tax_median_gap": float(np.nan_to_num(np.median(tgap), nan=np.inf)),
        "tax_gap_share": float((~(tgap <= GAP_SHARE)).mean()),
        "tax_strategy_gap": float(np.nan_to_num(strategy_gap, nan=np.inf)),
    }


def numbers(cell, report: dict, seed: int) -> dict:
    t0 = time.perf_counter()
    out = sample_numbers(cell, report)
    if out["sample_mismatch"]:
        return out
    pairs, wealth, tax = checked_pairs(cell, report, seed)
    glue = torch.float32 if torch.cuda.is_available() else torch.float64
    ref = post_tax.pair_taxes(pairs, seed, int(cell.traffic["years"]),
                              cell.config, glue)
    out.update(pair_numbers(pairs, wealth, tax, ref))
    print(f"sampled tax mode: {len(pairs)} pairs on "
          f"{len(set(r for r, _ in pairs))} rows, "
          f"{time.perf_counter() - t0} s", flush=True)
    return out
