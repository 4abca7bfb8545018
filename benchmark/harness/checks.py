"""The comparison that decides ``correct``.

Three parts, all on the window's last report:

- rows: a sample of its rows, drawn from the seed with the same number in
  every chunk of the report (so a fault in one chunk reaches the sample),
  recomputed from the seed by the plain reference
  (``benchmark/reference/engines``), against the summaries the report
  reduced: final wealth, trade counts and maximum drawdown of the 19
  strategies, and the validity flags;
- reduction: the report's fans and summary fields recomputed in float64
  from those same summaries (all the report's rows);
- the traffic's tax mode (``benchmark/reference/tax_modes``): what the
  report carries beyond the pre-tax fans.

Every number has a limit in ``benchmark/limits/<cell>.json``; a number
without one fails. The numbers are gaps: 0 is a perfect match.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BENCHMARKS = (0, 1, 2)        # S1-S3 (buy and hold): no decisions
GAP_SHARE = 1e-3              # a wealth gap above this counts as a miss
FLAGS = ("valid", "repaired", "path_finite", "vix_ok")


def sample_rows(seed: int, trials: int, n: int, chunk: int) -> np.ndarray:
    """The report rows the reference recomputes, drawn from the seed: n
    rows spread evenly over the report's chunks of ``chunk`` trials (the
    first n mod chunks of them, in a seeded order, take one more), each
    chunk's drawn uniformly within it."""
    g = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7E57]))
    chunks = -(-trials // chunk)
    take = np.full(chunks, n // chunks)
    take[g.permutation(chunks)[:n % chunks]] += 1
    rows = []
    for c, k in enumerate(take):
        lo = c * chunk
        size = min(chunk, trials - lo)
        rows.append(lo + g.choice(size, size=min(int(k), size),
                                  replace=False))
    return np.sort(np.concatenate(rows))


def _gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """abs(a - b), 0 where both are equal or both NaN, inf where one
    side alone is NaN."""
    both = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        d = np.abs(a - b)
    return np.where(both, 0.0, np.where(np.isnan(d), np.inf, d))


def row_numbers(prog: Dict[str, np.ndarray],
                ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Gaps of the program's per-row summaries against the reference's on
    the same rows."""
    fw = prog["final_wealth"].astype(np.float64)
    rfw = ref["final_wealth"].astype(np.float64)
    rel = _gap(fw, rfw) / np.maximum(np.abs(np.nan_to_num(rfw)), 1.0)
    mdd = _gap(prog["max_dd"].astype(np.float64),
               ref["max_dd"].astype(np.float64))
    b = list(BENCHMARKS)
    flags = np.zeros(len(fw), bool)
    for k in FLAGS:
        flags |= np.asarray(prog[k]) != np.asarray(ref[k])
    return {
        "wealth_median_gap": float(np.median(rel)),
        "benchmark_wealth_max_gap": float(rel[:, b].max()),
        "wealth_gap_share": float((rel > GAP_SHARE).mean()),
        "trades_gap_share": float((prog["num_trades"]
                                   != ref["num_trades"]).mean()),
        "drawdown_median_gap": float(np.median(mdd)),
        "benchmark_ruin_mismatches": float(((fw[:, b] <= 0)
                                            != (rfw[:, b] <= 0)).sum()),
        "flag_mismatches": float(flags.sum()),
    }


def reduced(arrays: Dict[str, np.ndarray], percentiles: Sequence[float],
            years: float) -> Dict[str, np.ndarray]:
    """The report's reductions in float64 (linear-interpolation
    quantiles per strategy, as the report defines them)."""
    fw = arrays["final_wealth"].astype(np.float64)
    q = np.asarray(percentiles, np.float64) / 100.0
    spy = fw[:, 1]
    return dict(
        wealth_fan=np.quantile(fw, q, axis=0, method="linear"),
        mdd_median=np.quantile(arrays["max_dd"].astype(np.float64), 0.5,
                               axis=0, method="linear"),
        trades_per_year=arrays["num_trades"].astype(np.float64).mean(0)
        / years,
        win_rate_vs_spy=(fw > spy[:, None]).mean(0),
        ruin_frac=(fw <= 0.0).mean(0),
        valid_frac=arrays["valid"].mean(), repaired_frac=arrays[
            "repaired"].mean(), finite_frac=arrays["path_finite"].mean(),
        vix_ok_frac=arrays["vix_ok"].mean())


def report_fields(report: dict, sids: Sequence[str]) -> Dict[str, np.ndarray]:
    """The same fields read from the report."""
    pct = report["percentiles"]
    st = report["strategies"]
    return dict(
        wealth_fan=np.array([[st[s]["wealth"][f"p{p}"] for s in sids]
                             for p in pct], np.float64),
        mdd_median=np.array([st[s]["median_max_dd"] for s in sids]),
        trades_per_year=np.array([st[s]["trades_per_year"] for s in sids]),
        win_rate_vs_spy=np.array([st[s]["win_rate_vs_spy"] for s in sids]),
        ruin_frac=np.array([st[s]["ruin_frac"] for s in sids]),
        valid_frac=report["valid_frac"], repaired_frac=report[
            "repaired_frac"], finite_frac=report["finite_frac"],
        vix_ok_frac=report["vix_ok_frac"])


def reduction_numbers(report: dict, arrays: Dict[str, np.ndarray],
                      trials: int, years: float) -> Dict[str, float]:
    """Gaps of the report against the float64 reductions of the summaries
    it reduced; ``rows_missing``: trials the reduction did not see."""
    sids = sorted(report["strategies"],
                  key=lambda s: int(s.lstrip("S")))
    n = len(arrays.get("final_wealth", ()))
    if n == 0:
        return {"rows_missing": float(trials)}
    got = report_fields(report, sids)
    want = reduced(arrays, report["percentiles"], years)
    fan = (np.abs(got["wealth_fan"] - want["wealth_fan"])
           / np.maximum(np.abs(want["wealth_fan"]), 1.0))
    rest = [np.abs(np.asarray(got[k], np.float64)
                   - np.asarray(want[k], np.float64)).max()
            for k in want if k != "wealth_fan"]
    return {"rows_missing": float(abs(trials - n)
                                  + abs(report["n_trials"] - trials)),
            "fan_max_gap": float(np.nan_to_num(fan.max(), nan=np.inf)),
            "summary_max_gap": float(np.nan_to_num(max(rest), nan=np.inf))}


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, List[str], dict]:
    """(correct, lines "name value <= limit", {name: {value, limit}})."""
    ok, lines, table = True, [], {}
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} <= {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines, table
