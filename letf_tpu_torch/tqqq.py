"""TQQQ sanity check on the port: the root ``test_tqqq_simple.py`` flow
(reference test_tqqq_simple.py:1-159). 100 sims x 10y of SPY/SSO/TQQQ
(S2, S3, S1) CAGR distributions on ``device``, then the leverage-
consistency analysis: in percentile space higher leverage should widen
the distribution, and the median ordering reflects volatility drag
against drift.

    python -m letf_tpu_torch.tqqq [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

PAIRS = (("S2", "SPY"), ("S3", "SSO"), ("S1", "TQQQ"))


def main(*, device="cuda", years: int = 10, sims: int = 100) -> Dict:
    """Runs the flow, prints the table and the analysis, and returns
    {"cagrs": {name: [sims]}, "spread": {name: p90 - p10}, "ordered":
    SPY < SSO < TQQQ in spread}."""
    os.environ.setdefault("LETF_NON_INTERACTIVE", "1")
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch.parallel.mc_runner import parallel_monte_carlo_fixed

    mc = parallel_monte_carlo_fixed(["S1", "S2", "S3"], years, None,
                                    num_simulations=sims, device=device)

    print("\nHistorical context (2010-2020 realized): TQQQ ~38%, SSO ~20%, "
          "SPY ~13% CAGR — a strong-bull regime, not the expectation.")
    print(f"\n{'':<6}{'p10':>9}{'p25':>9}{'median':>9}{'p75':>9}{'p90':>9}"
          f"  (CAGR, {sims} sims x {years}y)")

    cagrs = {}
    for sid, name in PAIRS:
        w = np.array([r["Final_Wealth"] for r in mc[sid]])
        c = (np.maximum(w, 1e-12) / cfg.INITIAL_CAPITAL) ** (1 / years) - 1
        cagrs[name] = c
        pcts = np.percentile(c, [10, 25, 50, 75, 90]) * 100
        print(f"{name:<6}" + "".join(f"{p:>8.1f}%" for p in pcts))

    print("\nLeverage-consistency analysis:")
    spread = {n: np.percentile(c, 90) - np.percentile(c, 10)
              for n, c in cagrs.items()}
    ordered = bool(spread["SPY"] < spread["SSO"] < spread["TQQQ"])
    print(f"  p90-p10 CAGR spread: SPY {spread['SPY']:.1%} < "
          f"SSO {spread['SSO']:.1%} < TQQQ {spread['TQQQ']:.1%} "
          f"-> {'OK' if ordered else 'VIOLATION'}")
    up = {n: (c > 0).mean() for n, c in cagrs.items()}
    print(f"  P(positive CAGR): SPY {up['SPY']:.0%}, SSO {up['SSO']:.0%}, "
          f"TQQQ {up['TQQQ']:.0%}")
    print("  (Vol drag: higher leverage trades median for tail upside.)")
    return {"cagrs": cagrs, "spread": spread, "ordered": ordered}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
