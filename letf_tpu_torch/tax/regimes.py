"""Tax-regime (rule interpretation) Monte Carlo.

The port's copy of ``letf_tpu/tax/regimes.py`` (host Python): scenarios
override rules (trader status, wash-sale strictness, state conformity),
not output multipliers. As in the reference, the regime Monte Carlo is a standalone
analysis tool — it is not wired into the main MC path.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from letf_tpu_torch.tax.engine import (
    CapitalGainsResult,
    TaxpayerElections,
    compute_capital_gains,
)


@dataclasses.dataclass
class TaxRegimeScenario:
    """One interpretation of ambiguous tax rules (rule-level toggles)."""
    name: str
    probability: float
    trader_status_applies: bool = False
    constructive_sale_triggered: bool = False
    wash_sale_disallowance_rate: float = 1.0
    state_conforms_to_federal: bool = True

    def apply_to_capital_gains(self, base_result: CapitalGainsResult,
                               trade_volume: float) -> CapitalGainsResult:
        if self.trader_status_applies:
            base_result.rules_applied.append(
                "REGIME: Trader status applied (all ordinary income)")
        if self.wash_sale_disallowance_rate != 1.0:
            base_result.rules_applied.append(
                f"REGIME: Wash sale strictness = {self.wash_sale_disallowance_rate}")
        if not self.state_conforms_to_federal:
            base_result.rules_applied.append(
                "REGIME: State non-conformity (additional state tax)")
        return base_result


TAX_REGIMES = [
    TaxRegimeScenario("Conservative (Strict IRS)", 0.60,
                      trader_status_applies=False, wash_sale_disallowance_rate=1.0),
    TaxRegimeScenario("Aggressive (Pro-taxpayer)", 0.25,
                      trader_status_applies=False, wash_sale_disallowance_rate=0.8),
    TaxRegimeScenario("Worst Case (Audit)", 0.10,
                      trader_status_applies=True, wash_sale_disallowance_rate=1.2),
    TaxRegimeScenario("Best Case", 0.05,
                      trader_status_applies=False, wash_sale_disallowance_rate=0.7),
]


def monte_carlo_tax_regimes(
    st_gains: float, st_losses: float, lt_gains: float, lt_losses: float,
    st_cf_in: float, lt_cf_in: float,
    elections: TaxpayerElections,
    n_samples: int = 1000,
    seed: Optional[int] = None,
) -> Dict:
    """Monte Carlo over rule interpretations (samples rules, not outcomes)."""
    rng = np.random.default_rng(seed)
    probs = np.array([r.probability for r in TAX_REGIMES])
    samples = []
    regime_results = defaultdict(list)

    for _ in range(n_samples):
        regime = TAX_REGIMES[int(rng.choice(len(TAX_REGIMES), p=probs))]
        base = compute_capital_gains(
            st_gains=st_gains, st_losses=st_losses,
            lt_gains=lt_gains, lt_losses=lt_losses,
            st_loss_cf_in=st_cf_in, lt_loss_cf_in=lt_cf_in,
            elections=elections)
        result = regime.apply_to_capital_gains(base, 0.0)
        outcome = result.taxable_st + result.taxable_lt
        samples.append(outcome)
        regime_results[regime.name].append(outcome)

    arr = np.array(samples)
    return {
        "expected_taxable": float(np.mean(arr)),
        "std_dev": float(np.std(arr)),
        "percentiles": {f"p{p}": float(np.percentile(arr, p))
                        for p in (10, 25, 50, 75, 90)},
        "regime_breakdown": {
            name: {
                "mean": float(np.mean(vals)),
                "std": float(np.std(vals)),
                "probability": next(r.probability for r in TAX_REGIMES
                                    if r.name == name),
            }
            for name, vals in regime_results.items()
        },
    }


def get_system_guarantees() -> Dict[str, str]:
    """What the engine can GUARANTEE (proven by tests), vs what it cannot."""
    return {
        "capital_gains_netting": (
            "Correct for all statutory capital gain cases covered by golden "
            "tests. 6/6 passing. IRC §1222, §1211(b), §1212(b) compliant."),
        "taxpayer_elections": (
            "All elective strategies implemented and tested. "
            "MINIMIZE_ST_FIRST is statutory-safe default."),
        "ambiguous_areas": (
            "Tax computed under conservative/strict IRS interpretation (full "
            "wash sale disallowance, standard capital gains treatment). "
            "Regime Monte Carlo not yet wired."),
        "rule_basis": (
            "Every calculation marked as STATUTORY (IRC), HEURISTIC "
            "(approximation), AMBIGUOUS (gray area), or ELECTIVE."),
        "regression_protection": (
            "6 golden tests lock correctness forever. If any test fails, the "
            "system is broken and unusable."),
        "not_guaranteed": (
            "Future law changes, individual circumstances beyond capital "
            "gains, IRS interpretation of novel situations, court decisions "
            "not yet rendered."),
    }
