"""Capital-gains netting: IRC 1222, 1211(b), 1212(b).

The port's own copy of ``letf_tpu/tax/engine.py`` (:26-355): the rule and
election types (``RuleBasis``, ``TaxRule``, ``CapitalLossUsageStrategy``,
``LotSelectionMethod``, ``AMTCreditTiming``, ``TaxpayerElections``), the
netting core ``_net_core`` (straight-line min/max arithmetic, no
data-dependent branch), the exact scalar ``compute_capital_gains``, its
elementwise torch form ``net_capital_gains_array``, and the six
hand-calculated golden scenarios with ``run_golden_tests``, the runner's
mandatory gate. The ``xp`` pair is the array namespace's (minimum,
maximum): ``(min, max)`` for Python floats, ``TORCH_XP`` for tensors.

Netting order (IRS Schedule D instructions):
  1. Net current-year ST gains vs ST losses
  2. Net current-year LT gains vs LT losses
  3. Cross-net current-year ST <-> LT
  4/5. Apply loss carryforwards after current-year netting, by election
  6. Apply the $3,000 capital-loss deduction (ST first by convention)
  7. Remaining losses carry forward, preserving ST/LT character
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Tuple

import torch


class RuleBasis(enum.Enum):
    STATUTORY = "IRC/Treasury Regulation"
    HEURISTIC = "Modeling assumption"
    AMBIGUOUS = "Unclear/litigated"
    TAXPAYER_ELECTION = "Elective"


@dataclasses.dataclass
class TaxRule:
    name: str
    basis: RuleBasis
    citation: str | None = None
    confidence: float = 1.0
    notes: str | None = None


class CapitalLossUsageStrategy(enum.Enum):
    """How loss carryforwards are applied against current-year gains."""
    MAXIMIZE_CURRENT_YEAR = "use_all_asap"
    MINIMIZE_ST_FIRST = "offset_st_first"   # statutory-safe default
    MINIMIZE_LT_FIRST = "offset_lt_first"
    DEFER_TO_FUTURE = "defer_maximum"


class LotSelectionMethod(enum.Enum):
    """Taxpayer election for which lot to sell (IRS specific-ID rules)."""
    FIFO = "fifo"
    LIFO = "lifo"
    HIFO = "hifo"
    LOFO = "lofo"
    LTFO = "ltfo"
    STFO = "stfo"
    MINTAX = "mintax"
    SPEC_ID = "specific"


class AMTCreditTiming(enum.Enum):
    USE_IMMEDIATELY = "immediate"
    DEFER_TO_LOW_INCOME = "defer_low"
    DEFER_TO_HIGH_GAINS = "defer_gains"


@dataclasses.dataclass
class TaxpayerElections:
    capital_loss_strategy: CapitalLossUsageStrategy = CapitalLossUsageStrategy.MINIMIZE_ST_FIRST
    amt_credit_timing: AMTCreditTiming = AMTCreditTiming.USE_IMMEDIATELY
    lot_selection_method: LotSelectionMethod = LotSelectionMethod.FIFO


@dataclasses.dataclass
class CapitalGainsResult:
    taxable_st: float
    taxable_lt: float
    st_loss_cf_out: float
    lt_loss_cf_out: float
    capital_loss_deduction: float
    steps: List[str] = dataclasses.field(default_factory=list)
    rules_applied: List[str] = dataclasses.field(default_factory=list)


def _net_core(st_gains, st_losses, lt_gains, lt_losses,
              st_cf_in, lt_cf_in, strategy: CapitalLossUsageStrategy, xp):
    """Branch-free netting core.

    ``xp`` is the (minimum, maximum) pair of the array namespace:
    ``(min, max)`` for scalars, torch wrappers for tensors. All control
    flow is min/max arithmetic, so one body serves both.

    Returns (taxable_st, taxable_lt, st_cf_out, lt_cf_out, deduction).
    """
    minimum, maximum = xp

    # Steps 1-2: current-year netting within character.
    curr_st = st_gains - st_losses
    curr_lt = lt_gains - lt_losses

    # Step 3: cross-net current year. Exactly one direction can apply.
    # offset_a: ST gain absorbed by LT loss; offset_b: LT gain absorbed by ST loss.
    offset_a = minimum(maximum(curr_st, 0.0), maximum(-curr_lt, 0.0))
    curr_st = curr_st - offset_a
    curr_lt = curr_lt + offset_a
    offset_b = minimum(maximum(curr_lt, 0.0), maximum(-curr_st, 0.0))
    curr_lt = curr_lt - offset_b
    curr_st = curr_st + offset_b

    net_st, net_lt = curr_st, curr_lt
    cf_st, cf_lt = st_cf_in, lt_cf_in

    def apply(cf, net):
        used = minimum(cf, maximum(net, 0.0))
        return cf - used, net - used

    # Steps 4-5: carryforward application order per election.
    if strategy == CapitalLossUsageStrategy.MINIMIZE_ST_FIRST:
        cf_st, net_st = apply(cf_st, net_st)   # ST CF -> ST gains
        cf_lt, net_lt = apply(cf_lt, net_lt)   # LT CF -> LT gains
        cf_st, net_lt = apply(cf_st, net_lt)   # ST CF -> LT gains (cross)
        cf_lt, net_st = apply(cf_lt, net_st)   # LT CF -> ST gains (cross)
    elif strategy == CapitalLossUsageStrategy.MINIMIZE_LT_FIRST:
        cf_lt, net_lt = apply(cf_lt, net_lt)
        cf_st, net_st = apply(cf_st, net_st)
        cf_lt, net_st = apply(cf_lt, net_st)
        cf_st, net_lt = apply(cf_st, net_lt)
    elif strategy == CapitalLossUsageStrategy.DEFER_TO_FUTURE:
        # Same-character offsets only; no cross-application.
        cf_st, net_st = apply(cf_st, net_st)
        cf_lt, net_lt = apply(cf_lt, net_lt)
    else:  # MAXIMIZE_CURRENT_YEAR
        cf_st, net_st = apply(cf_st, net_st)
        cf_lt, net_lt = apply(cf_lt, net_lt)
        cf_st, net_lt = apply(cf_st, net_lt)
        cf_lt, net_st = apply(cf_lt, net_st)

    # Step 6: $3,000 deduction against a combined net loss.
    total_net = net_st + net_lt
    deduction = minimum(3000.0, maximum(-total_net, 0.0))

    # Step 7: carryforwards. Deduction consumed from the ST loss first
    # (by convention), the remainder from LT.
    st_loss = maximum(-net_st, 0.0)
    lt_loss = maximum(-net_lt, 0.0)
    ded_from_st = minimum(deduction, st_loss)
    ded_from_lt = deduction - ded_from_st
    cf_st_out = cf_st + maximum(st_loss - ded_from_st, 0.0)
    cf_lt_out = cf_lt + maximum(lt_loss - ded_from_lt, 0.0)

    taxable_st = maximum(net_st, 0.0)
    taxable_lt = maximum(net_lt, 0.0)
    return taxable_st, taxable_lt, cf_st_out, cf_lt_out, deduction


def _minimum(a, b):
    """torch.minimum that accepts a Python float on either side or both."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(a, torch.Tensor):
        return min(a, b)
    return torch.minimum(a, b) if isinstance(b, torch.Tensor) \
        else torch.clamp_max(a, b)


def _maximum(a, b):
    """torch.maximum that accepts a Python float on either side or both."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(a, torch.Tensor):
        return max(a, b)
    return torch.maximum(a, b) if isinstance(b, torch.Tensor) \
        else torch.clamp_min(a, b)


_SCALAR_XP = (min, max)
TORCH_XP = (_minimum, _maximum)


def compute_capital_gains(
    st_gains: float,
    st_losses: float,
    lt_gains: float,
    lt_losses: float,
    st_loss_cf_in: float,
    lt_loss_cf_in: float,
    elections: TaxpayerElections,
    trace: bool = False,
) -> CapitalGainsResult:
    """Exact scalar netting (host-side; the single source of statutory truth)."""
    strategy = elections.capital_loss_strategy
    taxable_st, taxable_lt, cf_st_out, cf_lt_out, deduction = _net_core(
        float(st_gains), float(st_losses), float(lt_gains), float(lt_losses),
        float(st_loss_cf_in), float(lt_loss_cf_in), strategy, _SCALAR_XP)

    steps = [
        f"Net current ST: {st_gains:,.0f} - {st_losses:,.0f}",
        f"Net current LT: {lt_gains:,.0f} - {lt_losses:,.0f}",
        "Cross-net current year before carryforwards",
        f"Apply carryforwards (strategy: {strategy.value}); "
        f"CF in ST {st_loss_cf_in:,.0f} LT {lt_loss_cf_in:,.0f}",
        f"Capital loss deduction: {deduction:,.0f}",
        f"New carryforwards: ST {cf_st_out:,.0f}, LT {cf_lt_out:,.0f}",
        f"Final: taxable ST {taxable_st:,.0f}, taxable LT {taxable_lt:,.0f}",
    ]
    rules = ["IRC §1222", "IRC §1211(b)", "IRC §1212(b)", f"Election: {strategy.name}"]
    if deduction > 0:
        rules.append("IRC §1211(b) - $3k limit")

    if trace:
        print("\n=== CAPITAL GAINS NETTING TRACE ===")
        for s in steps:
            print(" ", s)
        print("Rules applied:", ", ".join(rules))

    return CapitalGainsResult(
        taxable_st=taxable_st,
        taxable_lt=taxable_lt,
        st_loss_cf_out=cf_st_out,
        lt_loss_cf_out=cf_lt_out,
        capital_loss_deduction=deduction,
        steps=steps,
        rules_applied=rules,
    )


def net_capital_gains_array(st_gains, st_losses, lt_gains, lt_losses,
                            st_cf_in, lt_cf_in,
                            strategy: CapitalLossUsageStrategy =
                            CapitalLossUsageStrategy.MINIMIZE_ST_FIRST):
    """Elementwise netting over tensors of any (broadcast) shape: the
    statutory math of :func:`compute_capital_gains` on every (trial, year)
    cell at once."""
    return _net_core(st_gains, st_losses, lt_gains, lt_losses,
                     st_cf_in, lt_cf_in, strategy, TORCH_XP)


# ============================================================================
# Golden regression tests: hand-calculated scenarios locked as data
# (statutory worked examples, not code).
# ============================================================================


@dataclasses.dataclass
class GoldenTestCase:
    name: str
    description: str
    st_gains: float
    st_losses: float
    lt_gains: float
    lt_losses: float
    st_carryforward_in: float
    lt_carryforward_in: float
    expected_taxable_st: float
    expected_taxable_lt: float
    expected_st_cf_out: float
    expected_lt_cf_out: float
    expected_capital_loss_deduction: float
    election_strategy: CapitalLossUsageStrategy = CapitalLossUsageStrategy.MINIMIZE_ST_FIRST
    statutory_basis: List[str] = dataclasses.field(default_factory=list)
    tolerance: float = 0.01

    def run(self, trace: bool = False) -> Tuple[bool, str]:
        elections = TaxpayerElections(capital_loss_strategy=self.election_strategy)
        actual = compute_capital_gains(
            st_gains=self.st_gains, st_losses=self.st_losses,
            lt_gains=self.lt_gains, lt_losses=self.lt_losses,
            st_loss_cf_in=self.st_carryforward_in,
            lt_loss_cf_in=self.lt_carryforward_in,
            elections=elections, trace=trace)

        checks = [
            ("taxable_st", self.expected_taxable_st, actual.taxable_st),
            ("taxable_lt", self.expected_taxable_lt, actual.taxable_lt),
            ("st_cf_out", self.expected_st_cf_out, actual.st_loss_cf_out),
            ("lt_cf_out", self.expected_lt_cf_out, actual.lt_loss_cf_out),
            ("capital_loss_deduction", self.expected_capital_loss_deduction,
             actual.capital_loss_deduction),
        ]
        failures = [f"  {n}: expected {e:,.2f}, got {a:,.2f}"
                    for n, e, a in checks if abs(e - a) > self.tolerance]
        if failures:
            return False, f"FAILED: {self.name}\n" + "\n".join(failures)
        return True, f"PASSED: {self.name}"


GOLDEN_TESTS = [
    GoldenTestCase(
        name="Basic Netting",
        description="Simple gains and losses, no carryforwards",
        st_gains=50000, st_losses=10000, lt_gains=20000, lt_losses=5000,
        st_carryforward_in=0, lt_carryforward_in=0,
        expected_taxable_st=40000, expected_taxable_lt=15000,
        expected_st_cf_out=0, expected_lt_cf_out=0,
        expected_capital_loss_deduction=0,
        statutory_basis=["IRC §1222"]),
    GoldenTestCase(
        name="$3k Loss Deduction",
        description="Net loss allows $3k deduction, rest carries",
        st_gains=5000, st_losses=20000, lt_gains=0, lt_losses=0,
        st_carryforward_in=0, lt_carryforward_in=0,
        expected_taxable_st=0, expected_taxable_lt=0,
        expected_st_cf_out=12000, expected_lt_cf_out=0,
        expected_capital_loss_deduction=3000,
        statutory_basis=["IRC §1211(b)"]),
    GoldenTestCase(
        name="Cross-Offset Current Year",
        description="ST gains offset by LT losses (current year)",
        st_gains=50000, st_losses=0, lt_gains=0, lt_losses=30000,
        st_carryforward_in=0, lt_carryforward_in=0,
        expected_taxable_st=20000, expected_taxable_lt=0,
        expected_st_cf_out=0, expected_lt_cf_out=0,
        expected_capital_loss_deduction=0,
        statutory_basis=["IRC §1222", "Treas. Reg. §1.1222-1"]),
    GoldenTestCase(
        name="Carryforward Application Order",
        description="CF applied AFTER current-year cross-netting",
        st_gains=100000, st_losses=0, lt_gains=0, lt_losses=60000,
        st_carryforward_in=25000, lt_carryforward_in=15000,
        expected_taxable_st=0, expected_taxable_lt=0,
        expected_st_cf_out=0, expected_lt_cf_out=0,
        expected_capital_loss_deduction=0,
        statutory_basis=["IRC §1212", "Rev. Rul. 84-8"]),
    GoldenTestCase(
        name="Large Loss Year",
        description="Massive loss generates large carryforward",
        st_gains=10000, st_losses=500000, lt_gains=5000, lt_losses=200000,
        st_carryforward_in=0, lt_carryforward_in=0,
        expected_taxable_st=0, expected_taxable_lt=0,
        expected_st_cf_out=487000, expected_lt_cf_out=195000,
        expected_capital_loss_deduction=3000,
        statutory_basis=["IRC §1211(b)", "IRC §1212"]),
    GoldenTestCase(
        name="Election Test: DEFER_TO_FUTURE",
        description="Conservative CF usage",
        st_gains=50000, st_losses=0, lt_gains=30000, lt_losses=0,
        st_carryforward_in=40000, lt_carryforward_in=25000,
        election_strategy=CapitalLossUsageStrategy.DEFER_TO_FUTURE,
        expected_taxable_st=10000, expected_taxable_lt=5000,
        expected_st_cf_out=0, expected_lt_cf_out=0,
        expected_capital_loss_deduction=0,
        statutory_basis=["IRC §1212 - Election"]),
]


def run_golden_tests(trace_failures: bool = False) -> Dict:
    """Run all golden tests against the real engine. A failure means the
    system is broken: it raises."""
    results = {"total": len(GOLDEN_TESTS), "passed": 0, "failed": 0, "details": []}

    print("\n" + "=" * 80)
    print("GOLDEN-CASE REGRESSION TESTS (WIRED TO REAL ENGINE)")
    print("=" * 80)

    for test in GOLDEN_TESTS:
        passed, message = test.run(trace=trace_failures and results["failed"] == 0)
        results["details"].append({"test": test.name, "passed": passed, "message": message})
        if passed:
            results["passed"] += 1
            print(f"  PASS: {test.name}")
        else:
            results["failed"] += 1
            print(f"  FAIL: {test.name}")
            print(message)

    print(f"RESULTS: {results['passed']}/{results['total']} passed")
    if results["failed"] > 0:
        raise RuntimeError(
            f"{results['failed']} golden tax tests FAILED - system broken")
    return results
