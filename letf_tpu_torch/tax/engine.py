"""Capital-gains netting: IRC 1222, 1211(b), 1212(b).

The port's own copy of the netting core of ``letf_tpu/tax/engine.py``:
``_net_core`` (straight-line min/max arithmetic, no data-dependent branch)
and ``CapitalLossUsageStrategy``. The ``xp`` pair is the array namespace's
(minimum, maximum): ``(min, max)`` for Python floats, torch wrappers for
tensors (tax/vectorized.py).

Netting order (IRS Schedule D instructions):
  1. Net current-year ST gains vs ST losses
  2. Net current-year LT gains vs LT losses
  3. Cross-net current-year ST <-> LT
  4/5. Apply loss carryforwards after current-year netting, by election
  6. Apply the $3,000 capital-loss deduction (ST first by convention)
  7. Remaining losses carry forward, preserving ST/LT character
"""

from __future__ import annotations

import enum


class CapitalLossUsageStrategy(enum.Enum):
    """How loss carryforwards are applied against current-year gains."""
    MAXIMIZE_CURRENT_YEAR = "use_all_asap"
    MINIMIZE_ST_FIRST = "offset_st_first"   # statutory-safe default
    MINIMIZE_LT_FIRST = "offset_lt_first"
    DEFER_TO_FUTURE = "defer_maximum"


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
