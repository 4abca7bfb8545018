"""The port's FIFO device bridge and vectorized tax against the JAX
package on the same trade-journal emission, at float64.

The emission is the port's own general path (16 trials, 3 years, no random
start) cast to float64; the JAX bridge (``lax.sort`` and the wash scan, its
CPU route) and the port (plain K7 and K8) both replay it. Yearly activity
within rel 1e-9 (abs 1e-9 dollars where buckets cancel to ~0: the cumulative
sums add in another order), trade counts and the skipped-asset flag
exact; the tax within rel 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as cfg
from letf_tpu.income import simulate_wired_income_path
from letf_tpu.models.params import default_sim_model
from letf_tpu.reporting import DEFAULT_TAX_CONFIG, _income_kwargs
from letf_tpu.tax import device_bridge as jbridge
from letf_tpu.tax import vectorized as jvec
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.tax import device_bridge, vectorized
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, YEARS = 16, 3


@pytest.fixture(scope="module")
def emission():
    run = mc_runner._Run(default_sim_model(), YEARS, N, 9,
                         random_start_method="none", device="cpu")
    ids, anti = mc_runner._trial_layout(N, True)
    _, em = mc_runner.general_chunk(run, ids, anti)
    return [e.numpy() if e.dtype == torch.int8 else e.double().numpy()
            for e in em]                                   # [S, B, 13] each


@pytest.fixture(scope="module")
def bridged(emission):
    """JAX and port activity for each (column, assets) case."""
    out = {}
    for col, assets in ((0, (0,)), (1, (0, 1)), (1, (0,)), (12, (0,))):
        cols = [e[:, :, col] for e in emission]
        ref = jbridge.yearly_activity_from_emission(
            *[jnp.asarray(c) for c in cols], n_years=YEARS, assets=assets)
        got = device_bridge.yearly_activity_from_emission(
            *[torch.as_tensor(c) for c in cols], n_years=YEARS,
            assets=assets)
        out[col, assets] = ([np.asarray(r) for r in ref],
                            [g.numpy() for g in got])
    return out


@pytest.mark.parametrize("case", [(0, (0,)), (1, (0, 1)), (1, (0,)),
                                  (12, (0,))],
                         ids=["S7", "S8_both_assets", "S8_tqqq_only", "S19"])
def test_bridge_matches_jax(bridged, case):
    (ref_act, ref_n, ref_viol), (act, n, viol) = bridged[case]
    assert bool(viol) == bool(ref_viol)
    np.testing.assert_array_equal(n, ref_n)
    np.testing.assert_allclose(act, ref_act, rtol=1e-9, atol=1e-9)
    if case[0] != 1:
        assert (np.abs(act) > 0).sum() > N          # real gains and losses


def test_s8_sells_its_spy_leg(bridged):
    """S8 is the only strategy that trades the SPY leg: skipping it is
    flagged exactly when S8 sold SPY shares."""
    (_, _, ref_viol), (_, _, viol) = bridged[1, (0,)]
    assert bool(viol) == bool(ref_viol)
    assert bool(viol)


@pytest.mark.parametrize("filing_status,state", [("single", "CA"),
                                                 ("married", "WA")])
def test_total_tax_matches_jax(bridged, filing_status, state):
    (ref_act, ref_n, _), _ = bridged[1, (0, 1)]
    cfgd = dict(DEFAULT_TAX_CONFIG)
    income = simulate_wired_income_path(cfgd["ordinary_income"], YEARS,
                                        **_income_kwargs(cfgd))
    kw = dict(filing_status=filing_status, state_code=state)
    ref = jvec.total_tax_all_trials(
        jnp.asarray(ref_act[..., :4]), jnp.asarray(income),
        cfg.INITIAL_CAPITAL, jnp.asarray(ref_n / YEARS), **kw)
    got = vectorized.total_tax_all_trials(
        torch.as_tensor(np.array(ref_act[..., :4])), income,
        cfg.INITIAL_CAPITAL,
        torch.as_tensor(ref_n / YEARS), **kw)
    for k in ("total_tax", "yearly_tax", "taxable_st", "taxable_lt",
              "final_cf_st", "final_cf_lt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    assert (got["total_tax"].numpy() > 0).any()
