"""The port's long-horizon envelope, a twin of tests/test_long_horizon.py.

The reference's TIME_HORIZONS include 40 and 50 years, and a 50-year trial
spans 50 x 252 + 1,260 = 13,860 days. The JAX package's TPU plans
(``fits_vmem``, ``_plan_blocks``, ``_plan_blocks_4d``) have no counterpart
in the port; its day-dependent limits take their place:

- ``plan_max_spells`` equals the JAX package's exactly (384 at 50 years,
  the TPU record's ``long_horizon_50y.max_spells_planned``);
- K7 (``sort_bridge._merge_limit``) takes a 12,600-day half with its sec
  row and permutation out of shared memory, and refuses 14,529 days;
- K8's loss-day walk (``wash.match_smem``) needs 101,120 dynamic shared
  bytes at 12,600 days, under the 227 KB a block can take, and
  ``wash.check_smem`` refuses what no block can take.

Then ``run_monte_carlo(model, 50, 4, seed=11, chunk_size=4)`` on the CPU
against the JAX package's identical call: the start offsets, start regimes
and regime-1 days exact (the spell plan and the regime chain at 13,860
days), every wealth finite, 12,600 simulated days. The two calls take
different draw routes on the CPU (the port its slab chain, K1's counter
draws in their plain version; the JAX package its batched XLA route, since
its slab chain runs only on a TPU), so their wealth is not compared here:
S1 per trial at 50 years is held on the card to the JAX package's slab
route (``chip_smoke.py``'s envelope phase, constants from
``tools/long_horizon_reference.py``). The 50-year tax bridge:
tests/test_torch_long_horizon_tax.py.
"""

import numpy as np
import pytest

from letf_tpu import config as jcfg
from letf_tpu.models.params import default_sim_model as jax_default_model
from letf_tpu.ops.path_batched import plan_max_spells as jax_plan
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu_torch import config as tcfg
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.ops import path_batched, sort_bridge, wash
from letf_tpu_torch.parallel import mc_runner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T50 = 50 * 252 + 1260


def test_horizon_menu_includes_40_and_50():
    assert 40 in tcfg.TIME_HORIZONS and 50 in tcfg.TIME_HORIZONS
    assert tuple(tcfg.TIME_HORIZONS) == tuple(jcfg.TIME_HORIZONS)


@pytest.mark.parametrize("days", [40 * 252 + 1260, 50 * 252, T50])
def test_spell_plan_equals_jax(days):
    got = path_batched.plan_max_spells(default_sim_model(), days)
    assert got == jax_plan(jax_default_model(), days)
    assert 0 < got <= days
    if days == T50:
        assert got == 384


def test_bridge_limits_at_50_years():
    S = 50 * 252
    assert sort_bridge._merge_limit(S, True) == (16 * S, False)
    assert sort_bridge._merge_limit(14_528, True) == (232_448, False)
    with pytest.raises(ValueError, match="14529 days"):
        sort_bridge._merge_limit(14_529, True)
    assert wash.match_smem(S) == wash.check_smem(S) == 101_120
    assert wash.match_smem(S) <= 227 * 1024
    assert wash.check_smem(29_024) <= wash.MAX_SMEM
    with pytest.raises(ValueError, match="29025 days"):
        wash.check_smem(29_025)


def test_50y_full_engine_chunk_matches_jax():
    n = 4
    got = mc_runner.run_monte_carlo(default_sim_model(), 50,
                                    num_simulations=n, seed=11,
                                    chunk_size=n, progress=False,
                                    device="cpu")
    ref = jmc.run_monte_carlo(jax_default_model(), 50, num_simulations=n,
                              seed=11, chunk_size=n, progress=False)
    assert got.sim_days == ref.sim_days == 50 * 252
    for k in ("start_offset", "start_regime", "regime_high_days",
              "trial_ids", "antithetic"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert got.final_wealth.shape == (n, 19)
    assert np.isfinite(got.final_wealth).all()
    assert np.isfinite(got.max_dd).all() and got.path_finite.all()
    spy = got.final_wealth[:, tcfg.STRATEGY_INDEX["S2"]]
    assert (spy > 0).all() and not np.allclose(spy, tcfg.INITIAL_CAPITAL)
    # Antithetic pairs share their regime path.
    np.testing.assert_array_equal(got.regime_high_days[0::2],
                                  got.regime_high_days[1::2])
