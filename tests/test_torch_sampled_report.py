"""The port's default report (tax_mode="sampled") and emit_trade_lists.

As tests/test_mc_runner.py:219 does for the JAX report: with n = 16 <=
MAX_TAX_SIMS every trial is sampled, the interpolation returns each
trial's own exact tax, and the post-tax fans must equal the percentiles of
(wealth - that trial's exact tax). The exact taxes here come from the JAX
package's bridge and tax, run on the port's own emission in the port's
CPU dtype (float64): rtol 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as cfg
from letf_tpu.income import simulate_wired_income_path
from letf_tpu.models.params import default_sim_model
from letf_tpu.reporting import DEFAULT_TAX_CONFIG, MAX_TAX_SIMS, _income_kwargs
from letf_tpu.strategies.host import trades_from_emission as jax_trades
from letf_tpu.tax.device_bridge import yearly_activity_from_emission
from letf_tpu.tax.vectorized import total_tax_all_trials
from letf_tpu_torch.parallel import mc_runner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, SEED = 16, 9


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.fixture(scope="module")
def report(model):
    return mc_runner.monte_carlo_report(model, 1, num_simulations=N,
                                        seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def emission(model):
    run = mc_runner._Run(model, 1, N, SEED, device="cpu")
    ids, anti = mc_runner._trial_layout(N, run.use_antithetic)
    summaries, em = mc_runner.general_chunk(run, ids, anti)
    return summaries, [e.numpy() if e.dtype == torch.int8
                       else e.double().numpy() for e in em]


def test_default_report_has_post_tax_tables(report):
    assert report["tax_mode"] == "sampled"
    assert report["post_tax_seconds"] > 0
    assert report["tax_config"] == {"state": "CA", "ordinary_income": 150000,
                                    "filing_status": "single"}
    for sid, s in report["strategies"].items():
        if sid not in cfg.TAXABLE_IDS:
            assert "post_tax" not in s
            continue
        pt = s["post_tax"]
        assert set(pt) == {"wealth", "cagr", "median_tax",
                           "win_rate_vs_spy_post_tax", "n_sampled", "method"}
        assert pt["n_sampled"] == min(N, MAX_TAX_SIMS)
        assert list(pt["wealth"]) == [f"p{p}" for p in report["percentiles"]]
        assert all(np.isfinite(v) for v in pt["wealth"].values())


def test_sampled_fans_equal_exact_tax(model, report, emission):
    """Fans, median taxes and post-tax win rates equal the exact per-trial
    taxes of the JAX bridge + tax on the same emission (rtol 1e-9)."""
    fw = mc_runner.run_monte_carlo(model, 1, num_simulations=N, seed=SEED,
                                   device="cpu").final_wealth.astype(
                                       np.float64)
    _, em = emission
    income = simulate_wired_income_path(
        DEFAULT_TAX_CONFIG["ordinary_income"], 1,
        **_income_kwargs(DEFAULT_TAX_CONFIG))
    pcts = report["percentiles"]
    spy = fw[:, cfg.STRATEGY_INDEX["S2"]]
    for col, sid in enumerate(cfg.TAXABLE_IDS):
        act, n_tr = yearly_activity_from_emission(
            *[jnp.asarray(e[:, :, col]) for e in em], n_years=1)
        tax = np.asarray(total_tax_all_trials(
            act[..., :4], jnp.asarray(income), cfg.INITIAL_CAPITAL,
            n_tr.astype(act.dtype) / 1.0)["total_tax"])
        w = fw[:, cfg.STRATEGY_INDEX[sid]]
        assert len(np.unique(w)) == N, sid        # no ties: own tax each
        post = np.maximum(w - tax, 0.0)
        pt = report["strategies"][sid]["post_tax"]
        np.testing.assert_allclose(
            [pt["wealth"][f"p{p}"] for p in pcts], np.percentile(post, pcts),
            rtol=1e-9, err_msg=sid)
        np.testing.assert_allclose(pt["median_tax"], np.median(tax),
                                   rtol=1e-9, atol=1e-9, err_msg=sid)
        assert pt["win_rate_vs_spy_post_tax"] == pytest.approx(
            float(np.mean(post > spy)))
    assert report["strategies"]["S7"]["post_tax"]["median_tax"] > 0


def test_replay_is_the_sampled_wealth(model, emission):
    """The replayed general path gives the trials the report sampled: its
    wealth matches the slab chunk's within check_parity's bounds."""
    from letf_tpu_torch.ops import compose_strategies as k3

    summaries, _ = emission
    arr = mc_runner.run_monte_carlo(model, 1, num_simulations=N, seed=SEED,
                                    device="cpu")
    k3.check_parity({k: v.numpy() for k, v in summaries.items()}, vars(arr),
                    exact=("start_offset", "start_regime", "valid"))


def test_emit_trade_lists_reference_format(model):
    """Reference trade dicts, equal to the JAX package's host replay
    (strategies/host.trades_from_emission) of the same trials' journal."""
    trials = [0, 5, 11]
    run = mc_runner._Run(model, 1, N, SEED, device="cpu")
    ids, anti = mc_runner._trial_layout(N, run.use_antithetic)
    _, em = mc_runner.general_chunk(run, ids[trials], anti[trials])
    em = [e.numpy() for e in em]
    got = mc_runner.emit_trade_lists(model, 1, trials, seed=SEED,
                                     num_simulations=N, device="cpu")
    assert list(got) == trials
    for row, trial in enumerate(trials):
        assert list(got[trial]) == list(cfg.TAXABLE_IDS)
        for col, sid in enumerate(cfg.TAXABLE_IDS):
            assert got[trial][sid] == jax_trades(*em, row, col), (row, sid)
    assert sum(len(v) for v in got[0].values()) > 0
