"""The parametric engine mode end to end against the JAX package.

``run_monte_carlo``, ``emit_trade_lists`` and ``monte_carlo_report``
(``tax_mode="sampled"``) with ``engine_mode="parametric"`` on 32 trials x
1 year (a 126-day random-start buffer), seed 4, float64 on both sides (the
JAX package in x64, its strategies through the XLA scan; the port's
through K4's plain version in float32). Start conditions, regime-1 days,
jump days and validity are equal; wealth and trades within
``check_parity``'s bounds; fans and post-tax tables within rtol 2e-5 (the
float32 strategies); the trade lists of two replayed trials alike."""

import numpy as np
import pytest

from letf_tpu import config as jcfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu_torch import config as tcfg
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.parallel import mc_runner as tmc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, YEARS, SEED = 32, 1, 4
KW = dict(num_simulations=N, seed=SEED, chunk_size=N)


@pytest.fixture(autouse=True)
def short_buffer(monkeypatch):
    for c in (jcfg, tcfg):
        monkeypatch.setattr(c, "RANDOM_START_BUFFER_YEARS", 0.5)


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


def test_run_monte_carlo_parametric_matches_jax(model):
    ref = jmc.run_monte_carlo(model, YEARS, engine_mode="parametric",
                              progress=False, **KW)
    got = tmc.run_monte_carlo(model, YEARS, engine_mode="parametric",
                              device="cpu", **KW)
    k3.check_parity(vars(got), vars(ref),
                    exact=("start_offset", "start_regime", "regime_high_days",
                           "jump_days", "valid", "path_finite", "repaired",
                           "vix_ok"))
    np.testing.assert_allclose(got.liq_mean, ref.liq_mean, rtol=1e-12)
    # legacy_hybrid without pools is the parametric mode (the reference's
    # rename), bit for bit.
    alias = tmc.run_monte_carlo(model, YEARS, engine_mode="legacy_hybrid",
                                device="cpu", **KW)
    np.testing.assert_array_equal(alias.final_wealth, got.final_wealth)


def test_monte_carlo_report_parametric_matches_jax(model):
    ref = jmc.monte_carlo_report(model, YEARS, engine_mode="parametric",
                                 **KW)
    got = tmc.monte_carlo_report(model, YEARS, engine_mode="parametric",
                                 device="cpu", **KW)
    assert got["tax_mode"] == "sampled" and got["n_trials"] == N
    for k in ("valid_frac", "finite_frac", "vix_ok_frac"):
        assert got[k] == ref[k], k
    n_post = 0
    for sid, r in ref["strategies"].items():
        g = got["strategies"][sid]
        for p, v in r["wealth"].items():
            assert g["wealth"][p] == pytest.approx(v, rel=2e-5), (sid, p)
        if "post_tax" in r:
            n_post += 1
            for p, v in r["post_tax"]["wealth"].items():
                assert g["post_tax"]["wealth"][p] == pytest.approx(
                    v, rel=2e-5, abs=1e-2), (sid, p)
            assert g["post_tax"]["median_tax"] == pytest.approx(
                r["post_tax"]["median_tax"], rel=2e-5, abs=1e-2), sid
    assert n_post == 13


def test_emit_trade_lists_parametric_matches_jax(model):
    ref = jmc.emit_trade_lists(model, YEARS, [0, 5], seed=SEED,
                               num_simulations=N, engine_mode="parametric")
    got = tmc.emit_trade_lists(model, YEARS, [0, 5], seed=SEED,
                               num_simulations=N, engine_mode="parametric",
                               device="cpu")
    for trial in (0, 5):
        for sid in jcfg.TAXABLE_IDS:
            a, b = ref[trial][sid], got[trial][sid]
            assert len(a) == len(b) > 0, (trial, sid)
            for x, y in zip(a, b):
                assert (x["day_index"], x["asset"], x["action"]) == (
                    y["day_index"], y["asset"], y["action"])
                assert y["shares"] == pytest.approx(x["shares"], rel=1e-6)
