"""The port's runner and CLI against the JAX package's.

- ``run_report``, ``calibrate_all`` (and the other calibration entries)
  and ``build_parser`` take the reference's parameters, in its order,
  plus the port's keyword-only ``device`` (and ``stage_seconds``) and
  ``--device``.
- ``run_report(model=<the short history's fits>, tax_mode="none")`` at 256
  trials equals the JAX package's ``run_report`` at test_torch_slice.py's
  tolerances. The JAX package takes its production (TPU) route here: its
  chunk body is replaced, for the test, by its slab chain
  (``slab_chunk_summaries``, the Pallas kernels in interpret mode) on one
  device, as test_torch_slice.py runs it; its CPU route draws the joint
  returns from another stream. Both packages' random-start buffer is cut
  to half a year to keep interpret mode short.
- ``run_report`` with the default sampled taxes and another state's tax
  configuration: at 16 trials (every trial sampled) its post-tax fans
  equal the percentiles of each trial's wealth less the exact tax that the
  JAX package's bridge and tax give on the port's own emission (rtol
  1e-9).
- ``--report`` reaches ``run_report``, the default branch ``runner.run``
  and ``--quick`` ``quick.main``, each with the reference's arguments
  (and ``--device``); the default ``device="cuda"`` raises without a card.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import calibration as jcal
from letf_tpu import cli as jcli
from letf_tpu import config as jcfg
from letf_tpu import runner as jrunner
from letf_tpu.income import simulate_wired_income_path
from letf_tpu.ops import pallas_joint, pallas_strategies, pallas_window
from letf_tpu.ops.slab_chunk import slab_chunk_summaries as jax_chunk
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu.parallel import mesh as jmesh
from letf_tpu.reporting import DEFAULT_TAX_CONFIG, _income_kwargs
from letf_tpu.tax.device_bridge import yearly_activity_from_emission
from letf_tpu.tax.vectorized import total_tax_all_trials
from letf_tpu_torch import calibration as tcal
from letf_tpu_torch import cli, runner
from letf_tpu_torch import config as tcfg
from letf_tpu_torch.data import generate_synthetic_history
from letf_tpu_torch.parallel import mc_runner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, BUF_YEARS, SEED = 256, 0.5, 3
CACHES = ("REGIME_MODEL_CACHE", "CORRELATION_CACHE",
          "JOINT_RETURN_MODEL_CACHE", "FUNDING_MODEL_CACHE",
          "TRACKING_RESIDUAL_CACHE", "STRESS_STATE_CACHE")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The port's calibration of the 2000-2025 synthetic history."""
    tmp = tmp_path_factory.mktemp("cache")
    with pytest.MonkeyPatch.context() as mp:
        for name in CACHES:
            mp.setattr(tcfg, name, tmp / getattr(tcfg, name).name)
        model, _ = tcal.calibrate_all(
            generate_synthetic_history("2000-01-01", "2025-12-31"),
            device="cpu")
    return model


def params(fn):
    return [(p.name, p.default, p.kind)
            for p in inspect.signature(fn).parameters.values()]


def test_signatures_match_the_reference():
    for fn, extra in ((runner.run_report, ["device", "stage_seconds"]),
                      (runner.run, ["device", "stage_seconds"]),
                      (tcal.calibrate_all, ["device"]),
                      (tcal.calibrate_joint_return_model, ["device"]),
                      (tcal.calibrate_funding_spread_model, ["device"]),
                      (tcal.calibrate_stress_state_model, ["device"]),
                      (tcal.calibrate_tracking_residual_model, ["device"]),
                      (tcal.fit_garch11_mle, ["device"]),
                      (tcal.calibrate_regime_model_volatility, []),
                      (tcal.calibrate_correlations_time_varying, []),
                      (cli.build_parser, []), (cli.main, [])):
        ref = getattr({"runner": jrunner, "cli": jcli}.get(
            fn.__module__.rsplit(".", 1)[-1], jcal), fn.__name__)
        got = params(fn)
        assert got[:len(got) - len(extra)] == params(ref), fn.__name__
        for name, default, kind in got[len(got) - len(extra):]:
            assert name in extra and kind == inspect.Parameter.KEYWORD_ONLY
            assert default == ("cuda" if name == "device" else None)
    ours = {a.dest: a for a in cli.build_parser()._actions}
    for a in jcli.build_parser()._actions:
        b = ours.pop(a.dest)
        assert (b.option_strings, b.default, b.choices, b.nargs, b.type) \
            == (a.option_strings, a.default, a.choices, a.nargs, a.type)
    assert list(ours) == ["device"]
    assert ours["device"].default == "cuda"


def test_pretax_report_matches_jax(fits, monkeypatch):
    for c in (jcfg, tcfg):
        monkeypatch.setattr(c, "RANDOM_START_BUFFER_YEARS", BUF_YEARS)
    got = runner.run_report(horizons=[1], num_simulations=N, seed=SEED,
                            model=fits, chunk_size=1024, tax_mode="none",
                            device="cpu")[1]

    for mod, name in ((pallas_joint, "pallas_joint_generate"),
                      (pallas_window, "window_offsets_slab"),
                      (pallas_strategies, "pallas_compose_strategies_run")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))

    def slab_body(model, run_key, trial_ids, antithetic, sim_days,
                  buffer_days, random_start_method="offset",
                  apply_costs=True, emit_trades=False, moment_matching=True,
                  engine_mode="institutional_v1", bootstrap_pools=None,
                  cashflows=None, anchors=None, max_spells=None):
        assert engine_mode == "institutional_v1" and not emit_trades
        return jax_chunk(model, run_key, trial_ids, antithetic,
                         sim_days=sim_days, buffer_days=buffer_days,
                         random_start_method=random_start_method,
                         anchors=anchors, cashflows=cashflows,
                         apply_costs=apply_costs,
                         moment_matching=moment_matching,
                         max_spells=max_spells), None

    monkeypatch.setattr(jmc, "_mc_chunk_body", slab_body)
    monkeypatch.setattr(jmc, "trial_mesh",
                        lambda: jmesh.trial_mesh(jax.devices()[:1]))
    jax_chunk.clear_cache()
    ref = jrunner.run_report(horizons=[1], num_simulations=N, seed=SEED,
                             model=fits, chunk_size=1024,
                             tax_mode="none")[1]
    jax_chunk.clear_cache()

    assert got["n_trials"] == ref["n_trials"] == N
    for k in ("valid_frac", "finite_frac", "vix_ok_frac", "repaired_frac"):
        assert got[k] == pytest.approx(ref[k], abs=1.5 / N), k
    assert got["valid_frac"] > 0.9
    for sid, r in ref["strategies"].items():
        g = got["strategies"][sid]
        np.testing.assert_allclose(list(g["wealth"].values()),
                                   list(r["wealth"].values()), rtol=5e-3,
                                   err_msg=sid)
        assert g["median_max_dd"] == pytest.approx(r["median_max_dd"],
                                                   rel=5e-3, abs=1e-4)
        assert g["trades_per_year"] == pytest.approx(r["trades_per_year"],
                                                     rel=1e-2, abs=1e-2)
        assert g["win_rate_vs_spy"] == pytest.approx(r["win_rate_vs_spy"],
                                                     abs=5e-3)
        assert g["ruin_frac"] == pytest.approx(r["ruin_frac"], abs=1e-3)


def test_sampled_report_taxes_match_jax(fits, capsys):
    """Every trial sampled (16 <= MAX_TAX_SIMS): the post-tax fans are the
    percentiles of wealth less the JAX package's exact tax of each trial
    under New York's married-filing configuration."""
    n, seed = 16, 9
    overrides = {"state": "NY", "ordinary_income": 250000,
                 "filing_status": "married"}
    stages = {}
    rep = runner.run_report(horizons=[1], num_simulations=n, seed=seed,
                            model=fits, tax_overrides=overrides,
                            device="cpu", stage_seconds=stages)[1]
    printed = capsys.readouterr().out
    assert "GOLDEN-CASE REGRESSION TESTS" in printed
    assert "AT-SCALE REPORT: 16 trials x 1y" in printed
    assert "TAXABLE (post-tax, NY $250,000 married; sampled" in printed
    assert set(stages) == {"horizon_1"}
    assert rep["tax_config"] == {"state": "NY", "ordinary_income": 250000,
                                 "filing_status": "married"}

    run = mc_runner._Run(fits, 1, n, seed, device="cpu")
    ids, anti = mc_runner._trial_layout(n, run.use_antithetic)
    _, em = mc_runner.general_chunk(run, ids, anti)
    em = [e.numpy() if e.dtype == torch.int8 else e.double().numpy()
          for e in em]
    fw = mc_runner.run_monte_carlo(fits, 1, num_simulations=n, seed=seed,
                                   device="cpu").final_wealth
    income = simulate_wired_income_path(
        250000, 1, **_income_kwargs(dict(DEFAULT_TAX_CONFIG, **overrides)))
    spy = fw[:, jcfg.STRATEGY_INDEX["S2"]]
    pcts = rep["percentiles"]
    for col, sid in enumerate(jcfg.TAXABLE_IDS):
        act, n_tr = yearly_activity_from_emission(
            *[jnp.asarray(e[:, :, col]) for e in em], n_years=1)
        tax = np.asarray(total_tax_all_trials(
            act[..., :4], jnp.asarray(income), jcfg.INITIAL_CAPITAL,
            n_tr.astype(act.dtype) / 1.0, filing_status="married",
            state_code="NY")["total_tax"])
        w = fw[:, jcfg.STRATEGY_INDEX[sid]].astype(np.float64)
        assert len(np.unique(w)) == n, sid
        post = np.maximum(w - tax, 0.0)
        pt = rep["strategies"][sid]["post_tax"]
        np.testing.assert_allclose([pt["wealth"][f"p{p}"] for p in pcts],
                                   np.percentile(post, pcts), rtol=1e-9,
                                   err_msg=sid)
        np.testing.assert_allclose(pt["median_tax"], np.median(tax),
                                   rtol=1e-9, atol=1e-9, err_msg=sid)
        assert pt["win_rate_vs_spy_post_tax"] == pytest.approx(
            float(np.mean(post > spy)))


def test_cli_routes(monkeypatch):
    from letf_tpu_torch import quick

    seen = {}

    def fake(name):
        def call(*a, **kw):
            seen[name] = (a, kw)
            return {}
        return call

    monkeypatch.setattr(runner, "run_report", fake("report"))
    monkeypatch.setattr(runner, "run", fake("run"))
    monkeypatch.setattr(quick, "main", fake("quick"))
    monkeypatch.setattr(tcfg, "NUM_SIMULATIONS", tcfg.NUM_SIMULATIONS)
    monkeypatch.setenv("LETF_NON_INTERACTIVE", "")
    cli.main(["--report", "--synthetic-data", "--sims", "64", "--horizons",
              "10", "20", "--state", "TX", "--tax-mode", "none",
              "--device", "cpu"])
    assert seen.pop("report") == ((), dict(
        horizons=[10, 20], num_simulations=64, seed=0, force_synthetic=True,
        tax_overrides={"state": "TX", "ordinary_income": 150000,
                       "filing_status": "single"},
        tax_mode="none", device="cpu"))
    assert tcfg.NUM_SIMULATIONS == 64
    # The default branch: the full analysis, the menus at their defaults.
    cli.main(["--horizons", "5", "--seed", "7", "--state", "NJ", "--income",
              "90000", "--filing", "married", "--start-date", "1980-01-01"])
    assert seen.pop("run") == ((), dict(
        horizons=[5], seed=7,
        tax_overrides={"state": "NJ", "ordinary_income": 90000,
                       "filing_status": "married"},
        force_synthetic=False, device="cuda"))
    assert tcfg.ANALYSIS_START_DATE == "1980-01-01"
    assert tcfg.NUM_SIMULATIONS == 64
    import os
    assert os.environ["LETF_NON_INTERACTIVE"] == "1"
    monkeypatch.setattr(tcfg, "ANALYSIS_START_DATE", "1926-07-01")
    # --quick: 10 simulations unless --sims says otherwise.
    cli.main(["--quick", "--device", "cpu"])
    assert seen.pop("quick") == ((), dict(device="cpu",
                                          force_synthetic=False))
    assert tcfg.NUM_SIMULATIONS == 10
    cli.main(["--quick", "--sims", "4", "--synthetic-data"])
    assert seen.pop("quick") == ((), dict(device="cuda",
                                          force_synthetic=True))
    assert tcfg.NUM_SIMULATIONS == 4 and not seen


def test_cuda_without_a_card_raises(fits, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device resolves")
    monkeypatch.setattr(tcfg, "NUM_SIMULATIONS", tcfg.NUM_SIMULATIONS)
    monkeypatch.setenv("LETF_NON_INTERACTIVE", "")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_report(horizons=[1], num_simulations=8, model=fits)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--report", "--synthetic-data", "--sims", "8"])
    with pytest.raises(RuntimeError, match="cuda"):
        tcal.fit_garch11_mle(np.ones(300))
    # The full analysis, the results list and the quick flow default to the
    # card too, and nothing drops to the CPU: each raises before any work.
    from letf_tpu_torch import quick
    from letf_tpu_torch.parallel import mc_runner as tmc

    with pytest.raises(RuntimeError, match="cuda"):
        runner.run(horizons=[1])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--synthetic-data", "--sims", "8", "--horizons", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        quick.main()
    with pytest.raises(RuntimeError, match="cuda"):
        tmc.parallel_monte_carlo_fixed(["S1"], 1, fits, num_simulations=8)
