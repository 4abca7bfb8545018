"""The port's production slice against the JAX slab chain.

One module-scoped fixture runs the JAX ``slab_chunk_summaries`` with its
three Pallas kernels in interpret mode (B=1024, 126-day window, 126-day
buffer, ``jax.random.key(7)``). The port runs the same trials on the CPU
with the plain versions of its kernels."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as cfg
from letf_tpu_torch import config as tcfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import pallas_joint, pallas_strategies, pallas_window
from letf_tpu.ops.path_batched import plan_max_spells
from letf_tpu.ops.slab_chunk import slab_chunk_summaries as jax_chunk
from letf_tpu_torch.data import generate_synthetic_history
from letf_tpu_torch.models.bootstrap import build_bootstrap_pools
from letf_tpu_torch.models.params import from_numpy
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.slab_chunk import slab_chunk_summaries
from letf_tpu_torch.parallel import mc_runner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, SIM, BUF, SEED = 1024, 126, 126, 7
FANS = (10, 50, 90)


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.fixture(scope="module")
def jax_ref(model):
    """JAX slab chain, Pallas kernels in interpret mode (~30 s)."""
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2) == 1
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((pallas_joint, "pallas_joint_generate"),
                          (pallas_window, "window_offsets_slab"),
                          (pallas_strategies,
                           "pallas_compose_strategies_run")):
            mp.setattr(mod, name,
                       functools.partial(getattr(mod, name), interpret=True))
        jax_chunk.clear_cache()
        out = jax_chunk(jax.tree.map(jnp.asarray, model), jax.random.key(SEED),
                        ids, anti, sim_days=SIM, buffer_days=BUF,
                        max_spells=plan_max_spells(model, SIM + BUF))
        out = {k: np.asarray(v) for k, v in out.items()}
    jax_chunk.clear_cache()
    return out


@pytest.fixture(scope="module")
def port_ref(model):
    """The port's chunk on the same trials, plain kernels on the CPU."""
    rows = torch.arange(B)
    out = slab_chunk_summaries(
        from_numpy(model, "cpu", torch.float64), rng.key(SEED), rows // 2,
        rows % 2 == 1, sim_days=SIM, buffer_days=BUF,
        max_spells=plan_max_spells(model, SIM + BUF))
    return {k: v.numpy() for k, v in out.items()}


def test_slab_chunk_matches_jax(port_ref, jax_ref):
    got = port_ref
    ref = jax_ref
    assert set(got) == set(ref) and len(got) == 13
    for k in ("start_offset", "start_regime", "regime_high_days"):
        assert got[k].dtype == ref[k].dtype, k
    k3.check_parity(got, ref,
                    exact=("start_offset", "start_regime",
                           "regime_high_days", "path_finite"),
                    at_most_one=("valid", "vix_ok", "repaired"))
    for k in ("liq_mean", "credit_mean"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4 / SIM,
                                   err_msg=k)
    for q in FANS:
        np.testing.assert_allclose(
            np.percentile(got["final_wealth"], q, axis=0),
            np.percentile(ref["final_wealth"], q, axis=0), rtol=5e-3,
            err_msg=f"p{q}")
    assert got["path_finite"].all() and 0.5 < got["valid"].mean() < 1.0


def test_report_matches_jax_reductions(model, jax_ref, port_ref,
                                       monkeypatch):
    """The port's pre-tax report on the same 1024 trials against numpy
    reductions of the JAX chunk (as tests/test_mc_runner.py:165 does for
    the JAX report), and exactly against the port's own raw arrays."""
    monkeypatch.setattr(tcfg, "RANDOM_START_BUFFER_YEARS", BUF / 252)
    rep = mc_runner.monte_carlo_report(
        model, SIM / 252, num_simulations=B, seed=SEED, chunk_size=B,
        tax_mode="none", device="cpu")
    own = port_ref
    pcts = rep["percentiles"]
    assert rep["n_trials"] == B
    for sid, k in cfg.STRATEGY_INDEX.items():
        got = rep["strategies"][sid]
        fan = [got["wealth"][f"p{p}"] for p in pcts]
        np.testing.assert_allclose(
            fan, np.percentile(own["final_wealth"][:, k], pcts), rtol=1e-6,
            err_msg=sid)
        np.testing.assert_allclose(
            fan, np.percentile(jax_ref["final_wealth"][:, k], pcts),
            rtol=5e-3, err_msg=sid)
        assert got["median_max_dd"] == pytest.approx(
            float(np.median(jax_ref["max_dd"][:, k])), rel=5e-3, abs=1e-4)
        assert got["trades_per_year"] == pytest.approx(
            float(np.mean(jax_ref["num_trades"][:, k])) / (SIM / 252),
            rel=1e-2, abs=1e-2)
        assert got["win_rate_vs_spy"] == pytest.approx(
            float(np.mean(jax_ref["final_wealth"][:, k]
                          > jax_ref["final_wealth"][:, 1])), abs=5e-3)
        assert got["ruin_frac"] == pytest.approx(
            float(np.mean(jax_ref["final_wealth"][:, k] <= 0)), abs=1e-3)
    assert rep["finite_frac"] == pytest.approx(
        float(jax_ref["path_finite"].mean()))
    for k in ("valid", "vix_ok", "repaired"):
        assert rep[f"{k}_frac"] == pytest.approx(
            float(jax_ref[k].mean()), abs=1.5 / B), k
    assert rep["valid_frac"] == pytest.approx(float(own["valid"].mean()))


def test_run_monte_carlo_chunking_is_bitwise(model, monkeypatch):
    """Trials replay from (seed, trial id): two chunks of 512 equal one
    chunk of 1024 bit for bit."""
    monkeypatch.setattr(tcfg, "RANDOM_START_BUFFER_YEARS", BUF / 252)
    kw = dict(num_simulations=B, seed=SEED, device="cpu")
    one = mc_runner.run_monte_carlo(model, SIM / 252, chunk_size=B, **kw)
    two = mc_runner.run_monte_carlo(model, SIM / 252, chunk_size=B // 2,
                                    **kw)
    for f in ("final_wealth", "num_trades", "max_dd", "valid", "repaired",
              "path_finite", "start_offset", "jump_days", "liq_mean",
              "regime_high_days", "trial_ids", "antithetic"):
        np.testing.assert_array_equal(getattr(one, f), getattr(two, f),
                                      err_msg=f)
    assert one.final_wealth.shape == (B, cfg.N_STRATEGIES)


def test_unported_modes_raise(model):
    """legacy_hybrid with bootstrap pools runs through run_monte_carlo and
    emit_trade_lists (held to the JAX package in
    tests/test_torch_bootstrap.py; the parametric modes:
    tests/test_torch_parametric_report.py; the sampled default:
    tests/test_torch_sampled_report.py; exact_all:
    tests/test_torch_exact_tax.py); trade emission is emit_trade_lists',
    not a run_monte_carlo argument, as in the JAX package; an unknown
    engine mode is a ValueError, a mesh that is not a TrialMesh a
    TypeError; a chunk budget under the containment returns the first
    chunk's trials."""
    pools = build_bootstrap_pools(
        generate_synthetic_history("2015-01-01", "2025-12-31"))
    kw = dict(num_simulations=4, device="cpu", engine_mode="legacy_hybrid",
              bootstrap_pools=pools)
    arrays = mc_runner.run_monte_carlo(model, 0.25, progress=False, **kw)
    assert np.isfinite(arrays.final_wealth).all()
    trades = mc_runner.emit_trade_lists(model, 0.25, [0, 3], **kw)
    assert sorted(trades) == [0, 3]
    assert set(trades[0]) == set(cfg.TAXABLE_IDS)
    with pytest.raises(TypeError, match="emit_trades"):
        mc_runner.run_monte_carlo(model, 1, num_simulations=8,
                                  emit_trades=True, device="cpu")
    with pytest.raises(ValueError, match="engine_mode"):
        mc_runner.run_monte_carlo(model, 1, num_simulations=8,
                                  engine_mode="bootstrap", device="cpu")
    for entry in (mc_runner.run_monte_carlo, mc_runner.monte_carlo_report):
        with pytest.raises(TypeError, match="TrialMesh"):
            entry(model, 1, num_simulations=8, device="cpu", mesh=object())
    budget = mc_runner.run_monte_carlo(model, 0.25, progress=False,
                                       chunk_size=2, max_chunks=1,
                                       fault_tolerant=True, **kw)
    np.testing.assert_array_equal(budget.final_wealth,
                                  arrays.final_wealth[:2])
    assert not budget.chunk_failed.any()
