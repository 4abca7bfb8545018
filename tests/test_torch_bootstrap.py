"""The port's block bootstrap (``legacy_hybrid`` with pools) against
``letf_tpu/models/bootstrap.py`` and the JAX package's legacy engine, on
the CPU in float64.

- The pools of ``generate_synthetic_history("1990-01-01", "2025-12-31")``
  (as tests/test_bootstrap.py:21-26 builds them) are the JAX package's
  bit for bit.
- ``rng.gumbel``'s uniforms are ``jax.random.gumbel``'s bit for bit (its
  default "low" mode); its two logs are torch's, an ulp from XLA's, so the
  values are held to the samplers' float64 bound (relative 4e-14) and the
  float32 one (2e-6).
- ``sample_bootstrap_returns`` on 6 trials (each its own key and regime
  path: all low, all high, spells, alternating months) over 756 days: with
  pools whose free columns carry a (regime, block, row) code, the stitched
  series and each day's chosen block row are the JAX package's bit for
  bit; with the noise blend, within relative 1e-13 (the t draws).
- The legacy engine (``generate_paths_batch``, ``run_monte_carlo``; 4
  trials x 1 year) against the JAX package's: paths within atol 1e-12,
  the runs within ``check_parity``'s bounds (the port's strategies are K4
  in float32), start offsets and regime days exactly.
- ``parallel_monte_carlo_fixed`` under ``SIM_ENGINE_MODE="legacy_hybrid"``
  builds the pools from its history into the port's cache and carries
  them into the trade lists; the reference-shaped
  ``sampled_post_tax_tables`` with the pools equals the JAX package's on
  the same wealth within rtol 2e-5 (the port's strategies in float32,
  as tests/test_torch_parametric_report.py holds them)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as jcfg
from letf_tpu import reporting as jrep
from letf_tpu.data import generate_synthetic_history as jax_history
from letf_tpu.models import bootstrap as jb
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import path_engine as jpe
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu.parallel.mesh import trial_mesh
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import reporting
from letf_tpu_torch.data import generate_synthetic_history
from letf_tpu_torch.models import bootstrap as tb
from letf_tpu_torch.models.params import from_jax_model, from_numpy
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import path_engine as tpe
from letf_tpu_torch.ops import rng
from letf_tpu_torch.parallel import mc_runner as tmc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_DAYS = 756
SERIES = ("SPY_Ret", "QQQ_Ret", "TLT_Ret", "VIX", "IRX")


@pytest.fixture(scope="module")
def pools():
    """(JAX pools, port pools) of the same synthetic history."""
    return (jb.build_bootstrap_pools(jax_history("1990-01-01", "2025-12-31")),
            tb.build_bootstrap_pools(generate_synthetic_history(
                "1990-01-01", "2025-12-31")))


@pytest.fixture(scope="module")
def models():
    jm = default_sim_model()
    return jm, from_numpy(from_jax_model(jm), "cpu", torch.float64)


def coded(p):
    """Pools whose columns that steer no choice (A's IRX, B's TLT) hold
    regime * 1e6 + block * 1000 + row: the stitched IRX and TLT series then
    name each day's block row in pools A and B."""
    a, b = p.a_data.copy(), p.b_data.copy()
    for data, c in ((a, 3), (b, 2)):
        R, N, L = data.shape[:3]
        data[..., c] = (np.arange(R)[:, None, None] * 1e6
                        + np.arange(N)[None, :, None] * 1000
                        + np.arange(L)[None, None, :])
    return p._replace(a_data=a, b_data=b)


def regime_cases():
    """Six regime paths [6, N_DAYS]: all low, all high, random spells (two
    seeds), alternating 21-day months, one long high spell."""
    r = np.zeros((6, N_DAYS), np.int32)
    r[1] = 1
    g = np.random.default_rng(0)
    for b in (2, 3):
        for _ in range(5):
            s = int(g.integers(0, N_DAYS - 100))
            r[b, s:s + int(g.integers(10, 200))] = 1
    r[4] = (np.arange(N_DAYS) // 21) % 2
    r[5, 300:600] = 1
    return r


@pytest.fixture(scope="module")
def sampled(pools):
    """Both packages' stitched series of the coded pools, without and with
    the noise blend, for 6 keys and regime_cases()."""
    jp, tp = pools
    ks = jax.random.split(jax.random.key(3), 6)
    regs = regime_cases()
    out = {}
    for noise in (False, True):
        # The reference's jit has add_noise dynamic; unjitted, it is a
        # Python switch.
        fn = (jb.sample_bootstrap_returns if noise else functools.partial(
            jb.sample_bootstrap_returns.__wrapped__, add_noise=False))
        ref = jax.jit(jax.vmap(lambda k, r: fn(coded(jp), r, k,
                                                n_days=N_DAYS)))(
            ks, jnp.asarray(regs))
        got = tb.sample_bootstrap_returns(
            tb.pools_on(coded(tp), "cpu", torch.float64),
            torch.as_tensor(regs.T),
            torch.as_tensor(np.asarray(jax.random.key_data(ks)).astype(
                np.int64)), N_DAYS, add_noise=noise)
        out[noise] = ({k: np.asarray(ref[k]) for k in SERIES},
                      {k: got[k].numpy().T for k in SERIES})
    return out


def test_pools_bitwise(pools):
    jp, tp = pools
    for f in jb.BootstrapPools._fields:
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    # Pool A covers all history, B the real-QQQ era.
    assert tp.a_count.sum() > tp.b_count.sum() > 0
    assert tp.a_data.shape[2:] == (tcfg.BOOTSTRAP_BLOCK_SIZE, 4)


def test_create_bootstrap_sampler_caches_in_the_ports_directory(
        monkeypatch, tmp_path, pools):
    assert tcfg.BOOTSTRAP_CACHE.parent == tcfg.CACHE_DIR
    assert tcfg.CACHE_DIR != jcfg.CACHE_DIR
    monkeypatch.setattr(tcfg, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(tcfg, "BOOTSTRAP_CACHE", tmp_path / "bootstrap.pkl")
    df = generate_synthetic_history("1990-01-01", "2025-12-31")
    built = tb.create_bootstrap_sampler(df)
    assert (tmp_path / "bootstrap.pkl").exists()
    again = tb.create_bootstrap_sampler(None)          # from the cache
    for f in tb.BootstrapPools._fields:
        np.testing.assert_array_equal(getattr(again, f), getattr(built, f))
        np.testing.assert_array_equal(getattr(built, f),
                                      getattr(pools[1], f))


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-6),
                                        ("float64", 4e-14)])
def test_gumbel_matches_jax(dtype, rtol):
    """jax 0.9's default Gumbel mode is "low"; the uniforms on [tiny, 1)
    are bitwise, the values within the samplers' bound."""
    assert not jax.config.jax_high_dynamic_range_gumbel
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ks = jax.random.split(jax.random.key(7), 64)
    tk = torch.as_tensor(np.asarray(jax.random.key_data(ks)).astype(np.int64))
    tiny = float(np.finfo(dtype).tiny)
    u_ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (500,), jdt, minval=tiny, maxval=1.0))(ks))
    u = rng.uniform(tk, 500, tdt, minval=tiny)
    np.testing.assert_array_equal(u.numpy(), u_ref)
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (500,),
                                                          jdt))(ks))
    got = rng.gumbel(tk, 500, tdt).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


def test_sample_bootstrap_returns_bitwise(sampled):
    """Without the noise: every series bitwise, so every day's block row
    in both pools (the coded IRX and TLT) is the JAX package's."""
    ref, got = sampled[False]
    for k in SERIES:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rows = got["IRX"]
    # All-low and all-high paths draw from their regime's blocks only.
    assert (rows[0] // 1e6 == 0).all() and (rows[1] // 1e6 == 1).all()
    # Blocks change every 21-168 days, at least a few times a trial.
    switches = (np.diff(rows % 1e6 // 1000, axis=1) != 0).sum(1)
    assert (switches >= N_DAYS // 168).all(), switches


def test_sample_bootstrap_noise_blend_matches_jax(sampled):
    ref, got = sampled[True]
    for k in ("VIX", "IRX"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("SPY_Ret", "QQQ_Ret", "TLT_Ret"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-13, atol=1e-16,
                                   err_msg=k)
    assert not np.array_equal(got["SPY_Ret"], sampled[False][1]["SPY_Ret"])


def test_legacy_generate_paths_batch_matches_jax(models, pools):
    """generate_paths_batch(engine_mode="legacy_hybrid") on 4 trials x 1
    year (126-day buffer) against the JAX package's generate_path: every
    return within atol 1e-12, VIX within 1e-10, regimes exactly."""
    jm, mt = models
    jp, tp = pools
    ids, anti = np.arange(4) // 2, np.arange(4) % 2 == 1
    ref = jax.jit(jax.vmap(lambda i, a: jpe.generate_path(
        jm, jax.random.key(0), i, a, 252, 126, engine_mode="legacy_hybrid",
        bootstrap_pools=jp)))(jnp.asarray(ids), jnp.asarray(anti))
    got = tpe.generate_paths_batch(mt, rng.key(0), torch.as_tensor(ids),
                                   torch.as_tensor(anti), 252, 126,
                                   engine_mode="legacy_hybrid",
                                   bootstrap_pools=tp)
    np.testing.assert_allclose(got.etf_ret.numpy().transpose(2, 1, 0),
                               np.asarray(ref.etf_ret), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.vix.numpy().T, np.asarray(ref.vix),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.regime.numpy().T,
                                  np.asarray(ref.regime))
    # The parametric mode is another model.
    par = tpe.generate_paths_batch(mt, rng.key(0), torch.as_tensor(ids),
                                   torch.as_tensor(anti), 252, 126,
                                   engine_mode="parametric")
    assert not torch.equal(par.spy_ret, got.spy_ret)


def test_legacy_run_monte_carlo_matches_jax(monkeypatch, models, pools):
    """run_monte_carlo(engine_mode="legacy_hybrid", bootstrap_pools=...),
    4 trials x 1 year with a half-year start buffer, against the JAX
    package's (tests/test_bootstrap.py:93)."""
    for c in (jcfg, tcfg):
        monkeypatch.setattr(c, "RANDOM_START_BUFFER_YEARS", 0.5)
    jm, _ = models
    jp, tp = pools
    kw = dict(num_simulations=4, seed=0, engine_mode="legacy_hybrid",
              progress=False)
    ref = jmc.run_monte_carlo(jm, 1, mesh=trial_mesh(jax.devices()[:1]),
                              bootstrap_pools=jp, **kw)
    got = tmc.run_monte_carlo(jm, 1, bootstrap_pools=tp, device="cpu", **kw)
    k3.check_parity(vars(got), vars(ref),
                    exact=("start_offset", "start_regime", "regime_high_days",
                           "jump_days", "valid", "path_finite", "repaired",
                           "vix_ok"))
    np.testing.assert_allclose(got.liq_mean, ref.liq_mean, rtol=1e-12)
    par = tmc.run_monte_carlo(jm, 1, num_simulations=4, seed=0,
                              engine_mode="parametric", progress=False,
                              device="cpu")
    assert not np.array_equal(par.final_wealth, got.final_wealth)


def test_parallel_monte_carlo_fixed_legacy_carries_the_pools(
        monkeypatch, tmp_path, models, pools):
    """SIM_ENGINE_MODE="legacy_hybrid" with a history: the results list
    runs on pools built into the port's cache and its trade lists replay
    those paths; the reference-shaped sampled post-tax tables take the
    pools and equal the JAX package's on the same wealth."""
    monkeypatch.setattr(tcfg, "SIM_ENGINE_MODE", "legacy_hybrid")
    monkeypatch.setattr(tcfg, "RANDOM_START_BUFFER_YEARS", 0.5)
    monkeypatch.setattr(tcfg, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(tcfg, "BOOTSTRAP_CACHE", tmp_path / "bootstrap.pkl")
    jm, _ = models
    tp = pools[1]
    df = generate_synthetic_history("1990-01-01", "2025-12-31")
    res = tmc.parallel_monte_carlo_fixed(["S1", "S7"], 1, jm,
                                         historical_df=df, num_simulations=4,
                                         device="cpu")
    assert (tmp_path / "bootstrap.pkl").exists()
    arrays = tmc.run_monte_carlo(jm, 1, num_simulations=4,
                                 engine_mode="legacy_hybrid",
                                 bootstrap_pools=tp, progress=False,
                                 device="cpu")
    col = tcfg.STRATEGY_INDEX["S7"]
    np.testing.assert_array_equal(
        [r["Final_Wealth"] for r in res["S7"]], arrays.final_wealth[:, col])
    assert all(r["Metadata"]["model_version"] == "legacy_hybrid"
               for r in res["S1"])
    assert all("Trade_List" in r for r in res["S7"])
    run = tmc._Run(jm, 1, 4, 0, device="cpu")
    args = (1, 4, 0, None, "legacy_hybrid", run.random_start_method,
            run.buffer_days, run.use_antithetic, (10, 50, 90))
    post = reporting.sampled_post_tax_tables(
        jm, torch.as_tensor(arrays.final_wealth), *args, bootstrap_pools=tp,
        device="cpu")
    ref = jrep.sampled_post_tax_tables(
        jm, jnp.asarray(arrays.final_wealth), *args, bootstrap_pools=pools[0])
    assert sorted(post) == sorted(ref)
    for sid, e in post.items():
        assert e["n_sampled"] == 4
        np.testing.assert_allclose(
            [e["median_tax"]] + list(e["wealth"].values()),
            [ref[sid]["median_tax"]] + list(ref[sid]["wealth"].values()),
            rtol=2e-5, atol=1e-6, err_msg=sid)
