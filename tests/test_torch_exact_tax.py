"""The port's exact-tax report (tax_mode="exact_all") against the JAX
package's, and the bridge's FIFO oracles against its merged form.

The JAX package's ``exact_post_tax_all_trials`` and ``monte_carlo_report``
run here on the port's own emission: its chunk function
(``letf_tpu.parallel.mc_runner._mc_chunk``) is replaced, for the test, by
one that returns the port's general-path emission of the same trials in
float64, so the two hold the same chunking, strategy fold, bridge, tax,
finiteness gate and percentiles to rtol 1e-9 (the tolerance of
tests/test_torch_sampled_report.py). 16 trials, 1 year, float64 glue. The
six elected lot orders: tests/test_torch_exact_tax_lots.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import letf_tpu.parallel.mc_runner as jax_runner
from letf_tpu import config as cfg
from letf_tpu import reporting as jax_reporting
from letf_tpu.models.params import default_sim_model
from letf_tpu.tax import device_bridge as jax_bridge
from letf_tpu_torch import reporting
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.tax import device_bridge as bridge
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, SEED = 16, 9
PCTS = (10, 25, 50, 75, 90)
RTOL = 1e-9


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


def port_chunk(model, n=N):
    """The port's general-path summaries and emission of the first n
    trials (one chunk)."""
    run = mc_runner._Run(model, 1, n, SEED, device="cpu")
    ids, anti = mc_runner._trial_layout(n, run.use_antithetic)
    return mc_runner.general_chunk(run, ids, anti)


@pytest.fixture(scope="module")
def chunk(model):
    return port_chunk(model)


@pytest.fixture(scope="module")
def port_exact(model):
    """The port's exact path, FIFO, its own replay of the trials."""
    return reporting.exact_post_tax_all_trials(
        model, 1, N, seed=SEED, chunk_size=N, percentiles=PCTS,
        device="cpu")


def as_jax_chunk(summ, em):
    """A stand-in for the JAX package's _mc_chunk that returns the port's
    wealth and emission (float64, the asset ids as they are)."""
    fw = jnp.asarray(summ["final_wealth"].numpy())
    em = tuple(jnp.asarray(e.numpy() if e.dtype == torch.int8
                           else e.double().numpy()) for e in em)

    def _mc_chunk(model, key, trial_ids, antithetic, *args, **kw):
        assert kw.get("emit_trades") and len(trial_ids) == fw.shape[0]
        return {"final_wealth": fw}, em

    return _mc_chunk


def assert_tables_close(got, want, strategy_ids=cfg.TAXABLE_IDS):
    assert set(got) == set(want) == set(strategy_ids)
    for sid in strategy_ids:
        assert set(got[sid]) == set(want[sid]), sid
        for k, v in want[sid].items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[sid][k], v, rtol=RTOL,
                                           atol=1e-9, err_msg=f"{sid} {k}")
            else:
                assert got[sid][k] == v, (sid, k)


def test_exact_all_trials_match_jax(model, chunk, port_exact, monkeypatch):
    """FIFO, all 13 taxable strategies: the port's exact path (its own
    replay of the trials) against the JAX package's on the same
    emission."""
    got = port_exact
    monkeypatch.setattr(jax_runner, "_mc_chunk", as_jax_chunk(*chunk))
    want = jax_reporting.exact_post_tax_all_trials(
        model, 1, N, seed=SEED, chunk_size=N, percentiles=PCTS)
    assert_tables_close(got, want)
    for sid in cfg.TAXABLE_IDS:
        assert got[sid]["n_trials"] == N
        assert got[sid]["nonfinite_trials"] == 0
        assert got[sid]["exact_all_trials"] is True
    assert got["S7"]["median_tax"] > 0


def test_report_exact_all_matches_jax_report(model, chunk, monkeypatch):
    """monte_carlo_report(tax_mode="exact_all"): the post_tax tables and
    the top-level tax keys against the JAX package's report."""
    got = mc_runner.monte_carlo_report(model, 1, num_simulations=N,
                                       seed=SEED, tax_mode="exact_all",
                                       device="cpu")
    monkeypatch.setattr(jax_runner, "_mc_chunk", as_jax_chunk(*chunk))
    want = jax_runner.monte_carlo_report(model, 1, num_simulations=N,
                                         seed=SEED, chunk_size=N,
                                         tax_mode="exact_all")
    assert got["tax_mode"] == want["tax_mode"] == "exact_all"
    assert got["tax_config"] == want["tax_config"]
    assert got["post_tax_seconds"] > 0
    for sid, s in want["strategies"].items():
        if "post_tax" not in s:
            assert "post_tax" not in got["strategies"][sid]
            continue
        g, w = got["strategies"][sid]["post_tax"], s["post_tax"]
        assert set(g) == set(w), sid
        assert (g["n_sampled"], g["method"]) == (w["n_sampled"], w["method"])
        for table in ("wealth", "cagr"):
            assert list(g[table]) == list(w[table])
            np.testing.assert_allclose(list(g[table].values()),
                                       list(w[table].values()), rtol=RTOL,
                                       atol=1e-12, err_msg=f"{sid} {table}")
        np.testing.assert_allclose(g["median_tax"], w["median_tax"],
                                   rtol=RTOL, err_msg=sid)


def test_sampled_tables_equal_exact_at_small_n(model, chunk, port_exact):
    """With n <= MAX_TAX_SIMS every trial is sampled and the sampled
    tables' interpolation returns each trial's own exact tax, so on the
    same wealth (the general path's, which exact_all taxes) the sampled
    post-tax fans equal exact_all's percentiles, as
    tests/test_mc_runner.py:219 holds the reference's."""
    summ, _ = chunk
    run = mc_runner._Run(model, 1, N, SEED, device="cpu")
    sampled = reporting.sampled_post_tax_tables(
        model, summ["final_wealth"], 1, N, SEED, None, "institutional_v1",
        run.random_start_method, run.buffer_days, run.use_antithetic, PCTS,
        device="cpu")
    exact = port_exact
    for sid in cfg.TAXABLE_IDS:
        assert sampled[sid]["n_sampled"] == N
        for p in PCTS:
            np.testing.assert_allclose(
                sampled[sid]["wealth"][f"p{p}"], exact[sid][f"post_tax_p{p}"],
                rtol=RTOL, atol=1e-9, err_msg=f"{sid} p{p}")


def test_max_buy_events_matches_jax(chunk):
    _, em = chunk
    counts = []
    for col in range(len(cfg.TAXABLE_IDS)):
        cols = [e[:, :, col] for e in em]
        got = bridge.max_buy_events(*[c if c.dtype == torch.int8
                                      else c.double() for c in cols])
        want = jax_bridge.max_buy_events(*[
            jnp.asarray(c.numpy() if c.dtype == torch.int8
                        else c.double().numpy()) for c in cols])
        assert got == want, cfg.TAXABLE_IDS[col]
        counts.append(got)
    assert max(counts) > 1


def fifo_inputs(chunk, sid="S7", asset=0):
    """The pass-2 inputs of one strategy's bridge asset: (cs, cs_prev,
    price, cb, cb_prev, buy_q, basis_ps, orig, anybuy), [S, B] each."""
    _, em = chunk
    col = cfg.TAXABLE_IDS.index(sid)
    tr = bridge.replay_trades(*[e[:, :, col] if e.dtype == torch.int8
                                else e[:, :, col].double() for e in em])
    return pass2_inputs(tr["buy_sh"][asset], tr["sell_sh"][asset],
                        tr["price"])


def pass2_inputs(buy_q, sell_m, price):
    cb = torch.cumsum(buy_q, dim=0)
    cb_prev = cb - buy_q
    take = torch.minimum(sell_m, cb[-1:])
    cost1 = bridge._prefix_cost(take, cb_prev, buy_q, price)
    gl1 = sell_m * price - cost1
    loss1 = torch.where((sell_m > 0) & (gl1 < 0), -gl1, 0.0)
    dis, rep_off, has = bridge.wash_matching(loss1, sell_m, buy_q)
    cs, basis_ps, orig, anybuy = bridge._wash_unload(dis, rep_off, has,
                                                     buy_q, sell_m, price)
    return cs, cs - sell_m, price, cb, cb_prev, buy_q, basis_ps, orig, anybuy


def synthetic_fifo_inputs(B=8, S=300, seed=4):
    """Two year tiles of dense trading: buys on ~40% of days, sells that
    often liquidate many lots at once (band levels past the first)."""
    rng = np.random.default_rng(seed)
    buy = np.where(rng.random((S, B)) < 0.4, rng.random((S, B)) * 10, 0.0)
    sell = np.where(rng.random((S, B)) < 0.15, rng.random((S, B)) * 30, 0.0)
    held = np.cumsum(buy - sell, axis=0)
    sell = np.where(held < 0, 0.0, sell)
    price = np.exp(np.cumsum(rng.standard_normal((S, B)) * 0.03, axis=0))
    return pass2_inputs(*(torch.as_tensor(a) for a in (buy, sell, price)))


@pytest.mark.parametrize("case", ["S7", "S8_spy", "synthetic"])
def test_fifo_oracles_match_merge(chunk, case):
    """The banded frontier (default band, and a band of 4 lots that needs
    many levels) and the dense pairing equal the merged form, and each
    equals its JAX original on the same inputs."""
    if case == "synthetic":
        args = synthetic_fifo_inputs()
    else:
        args = fifo_inputs(chunk, *(("S8", 1) if case == "S8_spy"
                                    else ("S7", 0)))
    cs, cs_prev, price, cb, cb_prev, buy_q, basis_ps, orig, anybuy = args
    S = price.shape[0]
    Y = -(-S // 252)
    merged = bridge._fifo_year_buckets_merge(cs, price, cb, basis_ps, orig,
                                             anybuy, Y).numpy()
    dense = bridge._fifo_year_buckets_dense(*args, Y).numpy()
    banded = bridge._fifo_year_buckets(*args, Y).numpy()
    narrow = bridge._fifo_year_buckets(*args, Y, band=4).numpy()
    assert np.abs(dense).sum() > 0
    scale = np.abs(dense).max()
    for got in (merged, banded, narrow):
        np.testing.assert_allclose(got, dense, rtol=1e-9,
                                   atol=1e-9 * scale)
    jargs = [jnp.asarray(a.numpy().T) for a in args]
    np.testing.assert_allclose(
        dense, np.asarray(jax_bridge._fifo_year_buckets_dense(*jargs, Y)),
        rtol=1e-12, atol=1e-12 * scale)
    for band, got in ((768, banded), (4, narrow)):
        np.testing.assert_allclose(
            got, np.asarray(jax_bridge._fifo_year_buckets(*jargs, Y,
                                                          band=band)),
            rtol=1e-12, atol=1e-12 * scale)


def poisoned(chunk, sid="S7", trial=3):
    """The chunk with one trial of one strategy made non-finite: an
    infinite portfolio value on a day it holds TQQQ, so the replay buys
    infinitely many shares."""
    summ, em = chunk
    col = cfg.TAXABLE_IDS.index(sid)
    alloc, value, _, asset = em
    day = int(np.flatnonzero((alloc[:, trial, col] > 0).numpy()
                             & (asset[:, trial, col] == bridge.IDX_TQQQ)
                             .numpy())[5])
    value = value.clone()
    value[day, trial, col] = float("inf")
    return summ, (alloc, value, em[2], asset)


def test_on_nonfinite_raise_and_record(model, chunk, monkeypatch):
    """A trial made non-finite on purpose: "raise" names the strategy and
    the chunk; "record" drops it and counts it, as the JAX package
    does."""
    bad = poisoned(chunk)
    monkeypatch.setattr(mc_runner, "general_chunk", lambda *a, **k: bad)
    kw = dict(seed=SEED, chunk_size=N, percentiles=PCTS)
    with pytest.raises(FloatingPointError, match=r"S7: 1 trial.*\[0, 16\)"):
        reporting.exact_post_tax_all_trials(model, 1, N, device="cpu", **kw)
    got = reporting.exact_post_tax_all_trials(
        model, 1, N, on_nonfinite="record", device="cpu", **kw)
    assert got["S7"]["nonfinite_trials"] == 1
    assert got["S7"]["n_trials"] == N - 1
    assert all(got[s]["nonfinite_trials"] == 0
               for s in cfg.TAXABLE_IDS if s != "S7")
    monkeypatch.setattr(jax_runner, "_mc_chunk", as_jax_chunk(*bad))
    want = jax_reporting.exact_post_tax_all_trials(
        model, 1, N, on_nonfinite="record", **kw)
    assert_tables_close(got, want)


def test_exact_all_argument_errors(model):
    with pytest.raises(TypeError, match="TrialMesh"):
        reporting.exact_post_tax_all_trials(model, 1, 8, mesh=object(),
                                            device="cpu")
    with pytest.raises(ValueError, match="on_nonfinite"):
        reporting.exact_post_tax_all_trials(model, 1, 8, device="cpu",
                                            on_nonfinite="skip")
    with pytest.raises(ValueError, match="lot_method"):
        reporting.exact_post_tax_all_trials(model, 1, 8, device="cpu",
                                            lot_method="AVG")
