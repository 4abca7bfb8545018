"""The port's results-list API and its summary statistics against the JAX
package's, on the CPU (modelled on tests/test_mc_runner.py's results-list,
regime-path, antithetic and Trade_Replay tests).

- ``parallel_monte_carlo_fixed`` (8-16 trials x 1 y): the reference schema,
  antithetic pairs sharing a base id, ``include_regime_paths`` (each path
  equal to the JAX package's ``emit_regime_paths``, exactly, and summing
  to the trial's regime-1 days), start offsets equal to the JAX
  package's draws, and the ``Trade_Replay`` route at
  ``trade_list_limit=4``: the sampled taxes of replayed trials equal those
  of attached trade lists (rtol 1e-9; the same trials, the same host
  chain), the exact-all taxes through the device bridge equal the host
  bridge's within rtol 1e-6, atol $1 (tests/test_mc_runner.py:356's
  bound), and a result with neither raises.
- ``emit_regime_paths`` (offset and regime-only starts) and
  ``build_anchor_conditions``: exactly the JAX package's.
- ``create_summary_statistics`` (and ``_tax_all_trials``) on the SAME
  results list (the port's, 64 trials x 1 y with trade lists: above the 50
  sampled trials, so the interpolation runs), sampled and exact-all:
  every Roth and taxable number equal to the JAX package's at rtol 1e-12,
  and the printed tables equal.
- ``estimate_tax_simple``, ``explain_percentile`` and
  ``get_tax_config_interactive`` (its defaults, and the menu on fed
  answers) equal the originals.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from letf_tpu import reporting as jreporting
from letf_tpu.models.params import build_sim_model as jbuild
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu.ops.path_batched import start_offsets_only
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import reporting
from letf_tpu_torch.data import generate_synthetic_history
from letf_tpu_torch.parallel import mc_runner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TC = dict(reporting.DEFAULT_TAX_CONFIG)


@pytest.fixture(scope="module")
def small():
    """Results lists of 12 trials x 1 y of S1, S2, S7, S19: trade lists
    attached, and the same run above a trade_list_limit of 4 with the
    regime paths."""
    kw = dict(strategy_ids=["S1", "S2", "S7", "S19"], time_horizon=1,
              regime_model=None, num_simulations=12, seed=3, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        return (mc_runner.parallel_monte_carlo_fixed(**kw),
                mc_runner.parallel_monte_carlo_fixed(
                    trade_list_limit=4, include_regime_paths=True, **kw))


@pytest.fixture(scope="module")
def wide():
    """All 19 strategies, 64 trials x 1 y with trade lists (seed 5)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return mc_runner.parallel_monte_carlo_fixed(
            list(tcfg.STRATEGIES), 1, None, num_simulations=64, seed=5,
            device="cpu")


def test_reference_format_results(small):
    mc, replay = small
    assert set(mc) == {"S1", "S2", "S7", "S19"}
    assert len(mc["S1"]) == 12
    r = mc["S1"][0]
    for key in ("Final_Wealth", "Num_Trades", "Trades_Per_Year", "Max_DD",
                "Metadata"):
        assert key in r
    meta = r["Metadata"]
    assert meta["regime_counts"][0] + meta["regime_counts"][1] == 252
    assert set(meta) == {"model_version", "sim_id", "antithetic",
                         "regime_counts", "start_method", "start_offset",
                         "layer_checks", "stress_summary"}
    assert "Trade_List" in mc["S7"][0] and "Trade_List" not in mc["S1"][0]
    t = mc["S7"][0]["Trade_List"][0]
    assert set(t) == {"day_index", "asset", "action", "shares", "price",
                      "dollar_amount"}
    assert r["Trades_Per_Year"] == r["Num_Trades"] / 1.0
    # Antithetic pairs share their base id.
    assert [x["Metadata"]["sim_id"] for x in mc["S2"]] == \
        [i // 2 for i in range(12)]
    assert [x["Metadata"]["antithetic"] for x in mc["S2"]] == \
        [bool(i % 2) for i in range(12)]
    # The start offsets are the JAX package's draws (seed 3, 5-year buffer).
    ref = np.asarray(start_offsets_only(
        jax.random.key(3), jnp.arange(12) // 2, 5 * 252))
    assert [x["Metadata"]["start_offset"] for x in mc["S1"]] == ref.tolist()
    # Above the limit: descriptors on taxable ids only, same wealth.
    assert "Trade_Replay" in replay["S7"][0]
    assert "Trade_List" not in replay["S7"][0]
    assert "Trade_Replay" not in replay["S2"][0]
    for sid in mc:
        assert [x["Final_Wealth"] for x in mc[sid]] == \
            [x["Final_Wealth"] for x in replay[sid]]


def test_regime_paths_opt_in_equal_the_reference(small):
    _, mc = small
    ref = jmc.emit_regime_paths(jbuild(None), 1, range(12), seed=3,
                                num_simulations=12)
    for i, r in enumerate(mc["S2"]):
        path = r["Regime_Path"]
        assert path.shape == (252,) and path.dtype == np.int8
        np.testing.assert_array_equal(path, ref[i])
        assert int((path == 1).sum()) == r["Regime_High_Days"]
        assert r["Regime_High_Days"] == r["Metadata"]["regime_counts"][1]


@pytest.mark.parametrize("method", ["offset", "regime_only"])
def test_emit_regime_paths_equal_the_reference(method):
    trials = [0, 3, 4, 9, 15]
    got = mc_runner.emit_regime_paths(None, 2, trials, seed=11,
                                      num_simulations=16,
                                      random_start_method=method,
                                      device="cpu")
    ref = jmc.emit_regime_paths(jbuild(None), 2, trials, seed=11,
                                num_simulations=16,
                                random_start_method=method)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int8 and got.shape == (5, 504)
    assert 0 < got.mean() < 1


def test_build_anchor_conditions_equal_the_reference():
    df = generate_synthetic_history("2000-01-01", "2006-12-31")
    pdf = pd.DataFrame({"VIX": df["VIX"]}, index=pd.DatetimeIndex(df.index))
    for years in (None, 1.5, 6.5):
        got = mc_runner.build_anchor_conditions(df, years)
        ref = jmc.build_anchor_conditions(pdf, years)
        if ref is None:
            assert got is None
            continue
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.asarray(b).dtype
    assert mc_runner.build_anchor_conditions(df, 6.5) is None


def test_trade_replay_above_trade_list_limit(small):
    with_trades, replay = small
    cache = {}

    def fresh(sid):      # the sampled route attaches the replayed lists
        return [dict(r) for r in replay[sid]]

    for sid in ("S7", "S19"):
        t_attached = reporting._tax_all_trials(with_trades[sid], 1, TC, sid)
        t_replayed = reporting._tax_all_trials(fresh(sid), 1, TC, sid)
        np.testing.assert_allclose(t_replayed, t_attached, rtol=1e-9)
        assert np.any(t_attached > 0)
        # Exact-all: the replay route (the device bridge: K7 and K8's plain
        # versions here) against the host bridge of the attached lists.
        x_attached = reporting._tax_all_trials(with_trades[sid], 1, TC, sid,
                                               exact_all=True)
        x_replayed = reporting._tax_all_trials(fresh(sid), 1, TC, sid,
                                               exact_all=True,
                                               replay_cache=cache)
        np.testing.assert_allclose(x_replayed, x_attached, rtol=1e-6,
                                   atol=1.0)
    bare = [{"Final_Wealth": 12000.0} for _ in range(8)]
    with pytest.raises(ValueError):
        reporting._tax_all_trials(bare, 1, TC, "S7")
    with pytest.raises(ValueError):
        reporting._tax_all_trials(bare, 1, TC, "S7", exact_all=True)


def test_replay_cache_shares_one_emission(small, monkeypatch):
    _, replay = small
    calls = []
    inner = mc_runner.general_chunk

    def counted(*a, **kw):
        calls.append(len(a[1]))
        return inner(*a, **kw)

    monkeypatch.setattr(mc_runner, "general_chunk", counted)
    cache = {}
    both = [reporting._tax_all_trials(replay[sid], 1, TC, sid,
                                      exact_all=True, replay_cache=cache)
            for sid in ("S7", "S19")]
    assert calls == [12]
    alone = reporting._tax_all_trials(replay["S19"], 1, TC, "S19",
                                      exact_all=True)
    np.testing.assert_array_equal(both[1], alone)


def assert_close(got, ref, path=""):
    """Dicts, lists, strings and numbers; floats within rtol 1e-12 (NaN
    where the reference is NaN)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            assert_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, str):
        assert got == ref, path
    else:
        g, r = float(got), float(ref)
        if math.isnan(r):
            assert math.isnan(g), path
        else:
            assert g == pytest.approx(r, rel=1e-12, abs=1e-9), (path, g, r)


@pytest.mark.parametrize("exact", [False, True])
def test_summary_statistics_equal_the_reference(wide, exact):
    tc = dict(TC, state="NJ", state_name="New Jersey", filing_status="married",
              ordinary_income=95_000)
    outs = []
    for mod in (reporting, jreporting):
        mc = {sid: [dict(r) for r in rows] for sid, rows in wide.items()}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summ = mod.create_summary_statistics(
                mc, 1, tax_config=tc, exact_tax_all_trials=exact)
        outs.append((summ, buf.getvalue()))
    (got, text), (ref, ref_text) = outs
    assert len(ref["roth"]) == 6 and len(ref["taxable"]) == 13
    assert_close(got, ref)
    assert text == ref_text
    taxes = [reporting._tax_all_trials(wide["S7"], 1, tc, "S7", exact),
             jreporting._tax_all_trials(wide["S7"], 1, tc, "S7", exact)]
    np.testing.assert_allclose(taxes[0], taxes[1], rtol=1e-12, atol=1e-9)
    assert np.all(taxes[0] >= 0) and np.any(taxes[0] > 0)


def test_estimates_and_scenarios_equal_the_originals():
    for gains in (-5.0, 0.0, 1e4, 3e5):
        for income in (5e4, 2.5e5, 7e5):
            for state in reporting.STATE_TAX_INFO:
                for filing in ("single", "married"):
                    args = (gains, income, state, filing)
                    assert reporting.estimate_tax_simple(*args) == \
                        jreporting.estimate_tax_simple(*args)
    for p in (10, 25, 40, 50, 60, 75, 90):
        assert reporting.explain_percentile(p, 3.2, 20, -1.5) == \
            jreporting.explain_percentile(p, 3.2, 20, -1.5)


@pytest.mark.parametrize("answers", [
    (),
    ("2", "$1,200,000", "2", "3", "12", "80,000"),
    ("9", "abc", "1", "", "x", ),
    ("", "", "", "1", "7", "lots"),
])
def test_tax_menu_equals_the_original(monkeypatch, answers):
    outs = []
    for mod in (reporting, jreporting):
        if answers:
            monkeypatch.delenv("LETF_NON_INTERACTIVE", raising=False)
            monkeypatch.delenv("LETF_NONINTERACTIVE", raising=False)
            monkeypatch.setattr("sys.stdin.isatty", lambda: True)
            feed = iter(answers + ("",) * 8)
            monkeypatch.setattr("builtins.input", lambda *_: next(feed))
        else:
            monkeypatch.setenv("LETF_NON_INTERACTIVE", "1")
        with contextlib.redirect_stdout(io.StringIO()):
            outs.append(mod.get_tax_config_interactive())
    assert outs[0] == outs[1]
