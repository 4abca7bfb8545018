"""The port's host strategy oracle (``letf_tpu_torch/strategies/host.py``)
against the JAX package's (``letf_tpu/strategies/host.py``), and the
port's batched engine against the port's oracle, on the CPU in float64.

One path batch: the port's per-trial engine, default model, 3 trials of
2 years after a 2-year buffer (seed 0), float64.
- ``run_strategy_fixed`` for each of the 19 strategies on each trial's
  frame (``sim_df_from_path``), with the trial's regime path and with the
  regimes inferred from VIX: the equity curve and the trade count bitwise
  the JAX package's on the same values as a pandas frame, and for the 13
  taxable strategies the trade journal equal dict for dict.
- ``engine.run_all(emit_trades=True)`` against the oracle, as
  tests/test_strategies.py:98-140 hold the JAX package's engine: final
  wealth rel 1e-9, trade counts exact, drawdown atol 1e-10; the journal
  emission through ``trades_from_emission`` against the oracle's journal
  (days, assets and actions exact, shares rel 1e-6, prices rel 1e-9).
- ``run_all`` is ``compute_signals`` then ``run_strategies_batch``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.strategies import host as jhost
from letf_tpu_torch import config as cfg
from letf_tpu_torch.models.params import from_jax_model, from_numpy
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_engine import generate_paths_batch
from letf_tpu_torch.strategies import host
from letf_tpu_torch.strategies.engine import run_all, run_strategies_batch
from letf_tpu_torch.strategies.signals import compute_signals
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S = 3, 2 * 252


@pytest.fixture(scope="module")
def batch():
    mt = from_numpy(from_jax_model(default_sim_model()), "cpu",
                    torch.float64)
    path = generate_paths_batch(mt, rng.key(0), torch.arange(B),
                                torch.zeros(B, dtype=torch.bool),
                                sim_days=S, buffer_days=504)
    res = run_all(path, emit_trades=True)
    frames = [host.sim_df_from_path(path, b) for b in range(B)]
    pdfs = [pd.DataFrame({c: f[c] for c in f.columns}) for f in frames]
    regimes = [path.regime[:, b].numpy() for b in range(B)]
    return path, res, frames, pdfs, regimes


@pytest.mark.parametrize("sid", list(cfg.STRATEGIES))
def test_run_strategy_fixed_equals_jax(batch, sid):
    _, _, frames, pdfs, regimes = batch
    for df, pdf, regime in zip(frames, pdfs, regimes):
        for rp in (regime, None):
            journal, jjournal = host.TradeJournal(), jhost.TradeJournal()
            ec, nt = host.run_strategy_fixed(df, sid, rp,
                                             trade_journal=journal)
            jec, jnt = jhost.run_strategy_fixed(pdf, sid, rp,
                                                trade_journal=jjournal)
            assert isinstance(ec, np.ndarray) and ec.dtype == np.float64
            np.testing.assert_array_equal(ec, jec.to_numpy(), err_msg=sid)
            assert nt == jnt, sid
            assert journal.get_full_trades() == jjournal.get_full_trades()
            assert journal.get_summary() == jjournal.get_summary()
            if sid in cfg.TAXABLE_IDS and rp is not None:
                assert journal.trades or sid == "S8", sid


def test_costs_and_journal_rule_equal_jax():
    for regime in (0, 1, 2):
        for size in (0.0, 0.005, 0.3):
            assert host.compute_transaction_costs(-0.02, regime, 3.0, size) \
                == jhost.compute_transaction_costs(-0.02, regime, 3.0, size)
    journal, jjournal = host.TradeJournal(), jhost.TradeJournal()
    for j in (journal, jjournal):
        j.log_allocation_change(3, "TQQQ", 0.0, 0.5, 10_000.0, 40.0)
        j.log_allocation_change(4, "TQQQ", 0.5, 0.5 + 1e-7, 10_000.0, 40.0)
        j.log_allocation_change(5, "TQQQ", 0.5, 0.2, 11_000.0, 44.0)
        j.log_allocation_change(6, "SPY", 0.0, 1.0, 9_000.0, 0.0)
    assert journal.get_full_trades() == jjournal.get_full_trades()
    assert [t["action"] for t in journal.get_full_trades()] == ["BUY",
                                                                "SELL"]


@pytest.mark.parametrize("trial", range(B))
def test_batched_engine_matches_host_oracle(batch, trial):
    path, res, frames, _, regimes = batch
    df, regime = frames[trial], regimes[trial]
    for k, sid in enumerate(cfg.STRATEGY_IDS):
        ec, nt = host.run_strategy_fixed(df, sid, regime)
        hm = np.maximum.accumulate(ec)
        hdd = float(np.abs((ec - hm) / np.where(hm > 0, hm, 1)).max())
        assert float(res.final_wealth[trial, k]) == pytest.approx(
            float(ec[-1]), rel=1e-9), sid
        assert int(res.num_trades[trial, k]) == nt, sid
        assert float(res.max_dd[trial, k]) == pytest.approx(hdd,
                                                            abs=1e-10), sid


@pytest.mark.parametrize("trial", range(B))
def test_trade_emission_matches_host_journal(batch, trial):
    _, res, frames, _, regimes = batch
    em = [t.numpy() for t in (res.tj_alloc, res.tj_value, res.tj_price,
                              res.tj_asset)]
    for col, sid in enumerate(cfg.TAXABLE_IDS):
        journal = host.TradeJournal()
        host.run_strategy_fixed(frames[trial], sid, regimes[trial],
                                trade_journal=journal)
        want = journal.get_full_trades()
        got = host.trades_from_emission(*em, trial, col)
        assert len(got) == len(want), sid
        for d, h in zip(got, want):
            assert (d["day_index"], d["asset"], d["action"]) == \
                (h["day_index"], h["asset"], h["action"]), sid
            assert d["shares"] == pytest.approx(h["shares"], rel=1e-6), sid
            assert d["price"] == pytest.approx(h["price"], rel=1e-9), sid


def test_run_all_is_signals_then_batch(batch):
    path, res, _, _, _ = batch
    ref = run_strategies_batch(path, compute_signals(path), emit_trades=True)
    for a, b in zip(res, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    pre = run_all(path)
    assert pre.tj_alloc is None
    np.testing.assert_array_equal(pre.num_trades.numpy(),
                                  res.num_trades.numpy())
