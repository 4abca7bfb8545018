"""The port's host tax chain against the JAX package's, on the CPU.

Each module is a copy (host Python and numpy), so each is held EXACTLY to
its original (``==`` on floats, dicts and event lists):

- ``tax/lot_selection.py``: the seven selectors through ``get_lots_to_sell``
  (and SPEC_ID, and MINTAX without a price) on random position lists;
- ``tax/wash_sale.py``: ``WashSaleTracker`` on a hand-built trade list (a
  buy, a partial sell, a loss sale with a replacement buy inside 30 days,
  a long-term sell: the ST/LT split, the disallowance, the basis
  adjustment, the holding-period tacking) and on the port's
  ``emit_trade_lists`` output;
- ``tax/marginal.py``: ``calculate_comprehensive_tax_v6`` over a grid of
  incomes, gains, states, filings and bracket multipliers, with
  ``calculate_marginal_tax``, ``calculate_ltcg_tax_stacked`` and
  ``piecewise_tax``;
- ``tax/regimes.py``: ``monte_carlo_tax_regimes`` and
  ``get_system_guarantees``;
- ``integration.py`` (``process_trades_with_wired_engine`` under every lot
  election and loss strategy, ``process_monte_carlo_with_wired_engine``,
  ``generate_ultimate_report``) and ``tax/vectorized.py``'s
  ``yearly_activity_from_trades``, on the same trade lists.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

from letf_tpu import integration as jintegration
from letf_tpu.tax import engine as jengine
from letf_tpu.tax import lot_selection as jlots
from letf_tpu.tax import marginal as jmarginal
from letf_tpu.tax import regimes as jregimes
from letf_tpu.tax import vectorized as jvectorized
from letf_tpu.tax import wash_sale as jwash
from letf_tpu_torch import config as tcfg
from letf_tpu_torch import integration
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.tax import engine, lot_selection, marginal, regimes
from letf_tpu_torch.tax import vectorized, wash_sale
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HAND_TRADES = [
    # buy 100 @ 50 (day 3), partial sell 40 @ 60 (gain, short term)
    {"day_index": 3, "asset": "TQQQ", "action": "BUY", "shares": 100.0,
     "price": 50.0, "dollar_amount": 5000.0},
    {"day_index": 20, "asset": "TQQQ", "action": "SELL", "shares": 40.0,
     "price": 60.0, "dollar_amount": 2400.0},
    # loss sale of 60 @ 40 with a replacement buy of 30 ten days later:
    # half the loss disallowed, added to the replacement's basis, its
    # holding period tacked to day 3
    {"day_index": 100, "asset": "TQQQ", "action": "SELL", "shares": 60.0,
     "price": 40.0, "dollar_amount": 2400.0},
    {"day_index": 110, "asset": "TQQQ", "action": "BUY", "shares": 30.0,
     "price": 42.0, "dollar_amount": 1260.0},
    # a second asset: bought in year 0, sold long term in year 2
    {"day_index": 5, "asset": "SPY", "action": "BUY", "dollar_amount": 8000.0,
     "price": 400.0},
    {"day_index": 600, "asset": "SPY", "action": "SELL",
     "dollar_amount": 9000.0, "price": 450.0},
    # the replacement lot sold at a gain in year 1 (tacked: long term)
    {"day_index": 400, "asset": "TQQQ", "action": "SELL", "shares": 30.0,
     "price": 55.0, "dollar_amount": 1650.0},
]


def elections(mod, lot="FIFO", loss="MINIMIZE_ST_FIRST"):
    return mod.TaxpayerElections(
        capital_loss_strategy=mod.CapitalLossUsageStrategy[loss],
        lot_selection_method=mod.LotSelectionMethod[lot])


@pytest.fixture(scope="module")
def trade_lists():
    """The port's reference-format trade lists of 8 trials x 1 year
    (default model, seed 3), as ``parallel_monte_carlo_fixed`` attaches
    them: {trial: {sid: [trade dicts]}}."""
    return mc_runner.emit_trade_lists(None, 1, range(8), seed=3,
                                      num_simulations=8, device="cpu")


def all_lists(trade_lists):
    out = [HAND_TRADES]
    for per_sid in trade_lists.values():
        out += [t for t in per_sid.values() if t]
    assert len(out) > 40
    return out


def test_trades_from_emission_equals_the_original():
    """The journal replay on random emission: NaN (no-trade) days,
    non-positive prices, changes under 0.001 shares, several assets a
    column, float32 and float64 columns."""
    from letf_tpu.strategies.host import trades_from_emission as jtrades
    from letf_tpu_torch.strategies.host import trades_from_emission

    g = np.random.default_rng(8)
    S, B, C = 600, 3, 4
    for dt in (np.float32, np.float64):
        alloc = np.where(g.random((S, B, C)) < 0.7, g.random((S, B, C)),
                         np.nan).astype(dt)
        alloc[100:140] = alloc[99]             # repeated targets: tiny changes
        value = (1e4 * np.exp(np.cumsum(g.normal(0, 0.02, (S, B, C)), 0))
                 ).astype(dt)
        price = (50 * np.exp(np.cumsum(g.normal(0, 0.02, (S, B, C)), 0))
                 ).astype(dt)
        price[g.random((S, B, C)) < 0.02] = 0.0
        asset = g.integers(0, 6, (S, B, C)).astype(np.int8)
        n = 0
        for b in range(B):
            for c in range(C):
                got = trades_from_emission(alloc, value, price, asset, b, c)
                assert got == jtrades(alloc, value, price, asset, b, c)
                n += len(got)
        assert n > 1000


def random_positions(g, n):
    return [{"shares": float(g.choice([0.0, 0.0005, g.uniform(0.1, 50)])),
             "adjusted_price": float(g.uniform(10, 100)),
             "original_day": int(g.integers(0, 800))} for _ in range(n)]


@pytest.mark.parametrize("method", list(engine.LotSelectionMethod))
def test_lot_selectors_equal_the_originals(method):
    g = np.random.default_rng(17)
    jmethod = jengine.LotSelectionMethod(method.value)
    for _ in range(60):
        pos = random_positions(g, int(g.integers(0, 12)))
        need = float(g.uniform(0, 120))
        day = int(g.integers(0, 1200))
        for price in (None, float(g.uniform(10, 100))):
            got = lot_selection.get_lots_to_sell(pos, need, method, day,
                                                 price)
            ref = jlots.get_lots_to_sell(pos, need, jmethod, day, price)
            assert got == ref, (method, pos, need, day, price)


def tracker_state(t):
    return dict(
        events=[dataclasses.asdict(e) for e in t.wash_sale_events],
        disallowed=dict(t.disallowed_losses), allowed=dict(t.allowed_losses),
        basis={a: dict(v) for a, v in t.basis_adjustments.items()},
        holding={a: dict(v) for a, v in t.holding_period_adjustments.items()},
        tacked={a: dict(v) for a, v in t.tacked_shares.items()},
        dis_year={a: dict(v) for a, v in t.disallowed_by_year.items()},
        all_year={a: dict(v) for a, v in t.allowed_by_year.items()},
        chains={c: [dataclasses.asdict(e) for e in v]
                for c, v in t.wash_sale_chains.items()},
        tainted={a: dict(v) for a, v in t.tainted_lots.items()},
        summary=t.get_wash_sale_summary(),
        cross=t.get_cross_year_summary())


def run_tracker(mod, trades):
    t = mod.WashSaleTracker(days_per_year=252)
    for tr in trades:
        t.record_trade(tr["asset"], tr["day_index"], tr["action"],
                       tr["shares"] if "shares" in tr
                       else tr["dollar_amount"] / tr["price"], tr["price"])
    t.process_all_wash_sales()
    return t


def test_wash_sale_tracker_on_the_hand_built_list():
    got, ref = (run_tracker(m, HAND_TRADES) for m in (wash_sale, jwash))
    assert tracker_state(got) == tracker_state(ref)
    # The loss sale (day 100: 60 shares, basis 50, at 40) finds the day-110
    # buy of 30: half the $600 loss is disallowed and goes to that lot's
    # basis, whose holding period starts on day 3.
    assert got.get_total_disallowed() == pytest.approx(300.0)
    assert got.get_basis_adjustment("TQQQ", 110) == pytest.approx(300.0)
    assert got.get_holding_period_adjustment("TQQQ", 110) == 3
    assert got.get_tacked_shares("TQQQ", 110) == 30.0
    assert got.get_chain_info(1) == ref.get_chain_info(1)
    assert got.check_wash_sale("SPY", 580, -10.0, HAND_TRADES) == \
        ref.check_wash_sale("SPY", 580, -10.0, HAND_TRADES)


def test_wash_sale_tracker_on_emitted_trade_lists(trade_lists):
    events = 0
    for trades in all_lists(trade_lists):
        got, ref = (run_tracker(m, trades) for m in (wash_sale, jwash))
        assert tracker_state(got) == tracker_state(ref)
        events += len(got.wash_sale_events)
    assert events > 0


CHAIN_TRADES = [
    {"day_index": 0, "asset": "TQQQ", "action": "BUY", "shares": 10.0,
     "price": 100.0, "dollar_amount": 1000.0},
    # a loss in year 0 replaced in year 1: a cross-year event opens chain 1
    # and taints the day-260 lot
    {"day_index": 250, "asset": "TQQQ", "action": "SELL", "shares": 5.0,
     "price": 50.0, "dollar_amount": 250.0},
    {"day_index": 260, "asset": "TQQQ", "action": "BUY", "shares": 10.0,
     "price": 50.0, "dollar_amount": 500.0},
    # a loss whose consumed lots reach the tainted one (not the first),
    # replaced inside year 1: the chain carries on to the day-410 lot
    {"day_index": 400, "asset": "TQQQ", "action": "SELL", "shares": 15.0,
     "price": 40.0, "dollar_amount": 600.0},
    {"day_index": 410, "asset": "TQQQ", "action": "BUY", "shares": 5.0,
     "price": 41.0, "dollar_amount": 205.0},
]


def test_wash_sale_chain_reaches_a_later_consumed_lot():
    got, ref = (run_tracker(m, CHAIN_TRADES) for m in (wash_sale, jwash))
    assert tracker_state(got) == tracker_state(ref)
    assert [(e.sale_day, e.is_cross_year, e.chain_id)
            for e in got.wash_sale_events] == [(250, True, 1), (400, False, 1)]
    assert dict(got.tainted_lots["TQQQ"]) == {260: 1, 410: 1}


def random_trade_list(g, n_days=900):
    """A trade list of two assets over n_days: buys and sells of random
    size on random days (several a day at times), prices a random walk, so
    that losses, replacements inside 30 days, cross-year wash sales and
    chains of them all occur."""
    trades, held = [], {"TQQQ": 0.0, "SPY": 0.0}
    price = {"TQQQ": 50.0, "SPY": 400.0}
    for day in sorted(g.integers(0, n_days, int(n_days * 0.8)).tolist()):
        asset = "TQQQ" if g.random() < 0.8 else "SPY"
        price[asset] *= float(np.exp(g.normal(0, 0.05)))
        if held[asset] > 1 and g.random() < 0.5:
            sh = float(held[asset] * g.choice([0.3, 0.5, 1.0]))
            held[asset] -= sh
            trades.append({"day_index": day, "asset": asset,
                           "action": "SELL", "shares": sh,
                           "price": price[asset],
                           "dollar_amount": sh * price[asset]})
        else:
            sh = float(g.uniform(0.0005, 40))
            held[asset] += sh
            trades.append({"day_index": day, "asset": asset, "action": "BUY",
                           "shares": sh, "price": price[asset],
                           "dollar_amount": sh * price[asset]})
    return trades


@pytest.mark.parametrize("seed", range(4))
def test_long_random_lists_equal_the_original(seed):
    """Long lists (hundreds of trades over 3.5 years): the tracker's whole
    state and the wired engine's result under two elections equal the
    originals, chains and cross-year events included."""
    g = np.random.default_rng(seed)
    trades = random_trade_list(g)
    got, ref = (run_tracker(m, trades) for m in (wash_sale, jwash))
    assert tracker_state(got) == tracker_state(ref)
    assert got.get_cross_year_summary()["chains_count"] > 0
    assert len(got.wash_sale_events) > 20
    # A second processing pass accumulates on the first, in both.
    got.process_all_wash_sales()
    ref.process_all_wash_sales()
    assert tracker_state(got) == tracker_state(ref)
    for lot in ("FIFO", "HIFO", "LTFO"):
        kw = dict(trades=trades, time_horizon_years=4,
                  initial_capital=tcfg.INITIAL_CAPITAL)
        assert integration.process_trades_with_wired_engine(
            elections=elections(engine, lot), **kw) == \
            jintegration.process_trades_with_wired_engine(
                elections=elections(jengine, lot), **kw)


def test_comprehensive_tax_grid_equals_the_original():
    n = 0
    for state in ("CA", "NY", "TX", "WA", "NJ", "MA"):
        for filing in ("single", "married"):
            for income in (0.0, 45_000.0, 150_000.0, 620_000.0):
                for st, lt, ded in ((0.0, 0.0, 0.0), (12_000.0, 0.0, 0.0),
                                    (0.0, 80_000.0, 3000.0),
                                    (250_000.0, 900_000.0, 0.0)):
                    for mult in (1.0, 1.025 ** 7):
                        kw = dict(taxable_st=st, taxable_lt=lt,
                                  capital_loss_deduction=ded,
                                  ordinary_income=income,
                                  filing_status=filing,
                                  bracket_multiplier=mult, state_code=state)
                        assert (marginal.calculate_comprehensive_tax_v6(**kw)
                                == jmarginal.calculate_comprehensive_tax_v6(
                                    **kw)), kw
                        n += 1
    assert n == 384
    table = [(11_600, 0.10), (47_150, 0.12), (float("inf"), 0.37)]
    for x in (-5.0, 0.0, 9_000.0, 60_000.0, 2e6):
        assert marginal.calculate_marginal_tax(x, table, 14_600) == \
            jmarginal.calculate_marginal_tax(x, table, 14_600)
        assert marginal.calculate_ltcg_tax_stacked(x, 30_000.0, table) == \
            jmarginal.calculate_ltcg_tax_stacked(x, 30_000.0, table)
    lim = np.array([10.0, 50.0, np.inf])
    rates = np.array([0.1, 0.2, 0.3])
    x = np.array([-1.0, 5.0, 30.0, 400.0])
    np.testing.assert_array_equal(marginal.piecewise_tax(x, lim, rates),
                                  jmarginal.piecewise_tax(x, lim, rates))
    assert marginal.test_ltcg_stacking() and jmarginal.test_ltcg_stacking()


def test_tax_regimes_equal_the_originals():
    for seed in (0, 5):
        got = regimes.monte_carlo_tax_regimes(
            30_000.0, 12_000.0, 8_000.0, 20_000.0, 1_000.0, 500.0,
            elections(engine), n_samples=200, seed=seed)
        ref = jregimes.monte_carlo_tax_regimes(
            30_000.0, 12_000.0, 8_000.0, 20_000.0, 1_000.0, 500.0,
            elections(jengine), n_samples=200, seed=seed)
        assert got == ref
    assert regimes.get_system_guarantees() == jregimes.get_system_guarantees()
    assert [dataclasses.asdict(r) for r in regimes.TAX_REGIMES] == \
        [dataclasses.asdict(r) for r in jregimes.TAX_REGIMES]


@pytest.mark.parametrize("lot,loss", [
    ("FIFO", "MINIMIZE_ST_FIRST"), ("LIFO", "MAXIMIZE_CURRENT_YEAR"),
    ("HIFO", "MINIMIZE_LT_FIRST"), ("LOFO", "DEFER_TO_FUTURE"),
    ("LTFO", "MINIMIZE_ST_FIRST"), ("STFO", "MINIMIZE_ST_FIRST"),
    ("MINTAX", "MINIMIZE_ST_FIRST")])
def test_wired_engine_equals_the_original(trade_lists, lot, loss):
    tax_config = {"filing_status": "married", "state": "NY",
                  "ordinary_income": 210_000, "career_stage": "mid",
                  "years_until_retirement": 1}
    for trades in all_lists(trade_lists):
        for years in (1, 3):
            kw = dict(trades=trades, time_horizon_years=years,
                      initial_capital=tcfg.INITIAL_CAPITAL,
                      tax_config=tax_config)
            got = integration.process_trades_with_wired_engine(
                elections=elections(engine, lot, loss), **kw)
            ref = jintegration.process_trades_with_wired_engine(
                elections=elections(jengine, lot, loss), **kw)
            assert got == ref
            np.testing.assert_array_equal(
                vectorized.yearly_activity_from_trades(
                    trades, years, elections(engine, lot, loss)),
                jvectorized.yearly_activity_from_trades(
                    trades, years, elections(jengine, lot, loss)))
    assert integration.process_trades_with_wired_engine(
        [], 2, elections(engine), 1e4) == \
        jintegration.process_trades_with_wired_engine(
            [], 2, elections(jengine), 1e4)


def test_monte_carlo_batch_and_report_equal_the_originals(trade_lists):
    mc = {sid: [{"Final_Wealth": 9_000.0 + 700.0 * t + 13.0 * i,
                 "Trade_List": trade_lists[t][sid]}
                for t in range(8)]
          for i, sid in enumerate(tcfg.TAXABLE_IDS[:4])}
    mc["S1"] = [{"Final_Wealth": 8_000.0 + 900.0 * t} for t in range(8)]
    got = integration.process_monte_carlo_with_wired_engine(
        mc, 1, tcfg.INITIAL_CAPITAL)
    ref = jintegration.process_monte_carlo_with_wired_engine(
        mc, 1, tcfg.INITIAL_CAPITAL)
    assert got == ref
    outs = []
    for mod in (integration, jintegration):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.generate_ultimate_report(ref, tcfg.INITIAL_CAPITAL, 1)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1].replace("(TPU build)", "(PyTorch port)")
