"""The port's copy of the tax engine's statute surface against the JAX
package's: the golden gate passes, every golden case and
hypothesis-made input to ``compute_capital_gains`` gives exactly the JAX
package's result, and ``net_capital_gains_array`` on torch tensors equals
the JAX package's on jax arrays bit for bit (float64)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from letf_tpu.tax import engine as jengine
from letf_tpu_torch.tax import engine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STRATEGIES = list(engine.CapitalLossUsageStrategy)


def to_jax(strategy):
    return jengine.CapitalLossUsageStrategy(strategy.value)


def test_golden_gate_passes(capsys):
    got = engine.run_golden_tests(trace_failures=True)
    assert got == jengine.run_golden_tests(trace_failures=True)
    assert got["passed"] == got["total"] == 6
    assert "RESULTS: 6/6 passed" in capsys.readouterr().out


def test_golden_cases_and_types_equal_the_reference():
    assert len(engine.GOLDEN_TESTS) == len(jengine.GOLDEN_TESTS)
    for a, b in zip(engine.GOLDEN_TESTS, jengine.GOLDEN_TESTS):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("election_strategy").value == \
            db.pop("election_strategy").value
        assert da == db
        assert a.run() == b.run()
    for name in ("RuleBasis", "CapitalLossUsageStrategy",
                 "LotSelectionMethod", "AMTCreditTiming"):
        assert [(m.name, m.value) for m in getattr(engine, name)] == \
            [(m.name, m.value) for m in getattr(jengine, name)], name
    for name in ("TaxRule", "TaxpayerElections", "CapitalGainsResult",
                 "GoldenTestCase"):
        assert [f.name for f in dataclasses.fields(getattr(engine, name))] \
            == [f.name for f in dataclasses.fields(getattr(jengine, name))]
    e = engine.TaxpayerElections()
    assert (e.capital_loss_strategy.name, e.amt_credit_timing.name,
            e.lot_selection_method.name) == ("MINIMIZE_ST_FIRST",
                                             "USE_IMMEDIATELY", "FIFO")


def test_a_broken_engine_fails_the_gate(monkeypatch):
    monkeypatch.setattr(engine, "_SCALAR_XP", (max, min))
    with pytest.raises(RuntimeError, match="golden tax tests FAILED"):
        engine.run_golden_tests()


_money = hst.floats(0.0, 5e5, allow_nan=False)


@settings(max_examples=300, deadline=None)
@given(hst.tuples(*[_money] * 6), hst.sampled_from(STRATEGIES),
       hst.booleans())
def test_compute_capital_gains_equals_the_reference(amounts, strategy,
                                                    trace):
    got = engine.compute_capital_gains(
        *amounts, engine.TaxpayerElections(capital_loss_strategy=strategy),
        trace=trace)
    ref = jengine.compute_capital_gains(
        *amounts, jengine.TaxpayerElections(
            capital_loss_strategy=to_jax(strategy)), trace=trace)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


_row = hst.tuples(*[hst.sampled_from([0.0, 1.0, 1e3, 3e3, 2.5e4, 5e4])] * 6)


@settings(max_examples=20, deadline=None)
@given(hst.lists(_row, min_size=1, max_size=32), hst.sampled_from(STRATEGIES))
def test_net_capital_gains_array_equals_the_reference(rows, strategy):
    """Rows padded to 32 (one shape for the JAX package's eager ops); each
    array form equals the JAX package's bit for bit, with Python floats
    in some of the operands too."""
    cols = np.zeros((6, 32))
    cols[:, :len(rows)] = np.asarray(rows).T
    cols *= np.linspace(0.5, 1.5, 32)
    got = engine.net_capital_gains_array(
        *[torch.as_tensor(c) for c in cols], strategy)
    ref = jengine.net_capital_gains_array(
        *[jnp.asarray(c) for c in cols], to_jax(strategy))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mixed = engine.net_capital_gains_array(
        torch.as_tensor(cols[0]), 0.0, 5e3, 0.0, torch.as_tensor(cols[4]),
        0.0, strategy)
    mixed_ref = jengine.net_capital_gains_array(
        jnp.asarray(cols[0]), 0.0, 5e3, 0.0, jnp.asarray(cols[4]), 0.0,
        to_jax(strategy))
    for a, b in zip(mixed, mixed_ref):
        np.testing.assert_array_equal(np.broadcast_to(np.asarray(a), (32,)),
                                      np.broadcast_to(np.asarray(b), (32,)))
