"""The emitting engine's day loops (``ops/emit_days.py``) on the CPU.

- ``run_strategies_batch(emit_trades=True)`` on CPU tensors runs the torch
  twin ``emit_days_plain`` (counted as ``plain_emit_rows``), never the
  kernel;
- ``emit_days`` refuses wrong shapes and a cashflow vector of the wrong
  length before any launch, on any device;
- the twin against a per-trial, per-strategy scalar transcription of the
  day loop in float64 (S19's threshold, S6's rebalance and sleeves, the
  day-0 cases, the cashflow overlay, the ruin floor, the drawdowns) at
  1, 2, 21, 22 and 64 days.

The kernel's own tests need a card: ``tests/test_torch_emit_days_cuda.py``.
"""

import numpy as np
import pytest
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models.params import default_sim_model, from_numpy
from letf_tpu_torch.ops import emit_days as ed
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_batched import generate_paths_batched
from letf_tpu_torch.strategies import engine
from letf_tpu_torch.strategies.signals import compute_signals
from letf_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS, N_TAX = ed.NS, ed.N_TAX


def day_inputs(S, B, seed, dtype=torch.float64, device="cpu"):
    """Synthetic emit_days inputs: returns of a few percent, S19
    candidates that cross the 5% threshold both ways, cash near 0,
    embedded leverages near 3."""
    g = np.random.default_rng(seed)
    ret_all = g.normal(0.0005, 0.03, (S, NS, B))
    cand19 = np.clip(np.cumsum(g.normal(0.0, 0.04, (S, B)), 0) + 0.8,
                     0.0, 1.5)
    rq, rm = g.normal(0.001, 0.04, (2, S, B))
    cash = np.full((S, B), 0.0001)
    emb0, emb1 = 3.0 + g.normal(0.0, 0.05, (2, S, B))
    return [torch.as_tensor(x, dtype=dtype, device=device)
            for x in (ret_all, cand19, rq, rm, cash, emb0, emb1)]


def cashflows(kind, S):
    if kind == "none":
        return None
    if kind == "dca":
        return engine.dca_schedule(S, 500.0)
    return engine.withdrawal_schedule(S, 120000.0)  # ruins in months


def scalar_days(ret_all, cand19, rq, rm, cash, emb0, emb1, cf, costs):
    """The day loop one (trial, strategy) at a time in Python floats."""
    S, _, B = ret_all.shape
    cf = np.zeros(S) if cf is None else cf
    cap, (w0, w1), (l0, l1) = ed.INITIAL_CAPITAL, ed.S6_W, ed.S6_LEV
    eq_out, mdd_out = np.zeros((NS, B)), np.zeros((NS, B))
    value, traded19 = np.zeros((S, N_TAX, B)), np.zeros((S, B), bool)
    for b in range(B):
        for s in range(NS):
            eq, run_max, mdd = cap, cap, 0.0
            g0, g1, a19 = cap * w0, cap * w1, 0.0
            for t in range(S):
                if s >= ed.TAX_OFFSET:
                    value[t, s - ed.TAX_OFFSET, b] = eq
                if s == ed.S6:
                    p0, p1 = g0 * (1 + rq[t, b]), g1 * (1 + rm[t, b])
                    new = p0 + p1
                    if t > 0 and t % 21 == 0:
                        c0, c1 = p0 / max(new, 1e-30), p1 / max(new, 1e-30)
                        turn = ((abs(c0 - w0) + abs(c1 - w1))
                                + (abs(emb0[t, b] - l0) / l0 * c0
                                   + abs(emb1[t, b] - l1) / l1 * c1))
                        if costs and turn > 0.01:
                            new *= 1 - turn * cfg.REBALANCE_COST_PER_DOLLAR
                        p0, p1 = new * w0, new * w1
                    if t == 0:
                        p0, p1, new = g0, g1, eq
                elif s == ed.S19:
                    turn = abs(cand19[t, b] - a19)
                    traded19[t, b] = turn > 0.05
                    alloc = cand19[t, b] if turn > 0.05 else a19
                    r = alloc * rq[t, b] + (1 - alloc) * cash[t, b]
                    if costs and turn > 0.05:
                        r -= turn * ed.SPREAD
                    if t > 0:
                        a19 = alloc
                    new = eq * (1 + (0.0 if t == 0 else r))
                else:
                    r = 0.0 if t == 0 and s >= 3 else ret_all[t, s, b]
                    new = eq * (1 + r)
                e = max(new + cf[t], 0.0)
                e = 0.0 if e < ed.FLT_MIN else e
                if s == ed.S6:
                    scale = e / max(new, 1e-30)
                    g0, g1 = p0 * scale, p1 * scale
                run_max = e if t == 0 else max(run_max, e)
                mdd = max(mdd, -(e - run_max) / (run_max if run_max > 0
                                                 else 1.0))
                eq = e
            eq_out[s, b], mdd_out[s, b] = eq, mdd
    return eq_out, mdd_out, value, traded19


@pytest.mark.parametrize("costs", [True, False])
@pytest.mark.parametrize("flows", ["none", "dca", "withdrawal"])
@pytest.mark.parametrize("S", [1, 2, 21, 22, 64])
def test_twin_is_the_scalar_day_loop(S, flows, costs):
    ins = day_inputs(S, 5, seed=S)
    cf = cashflows(flows, S)
    got = ed.emit_days(*ins, cashflows=cf, apply_costs=costs)
    want = scalar_days(*(x.numpy() for x in ins), cf, costs)
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=0)
    if flows == "withdrawal" and S == 64:
        assert (got[0] == 0).all()             # every strategy ruined


def test_cpu_engine_runs_the_twin():
    """The emitting engine on CPU tensors: the twin, counted as
    plain_emit_rows on the open span, and no kernel launch."""
    mt = from_numpy(default_sim_model(), "cpu", torch.float64)
    rows = torch.arange(12)
    path = generate_paths_batched(mt, rng.key(5, "cpu"), rows // 2,
                                  rows % 2 == 1, sim_days=40)
    sig = compute_signals(path)
    n0 = ed.LAUNCHES
    profiling.reset()
    with profiling.tracing(), profiling.span("strategies"):
        res = engine.run_strategies_batch(path, sig, emit_trades=True)
    (rec,) = [r for r in profiling.records() if r.name == "strategies"]
    assert rec.counters.get("plain_emit_rows") == 12
    assert "fused_emit_rows" not in rec.counters
    assert ed.LAUNCHES == n0
    dt = path.etf_ret.dtype
    assert res.tj_value.shape == (40, 12, N_TAX) and res.tj_value.dtype == dt
    # The journal's value is the equity before each day.
    assert torch.equal(res.tj_value[0], torch.full(
        (12, N_TAX), ed.INITIAL_CAPITAL, dtype=dt))


def _shapes(S=5, B=3):
    return [(S, NS, B), *[(S, B)] * len(ed.CHANNELS)]


BAD = {
    "ret_all strategies": ([(5, NS - 1, 3)] + _shapes()[1:], None),
    "ret_all rank": ([(5, NS * 3)] + _shapes()[1:], None),
    "no days": (_shapes(S=0), None),
    "cand19 days": (_shapes()[:1] + [(4, 3)] + _shapes()[2:], None),
    "emb1 trials": (_shapes()[:-1] + [(5, 2)], None),
    "cashflows short": (_shapes(), np.zeros(4)),
    "cashflows long": (_shapes(), np.zeros(6)),
    "cashflows 2-d": (_shapes(), np.zeros((5, 1))),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_wrong_shapes_before_any_launch(case, device):
    """Shapes and the cashflow length are checked before the device is
    looked at: a meta tensor (the CUDA branch's side) is refused as a CPU
    one is, with no launch and no library build."""
    shapes, cf = BAD[case]
    ins = [torch.zeros(s, dtype=torch.float32, device=device)
           for s in shapes]
    n0 = ed.LAUNCHES
    with pytest.raises(ValueError, match="emit_days"):
        ed.emit_days(*ins, cashflows=cf)
    assert ed.LAUNCHES == n0


def test_cuda_route_takes_only_float32(monkeypatch):
    """Past the shape checks a non-CPU tensor goes to the kernel, which
    takes float32 alone: float64 is refused before the library is
    loaded (a meta tensor stands in for the card)."""
    monkeypatch.setattr(ed._build, "library", lambda: pytest.fail(
        "the library was loaded"))
    ins = [torch.zeros(s, dtype=torch.float64, device="meta")
           for s in _shapes()]
    n0 = ed.LAUNCHES
    with pytest.raises(TypeError, match="emit_days: ret_all has dtype"):
        ed.emit_days(*ins)
    assert ed.LAUNCHES == n0
