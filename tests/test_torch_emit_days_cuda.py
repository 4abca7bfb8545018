"""The emitting day kernel (``csrc/emit_days.cu``) against its torch twin
on the card: ``ops/emit_days.emit_days`` on CUDA tensors launches the
kernel, ``emit_days_plain`` runs the twin's day loops on the same float32
tensors, and every output agrees bit for bit: final equity, max drawdown,
the journal's pre-day equities and S19's trade flags, over 1 to 4,096
trials and 1 to 7,560 days, with and without cashflows (DCA, withdrawals
that ruin) and costs, and on trials whose returns hold NaN and inf. Then
the emitting engine whole (``run_strategies_batch``), one
``general_chunk(emit=True)`` replay of 642 institutional rows at 30 years,
and the default 1,048,576 x 30 y report's sampled post-tax tables and
sample, each through the kernel and through the twin. Marked ``cuda``;
without a card every test skips (decided inside the fixture). Nothing here
needs JAX. On a GPU machine:
``python -m pytest -m cuda --noconftest tests/test_torch_emit_days_cuda.py``.
"""

import numpy as np
import pytest
import torch

from letf_tpu_torch.models.params import default_sim_model, from_numpy
from letf_tpu_torch.ops import emit_days as ed
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_batched import generate_paths_batched
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.strategies import engine
from letf_tpu_torch.strategies.signals import compute_signals
from letf_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

NS = ed.NS
OUTPUTS = ("equity", "max_dd", "value", "traded19")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def day_inputs(dev, S, B, seed, nonfinite=False):
    """float32 emit_days inputs on the card: returns of a few percent, S19
    candidates that cross the 5% threshold both ways, embedded leverages
    near 3; with ``nonfinite``, every fifth trial's returns turn NaN from a
    third of the way in, and inf, -inf and NaN land on single days of the
    channels."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(mean, sd, shape):
        return mean + sd * torch.randn(shape, generator=g, device=dev)

    ret_all = normal(0.0005, 0.03, (S, NS, B))
    cand19 = (0.8 + torch.cumsum(normal(0.0, 0.04, (S, B)), 0)).clamp(0, 1.5)
    rq, rm = normal(0.001, 0.04, (2, S, B))
    cash = normal(0.0001, 0.00002, (S, B))
    emb0, emb1 = normal(3.0, 0.05, (2, S, B))
    if nonfinite:
        bad = torch.arange(1, B, 5, device=dev)
        ret_all[S // 3:, :, bad] = float("nan")
        rq[S // 2, bad] = float("inf")
        rm[(2 * S) // 3, bad] = float("-inf")
        cand19[S // 4, bad] = float("nan")
        emb0[S - 1, bad] = float("nan")
    return [ret_all, cand19, rq, rm, cash, emb0, emb1]


def cashflows(kind, S):
    if kind == "none":
        return None
    if kind == "dca":
        return engine.dca_schedule(S, 500.0)
    return engine.withdrawal_schedule(S, 120000.0)   # ruins in months


def twin(ret_all, cand19, r_tqqq, r_tmf, cash, emb0, emb1, cashflows=None,
         apply_costs=True):
    """emit_days' signature on the twin, for CUDA tensors."""
    cf = (None if cashflows is None else torch.as_tensor(
        cashflows, dtype=ret_all.dtype, device=ret_all.device))
    return ed.emit_days_plain(ret_all, cand19, r_tqqq, r_tmf, cash, emb0,
                              emb1, cf, apply_costs)


def bitwise(name, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda, name
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        diff = a.contiguous().view(bits) != b.contiguous().view(bits)
    else:
        diff = a != b
    assert not diff.any(), (name, int(diff.sum()), a[diff][:4].tolist(),
                            b[diff][:4].tolist())


def launched(fn):
    n0 = ed.LAUNCHES
    out = fn()
    assert ed.LAUNCHES == n0 + 1
    return out


@pytest.mark.parametrize("costs", [True, False])
@pytest.mark.parametrize("flows", ["none", "dca", "withdrawal"])
@pytest.mark.parametrize("S", [1, 2, 21, 22, 2520, 7560])
@pytest.mark.parametrize("B", [1, 37, 642, 4096])
def test_kernel_is_the_twin(dev, B, S, flows, costs):
    ins = day_inputs(dev, S, B, seed=S * 7 + B)
    cf = cashflows(flows, S)
    got = launched(lambda: ed.emit_days(*ins, cashflows=cf,
                                        apply_costs=costs))
    want = twin(*ins, cashflows=cf, apply_costs=costs)
    for name, a, b in zip(OUTPUTS, got, want):
        bitwise(name, a, b)
    if flows == "withdrawal" and S >= 2520:
        assert (got[0] == 0).all()                 # every strategy ruined


@pytest.mark.parametrize("costs", [True, False])
@pytest.mark.parametrize("S", [22, 7560])
@pytest.mark.parametrize("B", [37, 4096])
def test_kernel_is_the_twin_on_nonfinite_trials(dev, B, S, costs):
    ins = day_inputs(dev, S, B, seed=S + B, nonfinite=True)
    cf = cashflows("dca", S)
    got = launched(lambda: ed.emit_days(*ins, cashflows=cf,
                                        apply_costs=costs))
    want = twin(*ins, cashflows=cf, apply_costs=costs)
    assert got[0].isnan().any() and not got[0][:, ::5].isnan().any()
    for name, a, b in zip(OUTPUTS, got, want):
        bitwise(name, a, b)


def test_wrapper_counts_rows_without_a_sync(dev):
    """fused_emit_rows counts B on the open span; the wrapper reads no
    device value (no sync counted)."""
    ins = day_inputs(dev, 30, 50, seed=3)
    ed.emit_days(*ins)
    torch.cuda.synchronize()
    profiling.reset()
    with profiling.tracing(), profiling.span("strategies"):
        launched(lambda: ed.emit_days(*ins))
    (rec,) = [r for r in profiling.records() if r.name == "strategies"]
    assert rec.counters == {"fused_emit_rows": 50}, rec.counters


def test_kernel_refuses_float64(dev):
    ins = [x.double() for x in day_inputs(dev, 22, 8, seed=1)]
    n0 = ed.LAUNCHES
    with pytest.raises(TypeError, match="emit_days: ret_all has dtype"):
        ed.emit_days(*ins)
    assert ed.LAUNCHES == n0


def both_routes(monkeypatch, fn):
    """fn() through the kernel (one launch or more), then through the
    twin (none)."""
    n0 = ed.LAUNCHES
    got = fn()
    assert ed.LAUNCHES > n0
    with monkeypatch.context() as m:
        m.setattr(engine, "emit_days", twin)
        n0 = ed.LAUNCHES
        want = fn()
        assert ed.LAUNCHES == n0
    return got, want


@pytest.mark.parametrize("flows", ["none", "withdrawal"])
def test_emitting_engine_is_the_twins(dev, monkeypatch, flows):
    """run_strategies_batch(emit_trades=True) on a card path: every field
    of StrategyResults bitwise, the kernel launched once."""
    mt = from_numpy(default_sim_model(), dev, torch.float32)
    rows = torch.arange(256, device=dev)
    S = 504
    path = generate_paths_batched(mt, rng.key(8, dev), rows // 2,
                                  rows % 2 == 1, sim_days=S,
                                  buffer_days=252)
    sig = compute_signals(path)
    got, want = both_routes(monkeypatch, lambda: engine.run_strategies_batch(
        path, sig, emit_trades=True, cashflows=cashflows(flows, S)))
    for name, a, b in zip(got._fields, got, want):
        bitwise(name, a, b)


def test_general_chunk_replay_is_the_twins(dev, monkeypatch):
    """One general_chunk(emit=True) replay at the default report's shape:
    642 of 1,048,576 institutional rows at 30 years, seed 2; its
    summaries and emission bitwise."""
    run = mc_runner._Run(default_sim_model(), 30, 1_048_576, 2,
                         device="cuda")
    ids, anti = mc_runner._trial_layout(run.num_simulations,
                                        run.use_antithetic)
    rows = np.unique(np.linspace(0, run.num_simulations - 1, 642,
                                 dtype=int))
    assert len(rows) == 642
    (gs, ge), (ws, we) = both_routes(
        monkeypatch, lambda: mc_runner.general_chunk(run, ids[rows],
                                                     anti[rows]))
    for k in gs:
        bitwise(k, gs[k], ws[k])
    for name, a, b in zip(("tj_alloc", "tj_value", "tj_price", "tj_asset"),
                          ge, we):
        bitwise(name, a, b)


def test_default_report_post_tax_is_the_twins(dev, monkeypatch):
    """The default report (1,048,576 x 30 y, sampled post-tax tables),
    seed 5: the 13 post-tax tables and the sample (rows, pre-tax wealth,
    exact tax) equal through the kernel and through the twin."""
    def report():
        rep = mc_runner.monte_carlo_report(default_sim_model(), 30,
                                           num_simulations=1_048_576,
                                           seed=5, device="cuda")
        return ({sid: s["post_tax"] for sid, s in rep["strategies"].items()
                 if "post_tax" in s}, rep["post_tax_sample"])

    (gt, gsample), (wt, wsample) = both_routes(monkeypatch, report)
    assert len(gt) == 13 and gt == wt
    assert gsample == wsample
