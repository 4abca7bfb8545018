"""The port's tracer (``letf_tpu_torch/utils/profiling.py``) on the CPU, on
a tiny report (four chunks of eight trials, two years) of each engine
mode: off, it records nothing; on, the report is bitwise the untraced one
and its spans form the report's tree (one ``report`` root, ``run_setup``,
one ``chunk`` a chunk with the mode's children, ``gather``, ``reduce``),
each inside its parent's host interval and all with the report's id;
each span is a ``cpu_op`` on the profiler's timeline (through
``device_trace``, on a shorter report) that starts within 1 ms of the
tracer's own clock. The
counters: ``draw_rounds`` counts the gamma sampler's rounds, and a
synchronising-call warning counts as one ``syncs`` on the open span. A
fault-tolerant run whose first attempt at a chunk times out keeps its
retry's spans under the retry's own ``chunk``. The ``cuda`` tests count
one institutional chunk's synchronisations on the card, check the
profiled spans there and that tracing adds no device operation; they
skip without a card. Nothing here needs JAX:
``python -m pytest -m cuda --noconftest tests/test_torch_tracing.py`` on
a GPU machine."""

import collections
import contextlib
import io
import json
import threading
import time
import warnings

import pytest
import torch

from letf_tpu_torch import config as tcfg
from letf_tpu_torch import reporting
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.ops import rng
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ("institutional_v1", "parametric")
KW = dict(num_simulations=32, seed=2**32 + 7, chunk_size=8,
          tax_mode="none")
CHILDREN = {"institutional_v1": ["chunk.start", "chunk.regime", "chunk.k1",
                                 "chunk.moments", "chunk.k2", "chunk.k3"],
            "parametric": ["draws", "path_scan", "signals", "strategies"]}


@pytest.fixture(scope="module", autouse=True)
def short_buffer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "RANDOM_START_BUFFER_YEARS", 0.5)
        yield


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with tracing off and no spans."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.fixture(scope="module", params=MODES)
def runs(request, model):
    """(mode, untraced report, spans recorded with tracing off, traced
    report, its spans)."""
    mode = request.param
    kw = dict(KW, engine_mode=mode, device="cpu")
    profiling.disable()
    profiling.reset()
    off = mc_runner.monte_carlo_report(model, 2, **kw)
    n_off = len(profiling.records())
    with profiling.tracing():
        on = mc_runner.monte_carlo_report(model, 2, **kw)
    recs = profiling.records()
    profiling.reset()
    return mode, off, n_off, on, recs


def test_off_records_nothing_and_shares_one_noop(runs):
    _, _, n_off, *_ = runs
    assert n_off == 0
    assert profiling.span("report") is profiling.span("chunk")
    with profiling.span("report"):
        profiling.count("syncs")
    assert profiling.records() == []


def test_reports_are_bitwise_equal_with_tracing_on_and_off(runs):
    _, off, _, on, *_ = runs
    assert on == off


def test_spans_form_the_report_tree(runs):
    mode, _, _, _, recs, *_ = runs
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["report"]
    root = roots[0]
    assert root.report is not None
    top = [r.name for r in recs if r.parent == root.id]
    assert top == ["run_setup"] + ["chunk"] * 4 + ["gather", "reduce"]
    for c in (r for r in recs if r.name == "chunk"):
        kids = [r.name for r in recs if r.parent == c.id]
        assert kids == CHILDREN[mode]
    for r in recs:
        assert r.report == root.report
        assert r.start_ns <= r.end_ns
        assert r.device_ms is not None and r.device_ms >= 0
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, r.name


@pytest.mark.parametrize("mode", MODES)
def test_spans_are_cpu_ops_on_the_profilers_clock(model, mode, tmp_path):
    """``device_trace`` turns tracing on; a report of one chunk (a quarter
    of a year, which keeps the trace small) is traced."""
    with contextlib.redirect_stdout(io.StringIO()):
        with profiling.device_trace(str(tmp_path)) as prof:
            mc_runner.monte_carlo_report(
                model, 0.25, **dict(KW, num_simulations=8, engine_mode=mode,
                                    device="cpu"))
    recs = profiling.records()
    assert {r.name for r in recs} >= {"report", "chunk", *CHILDREN[mode]}
    events = [(ev.name(), ev.start_ns(), ev.is_user_annotation())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(profiling.PREFIX)]
    chrome = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert len(events) == len(recs)
    assert not any(user for _, _, user in events)
    for r in recs:
        name = profiling.PREFIX + r.name
        gap = min(abs(s - r.start_ns) for n, s, _ in events if n == name)
        assert gap < 1_000_000, (r.name, gap)
    cats = {e.get("cat") for e in chrome
            if str(e.get("name", "")).startswith(profiling.PREFIX)}
    assert cats == {"cpu_op"}


def test_draw_rounds_count_the_gamma_loops(monkeypatch):
    """Each outer round and each inner redraw of ``_gamma_one`` splits a
    key once more than the first split of its element keys; the CPU twin
    counts its draws as ``plain_draws``."""
    calls = []
    real = rng.split
    monkeypatch.setattr(rng, "split",
                        lambda k, n: calls.append(n) or real(k, n))
    keys = rng.split(rng.key(5), 64)
    calls.clear()
    with profiling.tracing(), profiling.span("draws"):
        g = rng.gamma(keys, 0.7, 40, torch.float64)
    assert torch.isfinite(g).all()
    (rec,) = profiling.records()
    assert len(calls) > 2
    assert rec.counters == {"draw_rounds": len(calls) - 1,
                            "plain_draws": 64 * 40}


def test_a_sync_warning_counts_on_the_open_span():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        shown = warnings.showwarning
        with profiling.tracing():
            with profiling.span("outer"):
                with profiling.span("inner"):
                    warnings.warn(profiling.SYNC_WARNING + " (test)")
                    warnings.warn("another warning")
                profiling.count("syncs", 2)
        assert warnings.showwarning is shown
    assert [str(w.message) for w in seen] == ["another warning"]
    recs = {r.name: r for r in profiling.records()}
    assert recs["inner"].counters == {"syncs": 1}
    assert recs["outer"].counters == {"syncs": 2}


def test_stages_open_spans_and_keep_their_seconds():
    stages = {}
    with profiling.tracing():
        with reporting._stage(stages, "bridge", torch.device("cpu")):
            time.sleep(0.01)
        with reporting._stage(None, "tax", torch.device("cpu")):
            pass
    assert list(stages) == ["bridge"] and stages["bridge"] >= 0.01
    assert [r.name for r in profiling.records()] == ["bridge", "tax"]


def test_a_retry_keeps_its_spans_under_its_own_chunk(model, monkeypatch):
    """The first attempt at the third chunk stalls past ``chunk_timeout``
    (ten times the slowest clean chunk's host time) and is abandoned; its
    retry's spans open under the retry's ``chunk``, not the stalled one,
    and the run is bitwise the clean run."""
    kw = dict(num_simulations=32, seed=11, chunk_size=8, progress=False,
              device="cpu")
    with profiling.tracing():
        clean = mc_runner.run_monte_carlo(model, 0.25, **kw)
    slowest = max(r.host_ms for r in profiling.records()
                  if r.name == "chunk")
    profiling.reset()
    real = mc_runner._Run.chunk
    release = threading.Event()
    stalled = []

    def stall_once(self, ids, anti):
        if int(ids[0]) == 8 and not stalled:
            stalled.append(threading.get_ident())
            release.wait(60.0)
            raise RuntimeError("the abandoned attempt")
        return real(self, ids, anti)

    monkeypatch.setattr(mc_runner._Run, "chunk", stall_once)
    with profiling.tracing():
        got = mc_runner.run_monte_carlo(
            model, 0.25, fault_tolerant=True, chunk_retries=1,
            chunk_timeout=10 * slowest / 1e3, **kw)
    release.set()
    deadline = time.monotonic() + 60.0
    while (sum(r.name == "chunk" for r in profiling.records()) < 5
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not got.chunk_failed.any()
    assert (got.final_wealth == clean.final_wealth).all()
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.parent is None]
    chunks = [r for r in recs if r.name == "chunk"]
    assert len(chunks) == 5 and all(c.parent == root.id for c in chunks)
    kids = {c.id: [r.name for r in recs if r.parent == c.id]
            for c in chunks}
    (abandoned,) = [c for c in chunks if not kids[c.id]]
    assert abandoned.thread == stalled[0]
    assert all(kids[c.id] == CHILDREN["institutional_v1"]
               for c in chunks if c is not abandoned)
    for r in recs:
        assert r.report == root.report
        if r.parent is not None and r.parent != root.id:
            p = by_id[r.parent]
            assert r.thread == p.thread
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


# ---- on the card ----

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chunk's syncs are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_an_institutional_chunk_counts_its_syncs_on_the_card(card, model):
    """One chunk of 2,048 trials x 2 years: each known synchronising call
    counts once on the span that made it, and nothing else syncs: the two
    id copies and the key's ``tolist`` on ``chunk``; the START stream id,
    ``randint``'s three bounds and the VIX table on ``chunk.start``; the
    REGIME stream id on ``chunk.regime``; K3's constants on
    ``chunk.k3``."""
    kw = dict(KW, num_simulations=2048, chunk_size=2048,
              engine_mode="institutional_v1", device=card)
    mc_runner.monte_carlo_report(model, 2, **kw)
    with profiling.tracing():
        mc_runner.monte_carlo_report(model, 2, **kw)
    assert torch.cuda.get_sync_debug_mode() == 0
    recs = profiling.records()
    (chunk,) = [r for r in recs if r.name == "chunk"]
    syncs = {r.name: r.counters.get("syncs", 0) for r in recs
             if r.id == chunk.id or r.parent == chunk.id}
    assert syncs == {"chunk": 3, "chunk.start": 5, "chunk.regime": 1,
                     "chunk.k1": 0, "chunk.moments": 0, "chunk.k2": 0,
                     "chunk.k3": 1}, syncs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_profiled_spans_on_the_card_are_host_events(card, model, mode):
    """Under the profiler, each span is a host event and none echoes on
    the device."""
    kw = dict(KW, num_simulations=512, chunk_size=256, engine_mode=mode,
              device=card)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    mc_runner.monte_carlo_report(model, 2, **kw)
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.tracing():
            mc_runner.monte_carlo_report(model, 2, **kw)
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    host = {e.name() for e in evs if e.device_type() != cuda}
    echoes = {e.name() for e in evs if e.device_type() == cuda
              and e.name().startswith(profiling.PREFIX)}
    assert not echoes, echoes
    names = {profiling.PREFIX + r.name for r in profiling.records()}
    assert names <= host, names - host


@pytest.mark.cuda
def test_tracing_adds_no_device_operation_on_the_card(card, model):
    """A device-only trace of an institutional report with tracing on
    shows no kind of device operation the untraced report lacks, and of
    no kind as many more as half the report's spans: a tracer that did
    device work in its spans would add one or more a span. (The profiler
    itself miscounts now and then: 71 against 70 pageable copies in one
    of three runs on the card. The parametric report's counts vary by
    tens between identical untraced runs, though it is bitwise
    reproducible, so they are not compared.)"""
    kw = dict(KW, num_simulations=512, chunk_size=256,
              engine_mode="institutional_v1", device=card)
    cuda = torch.autograd.DeviceType.CUDA
    mc_runner.monte_carlo_report(model, 2, **kw)
    counts = []
    for on in (False, True):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with profiling.tracing() if on else contextlib.nullcontext():
                mc_runner.monte_carlo_report(model, 2, **kw)
            torch.cuda.synchronize()
        counts.append(collections.Counter(
            e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda))
    off, on = counts
    spans = len(profiling.records())
    assert sum(off.values()) > 0 and spans >= 18
    assert set(on) <= set(off), set(on) - set(off)
    more = {k: v for k, v in (on - off).items() if v >= spans // 2}
    assert not more, (more, spans)
