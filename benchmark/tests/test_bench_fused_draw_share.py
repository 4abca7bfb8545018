"""The reader ``fused_draw_share``: fused / (fused + plain) over a
report's spans from the port's ``fused_draws`` and ``plain_draws``
counters, None for a report whose spans counted neither, and None for a
port without the tracer."""

import pytest

from benchmark.harness import spec
from benchmark.harness.main import Run


@pytest.fixture
def tracer():
    from letf_tpu_torch.utils import profiling

    yield profiling
    profiling.disable()
    profiling.reset()


def reader_and_run():
    run = Run(spec.load_cell(spec.HERE.parent, "param_pretax_16k"),
              spec.HERE)
    return spec.metric_reader("fused_draw_share"), run


def test_it_reads_the_draw_counters(tracer):
    reader, run = reader_and_run()
    reader.install(run)
    with tracer.span("report"):
        with tracer.span("draws"):
            tracer.count("fused_draws", 300)
        with tracer.span("path_scan"):
            tracer.count("fused_draws", 300)
            tracer.count("plain_draws", 200)
    assert reader.read(run) == 0.75
    reader.install(run)
    with tracer.span("report"):
        with tracer.span("draws"):
            tracer.count("plain_draws", 50)
    assert reader.read(run) == 0.0


def test_it_is_none_without_the_counters(tracer, monkeypatch):
    reader, run = reader_and_run()
    reader.install(run)
    with tracer.span("report"):
        with tracer.span("draws"):
            tracer.count("draw_rounds", 0)
    assert reader.read(run) is None
    monkeypatch.delattr(tracer, "records")
    reader.install(run)
    assert reader.read(run) is None
