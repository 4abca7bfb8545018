"""The window's rate rule: every completed report's trial-years over the
whole window, which ends at the return of the last report issued."""

import pytest

from benchmark.harness.window import closed_loop


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def loop(durations, seconds, fail=()):
    clock = FakeClock()
    issued = []

    def issue(k):
        issued.append(k)
        clock.t += durations[k]
        if k in fail:
            raise RuntimeError(f"report {k} failed")
        return 10.0

    return closed_loop(issue, seconds, clock), issued


def test_window_ends_at_the_last_report_boundary():
    w, issued = loop([3.0, 3.0, 3.0, 3.0, 3.0], seconds=7.0)
    # reports start at 0, 3, 6 (< 7 s); none is issued at 9 s
    assert issued == [0, 1, 2]
    assert w.seconds == pytest.approx(9.0)
    assert w.rate == pytest.approx(30.0 / 9.0)
    assert (w.attempted, w.failed) == (3, 0)


def test_a_stall_counts_in_the_window():
    w, _ = loop([1.0, 10.0, 1.0, 1.0], seconds=5.0)
    assert w.attempted == 2
    assert w.rate == pytest.approx(20.0 / 11.0)


def test_a_failed_report_counts_time_and_no_work(capsys):
    w, _ = loop([2.0, 2.0, 2.0, 2.0], seconds=5.0, fail={1})
    assert (w.attempted, w.failed) == (3, 1)
    assert w.work == pytest.approx(20.0)
    assert w.rate == pytest.approx(20.0 / 6.0)
    assert "report 1 failed" in capsys.readouterr().err


def test_one_report_even_when_it_outlasts_the_window():
    w, issued = loop([30.0, 30.0], seconds=1.0)
    assert issued == [0]
    assert w.rate == pytest.approx(10.0 / 30.0)
