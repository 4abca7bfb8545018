"""The traced report's reductions on plain intervals (microseconds)."""

import pytest

from benchmark.harness import trace as tr


def test_busy_is_the_union_of_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert tr.busy_us(iv) == 25
    assert tr.union(iv) == [[0, 15], [20, 30], [40, 40]]


def test_gaps_within_the_span():
    assert tr.gaps([(10, 20), (15, 30), (50, 60)], 0, 70) == [
        (0, 10), (30, 50), (60, 70)]
    assert tr.gaps([(-5, 5), (60, 90)], 0, 70) == [(5, 60)]


def test_idle_share_and_labels():
    device = [("k_a", 0, 40), ("k_b", 30, 60), ("k_a", 80, 100)]
    host = [("bench:mc_runner.slab_chunk_summaries", 0, 100),
            ("aten::cumsum", 58, 62), ("cudaStreamSynchronize", 61, 85)]
    s = tr.summarize(device, host, 0, 100)
    assert s.busy_s == pytest.approx(80e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.idle_pct == pytest.approx(20.0)
    assert s.idle == {"mc_runner.slab_chunk_summaries / aten::cumsum":
                      pytest.approx(20e-6)}
    assert s.kernel("k_a") == (pytest.approx(60e-6), 2)
    assert s.breakdown()["device_ops"][0][0] == "k_a"


def test_a_gap_outside_any_call_is_labelled_so():
    s = tr.summarize([("k", 0, 10)], [], 0, 20)
    assert s.idle == {"host outside any traced call": pytest.approx(10e-6)}


def test_intervals_are_clipped_to_the_span():
    s = tr.summarize([("k", -10, 10), ("k", 90, 200)], [], 0, 100)
    assert s.busy_s == pytest.approx(20e-6)
    assert s.idle_pct == pytest.approx(80.0)
