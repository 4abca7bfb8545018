"""The comparison's numbers on hand-made rows and reports."""

import numpy as np
import pytest

from benchmark.harness import checks


def rows(fw, nt=None, mdd=None):
    fw = np.asarray(fw, np.float32)
    ok = np.ones(fw.shape[0], bool)
    return dict(final_wealth=fw, valid=ok, repaired=~ok, path_finite=ok,
                vix_ok=ok,
                num_trades=np.zeros(fw.shape, np.int32) if nt is None
                else np.asarray(nt, np.int32),
                max_dd=np.zeros(fw.shape, np.float32) if mdd is None
                else np.asarray(mdd, np.float32))


def test_equal_rows_read_zero_and_nan_pairs_agree():
    a = rows([[1e4, 2e4, 3e4], [np.nan, 5.0, 0.0]])
    n = checks.row_numbers(a, a)
    assert all(v == 0.0 for v in n.values()), n


def test_gaps_are_relative_with_a_floor_and_one_sided_nan_misses():
    a = rows([[1e4, 0.5, 3e4, 7.0]])
    b = rows([[1e4 * (1 + 2e-3), 0.5005, 3e4, np.nan]])
    n = checks.row_numbers(a, b)
    # gaps 2e-3 (relative), 5e-4 (absolute under 1), 0, inf
    assert n["wealth_gap_share"] == 0.5
    # inputs in float32: equal to a few parts in 1e5
    assert n["wealth_median_gap"] == pytest.approx(
        np.median([2e-3 / (1 + 2e-3), 5e-4, 0.0, np.inf]), rel=1e-4)


def test_ruin_on_one_side_only_is_counted_for_s1_to_s3():
    a = rows([[0.0, 1.0, 1.0, 0.0]])
    b = rows([[1.0, 1.0, 1.0, 1.0]])
    assert checks.row_numbers(a, b)["benchmark_ruin_mismatches"] == 1.0


def test_a_number_without_a_limit_fails():
    ok, lines, table = checks.judge({"x": 0.0, "y": 1.0}, {"x": 0.0})
    assert not ok
    assert table == {"x": {"value": 0.0, "limit": 0.0},
                     "y": {"value": 1.0, "limit": None}}
    assert lines[0].endswith("ok") and lines[1].endswith("FAIL")


def test_sample_rows_repeat_for_a_seed_and_differ_across_seeds():
    a = checks.sample_rows(2**31 + 5, 1 << 20, 128, 1 << 14)
    assert np.array_equal(a, checks.sample_rows(2**31 + 5, 1 << 20, 128,
                                                1 << 14))
    assert not np.array_equal(a, checks.sample_rows(2**31 + 6, 1 << 20, 128,
                                                    1 << 14))
    assert len(np.unique(a)) == 128 and a.max() < 1 << 20


@pytest.mark.parametrize("trials, n, chunk", [
    (1 << 20, 128, 1 << 14), (1000, 10, 300), (16384, 128, 16384)])
def test_sample_rows_reach_every_chunk_evenly(trials, n, chunk):
    rows = checks.sample_rows(7, trials, n, chunk)
    per = np.bincount(rows // chunk, minlength=-(-trials // chunk))
    assert len(np.unique(rows)) == n and rows.max() < trials
    assert per.min() >= n // len(per) and per.max() <= -(-n // len(per))


def test_flags_and_the_benchmarks_worst_row_are_counted():
    a = rows([[1e4, 2e4, 3e4, 5e4], [1e4, 2e4, 3e4, 5e4]])
    b = rows([[1e4, 2e4, 3e4 * (1 + 4e-4), 9e4], [1e4, 2e4, 3e4, 5e4]])
    for d, flip in ((a, (True, False)), (b, (True, True))):
        d.update(valid=np.array(flip), repaired=np.array([False, False]),
                 path_finite=np.array([True, True]),
                 vix_ok=np.array(flip))
    n = checks.row_numbers(a, b)
    assert n["flag_mismatches"] == 1.0
    # S4's gap (0.8) is not a benchmark's; S3's 4e-4 is the worst of S1-S3
    assert n["benchmark_wealth_max_gap"] == pytest.approx(
        4e-4 / (1 + 4e-4), rel=1e-4)
