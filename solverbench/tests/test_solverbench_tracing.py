import pytest

from solverbench import tracing
from solverbench.tracing import Ev


def test_union_merges_and_clips():
    assert tracing.union([(5, 9), (0, 3), (2, 4), (8, 12)], 1, 10) == [
        (1, 4), (5, 10)]
    assert tracing.union([(0, 1)], 2, 5) == []


def test_gaps_are_the_complement_in_the_window():
    assert tracing.gaps([(1, 4), (5, 10)], 0, 12) == [(0, 1), (4, 5),
                                                      (10, 12)]


def test_a_launch_counts_whole_from_first_to_last_record():
    evs = [Ev("k", True, 100, 110, 7), Ev("k", True, 150, 160, 7),
           Ev("copy", True, 200, 230, 8), Ev("cudaGraphLaunch", False,
                                             90, 95, 7)]
    assert tracing.launches(evs) == [(100, 160), (200, 230)]


def synthetic():
    """A 1,000 ns window: a graph launch whose records span 100-600 (with
    the profiler missing its middle), a copy at 700-810, and the host in
    a solve span almost throughout."""
    return [Ev(tracing.WINDOW, False, 0, 1000, 0),
            Ev(tracing.SPAN_PREFIX + "solve", False, 50, 990, 0),
            Ev("cudaGraphLaunch", False, 60, 90, 1),
            Ev("body_kernel", True, 100, 150, 1),
            Ev("body_kernel", True, 550, 600, 1),
            Ev("cudaMemcpyAsync", False, 650, 810, 2),
            Ev("Memcpy DtoH", True, 700, 810, 2)]


def test_summary_of_a_synthetic_trace():
    s = tracing.summarize(synthetic())
    assert s.busy_s == pytest.approx(610e-9)
    assert s.window_s == pytest.approx(1000e-9)
    assert 100.0 * (1 - s.busy_s / s.window_s) == pytest.approx(39.0)
    assert s.device_ops == [["Memcpy DtoH", pytest.approx(110e-9)],
                            ["body_kernel", pytest.approx(100e-9)]]
    assert s.idle_gaps == [["solve", pytest.approx(290e-9)],
                           ["solve/cudaMemcpyAsync", pytest.approx(100e-9)]]


def test_no_window_or_no_device_record_reads_nothing():
    assert tracing.summarize([Ev("x", True, 0, 5, 1)]) is None
    assert tracing.summarize([Ev(tracing.WINDOW, False, 0, 9, 0)]) is None
