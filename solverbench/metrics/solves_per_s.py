"""Solves that returned in the window over the window's seconds (host
clock): all the work over all the time."""
from solverbench import stats


def read(run):
    return stats.rate(len(run.latencies), run.window_s)
