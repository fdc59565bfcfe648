"""The 90th percentile of every solve of the window, each timed on the
host from the call with b on the host to the return of x on the host.
In a traced run the solves that ran under the profiler, which slows
each call, are left out."""
from solverbench import stats


def read(run):
    lat = run.latencies[:run.untraced]
    return 1e3 * stats.percentile(lat, 90) if lat else None
