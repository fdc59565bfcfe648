"""Spans around the benchmark's calls into the program, the device trace
of a steady stretch of the window, and its reduction: the busy time of
the device and a breakdown of where the time went.

Busy time is the union of the device's records in the traced window,
where the records of one launch (one correlation id: a kernel, a copy,
or a whole CUDA-graph launch) count as one interval from the first
record's start to the last one's end.  The profiler misses part of the
kernels of a graph's conditional bodies, so only a launch counted whole
gives the device's time."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterable, List, NamedTuple, Optional

SPAN_PREFIX = "solverbench."
WINDOW = SPAN_PREFIX + "window"


class Ev(NamedTuple):
    name: str
    device: bool                # a record of the device's (else the host's)
    start_ns: int
    end_ns: int
    corr: int                   # correlation id: the launch it belongs to


class Spans:
    """Host-clock spans of the benchmark's own calls; inside a trace each
    is also a ``record_function`` region named ``solverbench.<name>``."""

    def __init__(self):
        self.done: List[tuple] = []
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.tracing:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.done.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.done if n == name)


def events(prof) -> List[Ev]:
    """The records of a finished ``torch.profiler.profile``, read from its
    raw results (no per-event objects are built).  The profiler draws
    each ``record_function`` region on the device's track too; those
    copies are no device work and are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == cuda
        if device and (e.is_user_annotation()
                       or e.name().startswith(SPAN_PREFIX)):
            continue                # a span's shadow on the device's track
        start = int(e.start_ns())
        out.append(Ev(e.name(), device, start,
                      start + int(e.duration_ns()), int(e.correlation_id())))
    return out


def window_of(evs: Iterable[Ev]) -> Optional[tuple]:
    """(start, end) of the traced window's span, in ns."""
    for e in evs:
        if not e.device and e.name == WINDOW:
            return e.start_ns, e.end_ns
    return None


def launches(evs: Iterable[Ev]) -> List[tuple]:
    """One (start, end) per launch: the device's records grouped by
    correlation id, each group from its first start to its last end."""
    span = {}
    for e in evs:
        if not e.device:
            continue
        s = span.get(e.corr)
        span[e.corr] = ((e.start_ns, e.end_ns) if s is None
                        else (min(s[0], e.start_ns), max(s[1], e.end_ns)))
    return sorted(span.values())


def union(intervals: Iterable[tuple], lo: int, hi: int) -> List[tuple]:
    """The union of the intervals clipped to [lo, hi], as disjoint sorted
    intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def gaps(busy: List[tuple], lo: int, hi: int) -> List[tuple]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_label(host: List[Ev], t: int) -> str:
    """What the host was doing at ``t``: the innermost benchmark span and
    the innermost other host record that cover it."""
    span = inner = None
    for e in host:
        if e.start_ns <= t < e.end_ns and e.name != WINDOW:
            d = e.end_ns - e.start_ns
            if e.name.startswith(SPAN_PREFIX):
                if span is None or d < span[0]:
                    span = (d, e.name[len(SPAN_PREFIX):])
            elif inner is None or d < inner[0]:
                inner = (d, e.name)
    parts = [p[1] for p in (span, inner) if p is not None]
    return "/".join(parts) if parts else "between calls"


class Summary(NamedTuple):
    busy_s: float
    window_s: float
    device_ops: list            # [[name, seconds]], most time first
    idle_gaps: list             # [[what the host did, seconds]]


def summarize(evs: List[Ev], top: int = 10) -> Optional[Summary]:
    """Busy time over the traced window and the breakdown, or None when
    the trace holds no window or no device record in it."""
    w = window_of(evs)
    if w is None:
        return None
    lo, hi = w
    busy = union(launches(evs), lo, hi)
    if not busy:
        return None
    by_name = defaultdict(int)
    for e in evs:
        if e.device:
            d = min(e.end_ns, hi) - max(e.start_ns, lo)
            if d > 0:
                by_name[e.name] += d
    host = [e for e in evs if not e.device]
    idle = defaultdict(int)
    for s, e in gaps(busy, lo, hi):
        idle[host_label(host, (s + e) // 2)] += e - s
    rank = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return Summary(sum(e - s for s, e in busy) / 1e9, (hi - lo) / 1e9,
                   rank(by_name), rank(idle))
