"""1 - the device's busy time over the traced stretch of the window: the
union of the launches' device records, each launch whole (see
``tracing.py``)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
