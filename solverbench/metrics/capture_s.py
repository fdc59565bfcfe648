"""The program's graph-capture seconds (``graphs.stats["capture_s"]``)
over the set-up's first, cold solve."""


def read(run):
    return run.capture_s
