"""The run's whole set-up: from the process's start (before its imports)
to the window's start, on the host clock."""


def read(run):
    return run.setup_s
