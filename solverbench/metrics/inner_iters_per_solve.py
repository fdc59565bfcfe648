"""The mean of the inner Krylov iterations that the window's solves
returned."""


def read(run):
    return sum(run.iters) / len(run.iters) if run.iters else None
