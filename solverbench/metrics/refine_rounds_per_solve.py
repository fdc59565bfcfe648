"""The mean of the refinement rounds that the window's solves returned."""


def read(run):
    return sum(run.rounds) / len(run.rounds) if run.rounds else None
