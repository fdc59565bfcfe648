"""The comparison that decides ``correct``.

What is judged is what the window produced: a sample of its solves,
drawn from the seed, each x against its b, and the fine operators that
the program's set-up derived from A, applied to those x's.  The plain
reference (``reference.py``) works from the benchmark's own CSR matrix:

- ``relres``: the largest ||b - A x|| / ||b|| of the sampled x's, in
  float64, against the configuration's tolerance;
- ``<operator>`` (``fine64``, ``fine32``): the largest componentwise
  error max_i |y_i - (A v)_i| / (|A| |v|)_i of the operator's output y
  for each input v as the operator got it, against the configuration's
  limit.  The inputs are the sampled x's and the differences of
  consecutive ones: an x can be all but constant (A^-1 (A 1) is 1), and
  a product of a constant vector is exact in any precision that holds
  the matrix's entries, so the differences, which carry the solutions
  of the traffic's perturbations, are what a lower precision shows on;
- ``unconverged``: the window's solves that the program itself reported
  as not converged, against 0.

Each limit is in the configuration's ``check`` object."""
from __future__ import annotations

import random
from typing import List

import torch

from solverbench import reference


class Sample:
    """A seeded uniform sample of ``size`` of a stream of unknown length
    (reservoir sampling): each solve of the window is kept or not as it
    returns, without a copy."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = item


def operator_inputs(xs: List) -> List:
    """The sampled x's and the differences of consecutive ones."""
    return list(xs) + [b - a for a, b in zip(xs, xs[1:])]


def operator_outputs(system, xs: List, device) -> dict:
    """{name: [(v as the operator got it, its output)]}, both on the
    host, for each fine operator of the program and each input v of
    :func:`operator_inputs`."""
    out = {}
    with torch.no_grad():
        for name, (op, dtype) in system.fine_operators().items():
            pairs = []
            for x in operator_inputs(xs):
                xin = torch.as_tensor(x, device=device).to(dtype)
                pairs.append((xin.cpu(), op(xin).cpu()))
            out[name] = pairs
    return out


def judge(config: dict, A: "reference.Ell", solved: List, outputs: dict,
          unconverged: int) -> tuple:
    """(correct, checks): ``solved`` is [(b, x)] host arrays, ``outputs``
    what :func:`operator_outputs` gave; ``checks`` maps each number's
    short name to its value and limit."""
    limits = config["check"]
    dev = A.vals.device
    checks = {}
    worst = 0.0
    for b, x in solved:
        worst = max(worst, reference.relres(
            A, torch.as_tensor(x, device=dev), torch.as_tensor(b, device=dev)))
    checks["relres"] = {"value": worst, "limit": limits["relres"]}
    for name, pairs in outputs.items():
        err = max((reference.op_error(A, xin.to(dev), y.to(dev))
                   for xin, y in pairs), default=0.0)
        checks[name] = {"value": err, "limit": limits[name]}
    checks["unconverged"] = {"value": unconverged, "limit": 0}
    correct = bool(solved) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    return correct, checks
