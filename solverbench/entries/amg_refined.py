"""The program under test: an AMG hierarchy of ``faspsolver_tpu_torch``
built once, then ``solvers.solve_refined_resident`` per right-hand side,
b on the host in float64 and x back on the host in float64.

The configuration's ``solver`` object names the setup function of
``faspsolver_tpu_torch.precond.amg`` (``setup``), its ``AMGParam`` fields
(``amg_param``; an enum as ``"SmootherType.CHEBYSHEV"``), the hierarchy's
dtype, the setup's other arguments (``setup_kwargs``) and the solve's
(``solve_kwargs``)."""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch


class Answer(NamedTuple):
    x: np.ndarray               # float64, on the host
    converged: bool             # the program's own f64 test against tol
    rounds: int
    iters: int


def _param(fields: dict):
    from faspsolver_tpu_torch import constants
    from faspsolver_tpu_torch.utils.params import AMGParam
    out = {}
    for k, v in fields.items():
        if isinstance(v, str) and "." in v:
            enum, member = v.split(".", 1)
            v = int(getattr(constants, enum)[member])
        out[k] = v
    return AMGParam(**out)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """One hierarchy on ``device`` and the solve over it."""

    def __init__(self, problem, spec: dict, device):
        from faspsolver_tpu_torch.formats import CSRMatrix
        from faspsolver_tpu_torch.precond import amg
        self.device = torch.device(device)
        self.solve_kwargs = dict(spec["solve_kwargs"])
        A = CSRMatrix(problem.indptr, problem.indices, problem.data,
                      (problem.nrows, problem.nrows))
        _sync(self.device)
        t0 = time.perf_counter()
        self.hier = getattr(amg, spec["setup"])(
            A, _param(spec["amg_param"]), dtype=getattr(torch, spec["dtype"]),
            device=self.device, **spec["setup_kwargs"])
        _sync(self.device)
        self.setup_s = time.perf_counter() - t0
        if self.hier is None or self.hier.fine64 is None:
            raise RuntimeError(f"{spec['setup']} built no hierarchy with an "
                               "f64 fine operator for this matrix")

    def solve(self, b: np.ndarray) -> Answer:
        from faspsolver_tpu_torch.solvers import solve_refined_resident
        r = solve_refined_resident(self.hier, b, **self.solve_kwargs)
        return Answer(r.x, bool(r.converged), int(r.rounds),
                      int(r.inner_iters))

    def fine_operators(self) -> dict:
        """The fine operators the setup derived from A, by name: (the
        operator, the dtype it takes and gives)."""
        return {"fine64": (self.hier.fine64, torch.float64),
                "fine32": (self.hier.levels[0].A,
                           self.hier.levels[0].A.dtype)}

    @staticmethod
    def counters() -> dict:
        """The program's graph counters (``utils.graphs.stats``)."""
        from faspsolver_tpu_torch.utils import graphs
        return dict(graphs.stats)

    @staticmethod
    def reset_counters() -> None:
        from faspsolver_tpu_torch.utils import graphs
        graphs.reset_stats()

    def close(self) -> None:
        """Free the hierarchy and the graphs captured over it."""
        from faspsolver_tpu_torch.utils import graphs
        graphs.release()
        self.hier = None
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def setup(problem, spec: dict, device) -> System:
    return System(problem, spec, device)
