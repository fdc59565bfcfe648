"""AMG as a standalone iterative solver: cycle until converged (port of
``faspsolver_tpu/precond/amg/solve.py``).

Reference: fasp_amg_solve (PreMGSolve.c:49): while iter < maxit
{mgcycle; r = b - Ax; relres check}; the AMLI / nonlinear AMLI variants
(:142, :230) by the hierarchy's cycle type; full-MG solve
(fasp_solver_famg, SolFAMG.c:41).  A Python loop with one host read of
the relative residual per cycle (``SolveResult.syncs``).
"""
from __future__ import annotations

import torch

from ...krylov.common import HostReads
from ...krylov.result import SolveResult
from .cycles import cycle_fn, fmg_cycle
from .hierarchy import AMGHierarchy


def amg_solve(hier: AMGHierarchy, b: torch.Tensor, x0=None, *,
              tol: float = 1e-6, maxit: int = 20) -> SolveResult:
    """Iterate multigrid cycles of the hierarchy's cycle type to
    tolerance ||b - A x|| / ||b|| < tol."""
    A = hier.levels[0].A
    cycle = cycle_fn(hier.cycle_type)
    host = HostReads(b.dtype)
    tol = host.t(tol)
    x = torch.zeros_like(b) if x0 is None else x0
    normb = torch.clamp_min(torch.sqrt(torch.dot(b, b)), 1e-20)

    def relres_of(x):
        r = b - A(x)
        return host(torch.sqrt(torch.dot(r, r)) / normb)[0]

    relres = relres_of(x)
    it = 0
    while not relres < tol and it < maxit:
        x = cycle(hier, b, x)
        relres = relres_of(x)
        it += 1
    return SolveResult(x=x, iters=it, relres=float(relres),
                       converged=bool(relres < tol), status=0,
                       syncs=host.count)


def famg_solve(hier: AMGHierarchy, b: torch.Tensor, x0=None, *,
               tol: float = 1e-6, maxit: int = 20) -> SolveResult:
    """Full-multigrid solve: one FMG sweep, then cycles to tolerance
    (reference: fasp_solver_famg, SolFAMG.c:41).  ``x0`` is not read:
    the FMG sweep builds the first iterate, as in the reference."""
    res = amg_solve(hier, b, fmg_cycle(hier, b), tol=tol,
                    maxit=max(maxit - 1, 1))
    res.iters += 1
    return res
