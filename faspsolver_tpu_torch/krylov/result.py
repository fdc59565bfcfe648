"""Solve result container (port of ``faspsolver_tpu/krylov/result.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class SolveResult:
    """Outcome of an iterative solve.

    ``status``: 0 on success semantics like the reference (fasp_solver_*
    return value); negative = ERROR_SOLVER_* code.  ``syncs`` counts the
    device-to-host reads the eager loop made (one per iteration for the
    stopping test, one more where a true residual is recomputed).
    ``resident``: the solve ran as one resident CUDA graph (one launch,
    one read) rather than the eager loop.
    """

    x: torch.Tensor
    iters: int
    relres: float
    converged: bool
    status: int
    syncs: int = 0
    resident: bool = False

    def __repr__(self):
        return (f"SolveResult(iters={self.iters}, relres={self.relres:.4e}, "
                f"converged={self.converged})")
