"""Preconditioned conjugate gradient with the reference's full safeguard
suite (port of ``faspsolver_tpu/krylov/pcg.py``).

Reference: base/src/KryPcg.c:96 (fasp_solver_dcsr_pcg).  Safeguards
reproduced (they decide iteration counts):
- breakdown guard on p·Ap                  (KryPcg.c:172-177)
- Check I:  near-zero solution abort        (KryPcg.c:215-222)
- Check II: stagnation restart (p <- 0)     (KryPcg.c:224-274)
- Check III: false-convergence true-residual recheck (KryPcg.c:277-324),
  sharing one true-residual recompute with Check II
Safety-net variant (safe=True) tracks the best iterate and returns it on
non-convergence (reference: KrySPcg.c:81-85,190-196).

The loop is an eager Python loop.  Vector work stays on the device; the
scalars that steer it (p·Ap, alpha, the residual norms, |x|, |p|) come to
the host in ONE read per iteration, where the checks run on NumPy
scalars of b's dtype — the same roundings as the JAX package's traced
scalar arithmetic (its ``tol`` is cast to b's dtype too).  An iteration
that recomputes the true residual reads once more.  ``SolveResult.syncs``
counts the reads.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import (ERROR_SOLVER_MISC, ERROR_SOLVER_SOLSTAG,
                         ERROR_SOLVER_STAG, ERROR_SOLVER_TOLSMALL, MAX_RESTART,
                         MAX_STAG, STAG_RATIO, StopType)
from .common import (SMALLREAL, SMALLREAL2, HostReads, abs_residual, dot,
                     initial_norms, residual_norms, resolve_precond)
from .result import SolveResult


def pcg(A, b, x0=None, M=None, *, tol: float = 1e-6, abstol: float = 1e-18,
        maxit: int = 500, stop_type: int = int(StopType.REL_RES),
        safe: bool = False, max_stag: int = MAX_STAG,
        max_restart: int = MAX_RESTART) -> SolveResult:
    """Solve A x = b with preconditioned CG.

    ``max_stag``/``max_restart`` default to the reference's safeguard
    budgets; inner solves under mixed-precision refinement pass small
    values so a solve pinned at the f32 residual floor exits after a
    couple of restarts (the outer f64 loop supplies the robustness).
    """
    M = resolve_precond(M)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(abstol)
    maxdiff = tol * t(STAG_RATIO)
    small, small2, slow = t(SMALLREAL), t(SMALLREAL2), t(0.9)
    precres = stop_type == StopType.REL_PRECRES
    if x0 is None:
        x0 = torch.zeros_like(b)

    x = x0
    r = b - A(x0)
    z = M(r)
    absres0, normr0, normu, relres = initial_norms(
        stop_type, *host(abs_residual(stop_type, r, z), dot(x, x)))
    done = bool(relres < tol) or bool(absres0 < abstol)
    p = z
    temp1 = dot(z, r)
    it, stag, more, status = 0, 1, 1, 0
    best_x, best_absres = x0, absres0

    while not done and it < maxit:
        it += 1
        tp = A(p)
        temp2 = dot(tp, p)
        bd = temp2.abs() <= SMALLREAL2
        # on breakdown leave the iterate untouched (reference breaks first)
        alpha = torch.where(bd, torch.zeros_like(temp2),
                            temp1 / torch.where(bd, torch.ones_like(temp2),
                                                temp2))
        x = x + alpha * p
        r = r - alpha * tp
        if precres:
            z = M(r)
        (temp2_h, alpha_h, absres, normuinf, xx, pp) = host(
            temp2, alpha, abs_residual(stop_type, r, z),
            torch.max(torch.abs(x)), dot(x, x), dot(p, p))
        absres, relres = residual_norms(stop_type, absres, normr0, normu)
        breakdown = abs(temp2_h) <= small2
        factor = absres / absres0

        # ---- Check I + II (only when converging slowly: factor > 0.9) ----
        zero_sol = factor > slow and normuinf <= small
        normu_new = max(small, np.sqrt(xx))
        reldiff = abs(alpha_h) * np.sqrt(pp) / normu_new
        stagnated = (factor > slow and not zero_sol and stag <= max_stag
                     and reldiff < maxdiff)
        # Check III on claimed convergence; one true-residual recompute
        # serves both checks
        claim = relres < tol and not stagnated and not zero_sol
        need = stagnated or claim
        if need:
            r = b - A(x)
            if precres:
                z = M(r)
            absres, relres = residual_norms(
                stop_type, *host(abs_residual(stop_type, r, z)), normr0,
                normu_new)

        conv = need and relres < tol
        stag_fail = stagnated and not conv and stag >= max_stag
        tol_fail = claim and not conv and more >= max_restart
        restart = need and not conv and not stag_fail and not tol_fail
        if restart:
            p = torch.zeros_like(p)
            stag += int(stagnated)
            more += int(claim)

        # ---- prepare next direction ----
        if not precres:
            z = M(r)
        temp2n = dot(z, r)
        p = z + (temp2n / temp1) * p
        temp1 = temp2n

        done = bool(breakdown or zero_sol or stag_fail or tol_fail
                    or (stagnated and conv) or (claim and conv))
        status = (ERROR_SOLVER_MISC if breakdown else
                  ERROR_SOLVER_SOLSTAG if zero_sol else
                  ERROR_SOLVER_STAG if stag_fail else
                  ERROR_SOLVER_TOLSMALL if tol_fail else 0)
        absres0 = absres
        if stop_type == StopType.MOD_REL_RES:
            normu = normu_new
        if safe and absres < best_absres:
            best_x, best_absres = x, absres

    converged = bool(relres < tol)
    if safe and not converged and best_absres < absres0:
        # best-so-far iterate on non-convergence (KrySPcg.c:190-196)
        x = best_x
    return SolveResult(x=x, iters=it, relres=float(relres),
                       converged=converged, status=int(status),
                       syncs=host.count)
