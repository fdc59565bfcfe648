"""Preconditioned BiCGstab (port of ``faspsolver_tpu/krylov/bicgstab.py``).

Reference: base/src/KryPbcgs.c, with breakdown guards on rho and omega,
the stagnation restart, the false-convergence true-residual recheck and
the safety-net best-iterate mode (KrySPbcgs.c).  An eager loop: vector
work and the guarded scalars stay on the device; the values the checks
need come to the host in one read per iteration, plus one where the
true residual is recomputed (``SolveResult.syncs``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import (ERROR_SOLVER_MISC, ERROR_SOLVER_STAG,
                         ERROR_SOLVER_TOLSMALL, MAX_RESTART, MAX_STAG,
                         STAG_RATIO, StopType)
from .common import (SMALLREAL, SMALLREAL2, HostReads, abs_residual,
                     initial_norms, residual_norms, resolve_precond)
from .result import SolveResult


def _guard(bad, v):
    """v where not ``bad``, else 1 (the divisor of a guarded quotient)."""
    return torch.where(bad, torch.ones_like(v), v)


def bicgstab(A, b, x0=None, M=None, *, tol: float = 1e-6,
             abstol: float = 1e-18, maxit: int = 500,
             stop_type: int = int(StopType.REL_RES),
             safe: bool = False) -> SolveResult:
    """Solve A x = b with right-preconditioned BiCGstab."""
    M = resolve_precond(M)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(abstol)
    maxdiff = tol * t(STAG_RATIO)
    small, small2, slow = t(SMALLREAL), t(SMALLREAL2), t(0.9)
    precres = stop_type == StopType.REL_PRECRES
    if x0 is None:
        x0 = torch.zeros(A.shape[0], dtype=b.dtype, device=b.device)

    x = x0
    r = b - A(x0)
    absres0, normr0, normu, relres = initial_norms(
        stop_type, *host(abs_residual(stop_type, r, M(r)),
                         torch.dot(x0, x0)))
    done = bool(relres < tol) or bool(absres0 < abstol)
    rstar, p, v = r, r, torch.zeros_like(r)
    rho = torch.dot(r, r)
    it, stag, more, status = 0, 1, 1, 0
    best_x, best_absres = x0, absres0

    while not done and it < maxit:
        it += 1
        phat = M(p)
        v = A(phat)
        sigma = torch.dot(rstar, v)
        bd1 = sigma.abs() <= SMALLREAL2
        alpha = torch.where(bd1, torch.zeros_like(sigma),
                            rho / _guard(bd1, sigma))
        sv = r - alpha * v
        shat = M(sv)
        tv = A(shat)
        tt = torch.dot(tv, tv)
        bd2 = tt <= SMALLREAL2
        omega = torch.where(bd2, torch.zeros_like(tt),
                            torch.dot(tv, sv) / _guard(bd2, tt))
        x = x + alpha * phat + omega * shat
        r = sv - omega * tv
        rho_new = torch.dot(rstar, r)
        bd3 = (rho * omega).abs() <= SMALLREAL2
        beta = torch.where(
            bd3, torch.zeros_like(rho),
            (rho_new / _guard(rho.abs() <= SMALLREAL2, rho))
            * (alpha / _guard(bd2, omega)))
        p = r + beta * (p - omega * v)

        step = alpha * phat + omega * shat
        z = M(r) if precres else r
        sig_h, tt_h, absres, xx, ss = host(
            sigma, tt, abs_residual(stop_type, r, z), torch.dot(x, x),
            torch.dot(step, step))
        breakdown = abs(sig_h) <= small2 or tt_h <= small2
        absres, relres = residual_norms(stop_type, absres, normr0, normu)
        factor = absres / absres0

        # stagnation + false-convergence checks (same structure as pcg)
        normu_new = max(small, np.sqrt(xx))
        stagnated = (factor > slow and stag <= MAX_STAG
                     and np.sqrt(ss) / normu_new < maxdiff)
        claim = relres < tol and not stagnated
        need = stagnated or claim
        if need:
            r = b - A(x)
            z = M(r) if precres else r
            absres, relres = residual_norms(
                stop_type, *host(abs_residual(stop_type, r, z)), normr0,
                normu_new)
        conv = need and relres < tol
        stag_fail = stagnated and not conv and stag >= MAX_STAG
        tol_fail = claim and not conv and more >= MAX_RESTART
        restart = need and not conv and not stag_fail and not tol_fail
        if restart:
            # reset the search space from the current residual
            p, rstar, rho = r, r, torch.dot(r, r)
            stag += int(stagnated)
            more += int(claim)
        else:
            rho = rho_new

        done = bool(breakdown or conv or stag_fail or tol_fail)
        status = (ERROR_SOLVER_MISC if breakdown else
                  ERROR_SOLVER_STAG if stag_fail else
                  ERROR_SOLVER_TOLSMALL if tol_fail else 0)
        absres0 = absres
        if stop_type == StopType.MOD_REL_RES:
            normu = normu_new
        if safe and absres < best_absres:
            best_x, best_absres = x, absres

    converged = bool(relres < tol)
    if safe and not converged and best_absres < absres0:
        x = best_x
    return SolveResult(x=x, iters=it, relres=float(relres),
                       converged=converged, status=int(status),
                       syncs=host.count)
