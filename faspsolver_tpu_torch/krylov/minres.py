"""Preconditioned MINRES (port of ``faspsolver_tpu/krylov/minres.py``).

Reference: base/src/KryPminres.c.  Preconditioned Lanczos with Givens
rotations for symmetric (possibly indefinite) systems with an SPD
preconditioner.  The residual is tracked by the |eta| recurrence and the
true residual is recomputed when convergence is claimed (the
reference's false-convergence guard).  The Givens scalars stay 0-d
tensors on the device; eta and the next Lanczos norm come to the host in
one read per iteration, plus one on a claim (``SolveResult.syncs``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import StopType
from .common import (SMALLREAL, HostReads, abs_residual, initial_norms,
                     residual_norms, resolve_precond)
from .result import SolveResult


def _safe(v):
    """v where v > SMALLREAL, else 1."""
    return torch.where(v > SMALLREAL, v, torch.ones_like(v))


def minres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
           stop_type=int(StopType.REL_RES), safe: bool = False
           ) -> SolveResult:
    """Solve A x = b (A symmetric) with preconditioned MINRES."""
    M = resolve_precond(M)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(abstol)
    small = t(SMALLREAL)
    if x0 is None:
        x0 = torch.zeros(A.shape[0], dtype=b.dtype, device=b.device)

    r0 = b - A(x0)
    z0 = M(r0)
    beta0 = torch.sqrt(torch.clamp_min(torch.dot(r0, z0), 0.0))
    absres, xx, beta0_h = host(abs_residual(stop_type, r0, z0),
                               torch.dot(x0, x0), beta0)
    absres0, normr0, normu, relres = initial_norms(stop_type, absres, xx)
    done = bool(relres < tol) or bool(absres0 < abstol) or beta0_h <= small

    x = x0
    v_old, v, z = torch.zeros_like(b), r0 / _safe(beta0), z0 / _safe(beta0)
    beta, eta = beta0, beta0
    one, zero = torch.ones_like(beta0), torch.zeros_like(beta0)
    c_old, c, s_old, s = one, one, zero, zero
    w_oold = w_old = torch.zeros_like(b)
    it = 0
    best_x, best_relres = x0, relres

    while not done and it < maxit:
        it += 1
        # Lanczos step in the M-inner product
        Az = A(z)
        alpha = torch.dot(Az, z)
        r_new = Az - alpha * v - beta * v_old
        z_unnorm = M(r_new)
        beta_new = torch.sqrt(torch.clamp_min(torch.dot(r_new, z_unnorm),
                                              0.0))

        # Givens rotations on the tridiagonal
        rho0 = c * alpha - c_old * s * beta
        rho1 = torch.sqrt(rho0 * rho0 + beta_new * beta_new)
        rho2 = s * alpha + c_old * c * beta
        rho3 = s_old * beta
        rho1s = _safe(rho1)
        c_new = rho0 / rho1s
        s_new = beta_new / rho1s
        w = (z - rho3 * w_oold - rho2 * w_old) / rho1s
        x = x + c_new * eta * w
        eta = -s_new * eta

        eta_h, beta_new_h = host(eta, beta_new)
        relres = abs(eta_h) / normr0
        claim = relres < tol
        if claim:
            # true-residual recheck of a claimed convergence
            rt = b - A(x)
            zt = M(rt) if stop_type == StopType.REL_PRECRES else rt
            absres, xx = host(abs_residual(stop_type, rt, zt),
                              torch.dot(x, x))
            relres = residual_norms(stop_type, absres, normr0,
                                    max(small, np.sqrt(xx)))[1]
        done = bool(claim and relres < tol) or beta_new_h <= small

        v_old, v, z = v, r_new / _safe(beta_new), z_unnorm / _safe(beta_new)
        beta = beta_new
        c_old, c, s_old, s = c, c_new, s, s_new
        w_oold, w_old = w_old, w
        if safe and relres < best_relres:
            best_x, best_relres = x, relres

    converged = bool(relres < tol)
    if safe and not converged and best_relres < relres:
        x = best_x
    return SolveResult(x=x, iters=it, relres=float(relres),
                       converged=converged, status=0, syncs=host.count)
