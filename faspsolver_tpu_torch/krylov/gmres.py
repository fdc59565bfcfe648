"""GMRES family: restarted, adaptive-restart and flexible, right-
preconditioned (port of ``faspsolver_tpu/krylov/gmres.py``).

Reference: base/src/KryPgmres.c (fixed restart), KryPvgmres.c (adaptive
restart, the cr_max/cr_min rule at :79-80, :200-210), KryPvfgmres.c
(flexible).  One core serves all three.  The Krylov basis is a dense
(restart + 1, n) tensor orthogonalised by CGS2 (classical Gram-Schmidt
twice: two matrix-vector products against the stored basis per step).
The Hessenberg column, its Givens rotations and the small triangular
solve live on the host: each Arnoldi step reads its column (j + 2
values) in one transfer, and each restart cycle reads its true residual
once more (``SolveResult.syncs``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import StopType
from .common import (SMALLREAL, HostReads, abs_residual, dot, initial_norms,
                     like, replicated, residual_norms, resolve_precond,
                     zeros_rows)
from .result import SolveResult

_CR_MAX = 0.99    # cos(8 deg)  (reference: KryPvgmres.c:79)
_CR_MIN = 0.174   # cos(80 deg) (reference: KryPvgmres.c:80)
_RESTART_MIN = 3
_RESTART_DEC = 3
# stagnation bail-out: consecutive restart cycles whose true residual
# improves on the best seen by less than 0.5% end the solve with
# ERROR_SOLVER_STAG (-42) while still more than 4x from tol (the JAX
# package's rule, which keeps a solve pinned at the f32 residual floor
# from running out its whole maxit)
_STAG_FACTOR = 0.995
_MAX_STAG_CYCLES = 4
_ERROR_GMRES_STAG = -42


def gmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
          restart=25, stop_type=int(StopType.REL_RES),
          safe: bool = False) -> SolveResult:
    """Restarted right-preconditioned GMRES (reference:
    fasp_solver_dcsr_pgmres)."""
    return _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive=False, flexible=False, safe=safe)


def vgmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
           restart=25, stop_type=int(StopType.REL_RES),
           safe: bool = False) -> SolveResult:
    """Adaptive-restart GMRES (reference: fasp_solver_dcsr_pvgmres)."""
    return _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive=True, flexible=False, safe=safe)


def vfgmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
            restart=25, stop_type=int(StopType.REL_RES),
            safe: bool = False) -> SolveResult:
    """Flexible GMRES with variable restart (reference:
    fasp_solver_dcsr_pvfgmres).  The preconditioner may change from step
    to step, so the preconditioned basis Z is stored."""
    return _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive=True, flexible=True, safe=safe)


def _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
           adaptive, flexible, safe):
    M = resolve_precond(M)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(abstol)
    small = t(SMALLREAL)
    happy_tol = t(SMALLREAL * 1e-8)
    precres = stop_type == StopType.REL_PRECRES
    R = int(min(restart, maxit))
    if x0 is None:
        x0 = torch.zeros_like(b)

    x = x0
    r = b - A(x0)
    absres0, xx, r_norm = host(abs_residual(stop_type, r, M(r)),
                               dot(x0, x0), torch.sqrt(dot(r, r)))
    absres0, normr0, _, relres = initial_norms(stop_type, absres0, xx)
    done = bool(relres < tol) or bool(absres0 < abstol)

    V = zeros_rows(R + 1, b)
    Z = zeros_rows(R, b) if flexible else None
    it, cycles, cur, status = 0, 0, R, 0
    stag, stag_best = 0, relres
    best_x, best_relres = x0, relres

    while not done and it < maxit:
        # ---- one restart cycle: Arnoldi with Givens rotations ----------
        V[0] = r * (t(1.0) / r_norm if r_norm > small else t(0.0))
        H = np.zeros((R + 1, R), dtype=t)
        g = np.zeros(R + 1, dtype=t)
        g[0] = r_norm
        cs = np.zeros(R, dtype=t)
        sn = np.zeros(R, dtype=t)
        j, brk = 0, False
        while j < cur and it + j < maxit and not brk:
            z = M(V[j])
            w = A(z)
            if flexible:
                Z[j] = z
            Vj = V[:j + 1]
            h1 = replicated(Vj @ w)
            w = w - h1 @ Vj
            h2 = replicated(Vj @ w)
            w = w - h2 @ Vj
            hn_t = torch.sqrt(dot(w, w))
            *h, hn = host.vec(torch.cat([h1 + h2, hn_t.reshape(1)]))
            happy = hn <= happy_tol
            V[j + 1] = w * (t(0.0) if happy else t(1.0) / hn)

            # previous rotations on the column, then the new one
            hcol = np.zeros(R + 1, dtype=t)
            hcol[:j + 1] = h
            hcol[j + 1] = hn
            for k in range(j):
                hk, hk1 = hcol[k], hcol[k + 1]
                hcol[k] = cs[k] * hk + sn[k] * hk1
                hcol[k + 1] = -sn[k] * hk + cs[k] * hk1
            a_, b_ = hcol[j], hcol[j + 1]
            den = np.sqrt(a_ * a_ + b_ * b_)
            c, s = (a_ / den, b_ / den) if den > small else (t(1.0), t(0.0))
            hcol[j] = c * a_ + s * b_
            hcol[j + 1] = 0.0
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            H[:, j] = hcol
            cs[j], sn[j] = c, s
            brk = happy or abs(g[j + 1]) / normr0 < tol
            j += 1

        # least squares: the j x j upper-triangular system
        if j:
            y = like(torch.linalg.solve_triangular(
                torch.from_numpy(H[:j, :j].copy()),
                torch.from_numpy(g[:j].copy())[:, None],
                upper=True)[:, 0], b)
            x = x + (y @ Z[:j] if flexible else M(y @ V[:j]))
        it += j

        # ---- true residual per restart (doubles as the safeguard) ------
        r = b - A(x)
        z = M(r) if precres else r
        r_norm_old = r_norm
        r_norm, absres, xx = host(torch.sqrt(dot(r, r)),
                                  abs_residual(stop_type, r, z),
                                  dot(x, x))
        normu_new = max(small, np.sqrt(xx))
        absres, relres = residual_norms(stop_type, absres, normr0, normu_new)
        if adaptive:
            # reference rule (KryPvgmres.c:200-210)
            cr = r_norm / max(r_norm_old, small)
            shrunk = cur - _RESTART_DEC if cur - _RESTART_DEC > _RESTART_MIN \
                else R
            cur = (R if cr > _CR_MAX or cycles == 0
                   else cur if cr < _CR_MIN else shrunk)
        # stagnation against the BEST residual: a wobbling plateau must
        # improve on its best by > 0.5% to stay alive
        stag = stag + 1 if relres > _STAG_FACTOR * stag_best else 0
        stag_best = min(stag_best, relres)
        # within 4x of tol a slow last digit is not a floor stall
        stalled = stag >= _MAX_STAG_CYCLES and relres > 4.0 * tol
        done = bool(relres < tol) or j == 0 or stalled
        status = _ERROR_GMRES_STAG if stalled else 0
        cycles += 1
        if safe and relres < best_relres:
            best_x, best_relres = x, relres

    converged = bool(relres < tol)
    if safe and not converged and best_relres < relres:
        x = best_x
    return SolveResult(x=x, iters=it, relres=float(relres),
                       converged=converged, status=status, syncs=host.count)
