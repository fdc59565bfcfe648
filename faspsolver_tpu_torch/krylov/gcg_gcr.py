"""GCG and GCR: restarted full-orthogonalisation descent methods (port of
``faspsolver_tpu/krylov/gcg_gcr.py``).

Reference: base/src/KryPgcg.c (generalized CG) and KryPgcr.c
(generalized conjugate residual).  Both keep a window of previous
directions as dense (restart, n) tensors, orthogonalised by CGS2 as the
GMRES basis is.  Each descent step reads its direction norm and residual
norm in one transfer, each restart cycle its true residual once more
(``SolveResult.syncs``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import StopType
from .common import (SMALLREAL, HostReads, abs_residual, initial_norms,
                     residual_norms, resolve_precond)
from .result import SolveResult


def gcr(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
        restart=25, stop_type=int(StopType.REL_RES)) -> SolveResult:
    """Restarted GCR (reference: fasp_solver_dcsr_pgcr, KryPgcr.c)."""
    M = resolve_precond(M)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(abstol)
    small = t(SMALLREAL)
    R = int(min(restart, maxit))
    if x0 is None:
        x0 = torch.zeros(A.shape[0], dtype=b.dtype, device=b.device)
    n = b.shape[0]

    x = x0
    r = b - A(x0)
    absres0, normr0, _, relres = initial_norms(
        stop_type, *host(abs_residual(stop_type, r, M(r)),
                         torch.dot(x0, x0)))
    done = bool(relres < tol) or bool(absres0 < abstol)
    P = torch.zeros((R, n), dtype=b.dtype, device=b.device)   # directions
    Q = torch.zeros((R, n), dtype=b.dtype, device=b.device)   # A P, normed
    it = 0

    while not done and it < maxit:
        j, brk = 0, False
        while j < R and it + j < maxit and not brk:
            p = M(r)
            q = A(p)
            # orthogonalise q against the window (CGS2), p alongside
            Pj, Qj = P[:j], Q[:j]
            h1 = Qj @ q
            p = p - h1 @ Pj
            q = q - h1 @ Qj
            h2 = Qj @ q
            p = p - h2 @ Pj
            q = q - h2 @ Qj
            qn = torch.sqrt(torch.dot(q, q))
            bad = qn <= SMALLREAL
            inv = torch.where(bad, torch.zeros_like(qn),
                              1.0 / torch.where(bad, torch.ones_like(qn), qn))
            p = p * inv
            q = q * inv
            alpha = torch.dot(q, r)
            x = x + alpha * p
            r = r - alpha * q
            P[j] = p
            Q[j] = q
            qn_h, rn = host(qn, torch.sqrt(torch.dot(r, r)))
            brk = qn_h <= small or rn / normr0 < tol
            j += 1
        it += j
        # true residual per cycle
        r = b - A(x)
        z = M(r) if stop_type == StopType.REL_PRECRES else r
        absres, xx = host(abs_residual(stop_type, r, z), torch.dot(x, x))
        relres = residual_norms(stop_type, absres, normr0,
                                max(small, np.sqrt(xx)))[1]
        done = bool(relres < tol) or j == 0

    return SolveResult(x=x, iters=it, relres=float(relres),
                       converged=bool(relres < tol), status=0,
                       syncs=host.count)


def gcg(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
        restart=None, stop_type=int(StopType.REL_RES)) -> SolveResult:
    """Generalized CG (reference: fasp_solver_dcsr_pgcg, KryPgcg.c).

    The reference stores ALL MaxIt directions (KryPgcg.c:70 allocates
    MaxIt*m: full-memory descent, its itparam restart ignored), so the
    default window is the full maxit, capped so the two (R, n) direction
    buffers stay within 2 GiB of device memory.  Pass ``restart`` for a
    smaller window.  It runs GCR's minimal-residual engine over the
    preconditioned residual directions; for SPD systems full-memory GCG
    coincides with CG in exact arithmetic."""
    if restart is None:
        budget = 2 << 30                   # bytes across P and Q buffers
        per_dir = 2 * b.shape[0] * b.element_size()
        restart = max(8, min(int(maxit), 1024, budget // max(per_dir, 1)))
    return gcr(A, b, x0, M, tol=tol, abstol=abstol, maxit=maxit,
               restart=restart, stop_type=stop_type)
