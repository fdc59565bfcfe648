"""Multigrid smoothers (port of the JACOBI, L1DIAG, RBGS and CHEBYSHEV
kinds of ``faspsolver_tpu/precond/amg/smoothers.py``, and of
``build_smoother`` for general CSR levels).

Reference: base/src/ItrSmootherCSR.c (jacobi :98, L1DIAG),
ItrSmootherCSRpoly.c (polynomial).  Each sweep is a few elementwise ops
around the level operator's apply.  The multicolor Gauss-Seidel family
is not ported yet (ROADMAP item 7).  The Chebyshev recurrence scalars are
fixed by ``lambda_max`` and the degree, so they are computed once, at
construction, as Python floats — in the level's precision, the same
roundings the JAX package's traced scalar arithmetic makes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import as_tensor, np_dtype
from ...constants import SmootherType
from ...formats import CSRMatrix


def _opt(a) -> Optional[torch.Tensor]:
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a, copy=True))


def cheby_scalars(lambda_max, degree: int):
    """(theta, [(c1, c2) per later step]) of the Chebyshev recurrence on
    [lambda_max/4, lambda_max], computed in lambda_max's dtype."""
    lmax = np.asarray(lambda_max)
    t = lmax.dtype.type
    lmax = t(lmax)
    lmin = lmax / t(4.0)
    theta = (lmax + lmin) / t(2.0)
    delta = (lmax - lmin) / t(2.0)
    sigma1 = theta / delta
    rho = t(1.0) / sigma1
    steps = []
    for _ in range(degree - 1):
        rho_new = t(1.0) / (t(2.0) * sigma1 - rho)
        steps.append((float(rho_new * rho), float(t(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), steps


class SmootherData(nn.Module):
    """What one level's sweeps need.  ``kind`` selects the sweep."""

    def __init__(self, kind: int, relax: float, nsweep_scale: int,
                 dinv=None, l1inv=None, lambda_max=None,
                 rb_masks: Sequence = ()):
        super().__init__()
        self.kind = int(kind)
        self.relax = float(relax)
        self.nsweep_scale = int(nsweep_scale)
        self.register_buffer("dinv", _opt(dinv))
        self.register_buffer("l1inv", _opt(l1inv))
        red, black = (tuple(rb_masks) if rb_masks else (None, None))
        self.register_buffer("rb_red", _opt(red))
        self.register_buffer("rb_black", _opt(black))
        self.lambda_max = (None if lambda_max is None
                           else np.asarray(lambda_max)[()])
        if self.kind == SmootherType.CHEBYSHEV:
            self.theta, self.cheby_steps = cheby_scalars(
                self.lambda_max, self.nsweep_scale)

    @property
    def rb_masks(self):
        if self.rb_red is None:
            return ()
        return (self.rb_red, self.rb_black)


def build_smoother(A: CSRMatrix, kind: int, *, relax: float = 1.0,
                   poly_degree: int = 3, dtype=None) -> SmootherData:
    """Smoother data for a general CSR level (host setup)."""
    npdt = np_dtype(dtype)
    d = A.diagonal()
    dsafe = np.where(d != 0.0, d, 1.0)
    dinv_np = 1.0 / dsafe
    # constant vectors ship as (1,) and broadcast in the sweeps
    dinv = (dinv_np[:1] if dinv_np.size and np.all(dinv_np == dinv_np[0])
            else dinv_np)
    dinv = as_tensor(dinv, npdt)
    kind = int(kind)
    if kind in (SmootherType.JACOBI, SmootherType.JACOBIF):
        return SmootherData(int(SmootherType.JACOBI), relax, 1, dinv=dinv)
    if kind == SmootherType.L1DIAG:
        l1 = np.asarray(np.abs(A.to_scipy()).sum(axis=1)).ravel()
        l1 = np.where(l1 != 0.0, l1, 1.0)
        return SmootherData(kind, relax, 1, l1inv=as_tensor(1.0 / l1, npdt))
    if kind in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        # Chebyshev on [lambda_max/4, lambda_max] of D^-1 A; lambda_max by
        # a seeded 30-step power iteration (reference: fasp_dcsr_maxeig,
        # BlaEigen.c), or above 200k dof by the Gershgorin bound, which
        # is always an upper bound, so Chebyshev stays a damper
        if A.nrow > 200_000:
            rl = np.diff(A.indptr)
            if A.nnz and rl.min() > 0:
                l1 = np.add.reduceat(np.abs(A.data), A.indptr[:-1])
            else:
                l1 = np.asarray(np.abs(A.to_scipy()).sum(axis=1)).ravel()
            lam = float(np.max(np.abs(dinv_np) * l1))
        else:
            m = A.to_scipy()
            v = np.random.default_rng(0).standard_normal(A.nrow)
            lam = 1.0
            for _ in range(30):
                w = dinv_np * (m @ v)
                lam = max(np.linalg.norm(w), 1e-30)
                v = w / lam
            # inflate: an underestimate makes Chebyshev amplify the top
            # of the spectrum instead of damping it
            lam = max(lam, 1e-8) * 1.1
        return SmootherData(int(SmootherType.CHEBYSHEV), relax, poly_degree,
                            dinv=dinv, lambda_max=np.asarray(lam, npdt))
    raise NotImplementedError(
        f"smoother kind {kind} on a general CSR level is not ported "
        f"(the multicolor Gauss-Seidel family waits, ROADMAP item 7)")


def smooth(sm: SmootherData, A, x, b, nsweeps: int, forward: bool):
    """Apply ``nsweeps`` smoothing sweeps.  ``forward`` orders the
    red-black sweeps so pre/post smoothing are adjoint (reference:
    PreMGSmoother.inl:20-230)."""
    kind = sm.kind
    for _ in range(nsweeps):
        if kind == SmootherType.JACOBI:
            x = x + sm.relax * sm.dinv * (b - A(x))
        elif kind == SmootherType.L1DIAG:
            x = x + sm.l1inv * (b - A(x))
        elif kind == SmootherType.CHEBYSHEV:
            x = _cheby_smooth(sm, A, x, b)
        elif kind == SmootherType.RBGS:
            # exact red-black Gauss-Seidel as two masked full-stencil
            # updates (reference: ItrSmootherRBGS.inl)
            masks = sm.rb_masks if forward else sm.rb_masks[::-1]
            w = sm.relax
            for mask in masks:
                upd = sm.dinv * (b - A(x))
                x = x + (w * mask) * upd if w != 1.0 else x + mask * upd
        else:
            raise ValueError(f"unsupported smoother kind {kind}")
    return x


def _cheby_smooth(sm: SmootherData, A, x, b):
    """Chebyshev polynomial smoother of degree ``nsweep_scale`` on the
    Jacobi-scaled operator, damping [lambda_max/4, lambda_max]
    (reference: ItrSmootherCSRpoly.c fasp_smoother_dcsr_poly)."""
    r = sm.dinv * (b - A(x))
    d = r / sm.theta
    x = x + d
    for c1, c2 in sm.cheby_steps:
        r = sm.dinv * (b - A(x))
        d = c1 * d + c2 * r
        x = x + d
    return x
