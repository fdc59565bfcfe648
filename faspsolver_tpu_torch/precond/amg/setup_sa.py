"""Smoothed-aggregation AMG setup (port of ``_filtered`` and ``setup_sa``
of ``faspsolver_tpu/precond/amg/setup_sa.py``).

Reference: fasp_amg_setup_sa (PreAMGSetupSA.c:63) ->
amg_setup_smoothP_smoothR: aggregation + Jacobi-smoothed tentative P
(omega = tentative_smooth, optionally on a filtered matrix), smoothed or
unsmoothed R per smooth_restriction.  The host setup is the JAX
package's; each level becomes an ``EllOperator`` with COO transfers.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from ... import np_dtype
from ...formats import CSRMatrix
from ...ops.operators import EllOperator, device_operator
from ...utils.params import AMGParam
from .aggregation import (aggregate, tentative_prolongation,
                          tentative_prolongation_nk)
from .cycles import amli_fields
from .hierarchy import AMGHierarchy, AMGLevel, make_coarse_solver
from .smoothers import build_smoother
from .transfer import csr_transfer


def _filtered(m: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Filtered matrix for prolongation smoothing (reference: smooth_filter
    ON): drop weak off-diagonal couplings, lumping them into the diagonal."""
    coo = m.tocoo()
    d = np.abs(m.diagonal())
    d = np.where(d > 0, d, 1.0)
    off = coo.row != coo.col
    weak = off & (np.abs(coo.data)
                  < theta * np.sqrt(d[coo.row] * d[coo.col]))
    lump = np.zeros(m.shape[0])
    np.add.at(lump, coo.row[weak], coo.data[weak])
    keep = ~weak
    filt = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                         shape=m.shape)
    return filt + sp.diags(lump)


def setup_sa(A: CSRMatrix, param: Optional[AMGParam] = None,
             dtype=None, nk=None, device=None) -> AMGHierarchy:
    """Build the SA-AMG hierarchy in ``dtype`` (default float64), moved to
    ``device`` if given.  ``nk``: optional (n, m) near-kernel basis; the
    tentative prolongation then carries it exactly (per-aggregate Loewdin
    orthonormalization, reference: near_kernel_basis, fasp.h:849-852)
    and the restricted basis propagates to coarser levels."""
    param = param or AMGParam()
    npdt = np_dtype(dtype)

    host_levels: List[CSRMatrix] = [A]
    Ps: List[CSRMatrix] = []

    B = None
    if nk is not None:
        B = np.atleast_2d(np.asarray(nk, dtype=np.float64))
        if B.shape[0] != A.nrow:
            B = B.T

    cur = A
    theta = param.strong_coupled
    max_levels = min(param.max_levels, 20)
    while (len(host_levels) < max_levels
           and cur.nrow > max(param.coarse_dof, 1)):
        agg, nagg = aggregate(cur, param, theta)
        if nagg >= 0.95 * cur.nrow:
            break
        if B is not None:
            Pt_m, B = tentative_prolongation_nk(agg, nagg, B)
            Pt = Pt_m.to_scipy()
        else:
            Pt = tentative_prolongation(agg, nagg).to_scipy()
        m = cur.to_scipy()
        ms = _filtered(m, theta) if param.smooth_filter else m
        d = ms.diagonal()
        d = np.where(d != 0.0, d, 1.0)
        omega = param.tentative_smooth
        # P = (I - omega D^{-1} A_f) P_tent   (one damped-Jacobi sweep)
        P = (Pt - sp.diags(omega / d) @ (ms @ Pt)).tocsr()
        R = P.T.tocsr() if param.smooth_restriction else Pt.T.tocsr()
        Ac = CSRMatrix.from_scipy((R @ m @ P).tocsr())
        Ps.append(CSRMatrix.from_scipy(P))
        host_levels.append(Ac)
        cur = Ac
        theta = theta * 0.5

    levels = []
    nlvl = len(host_levels)
    for l, Al in enumerate(host_levels):
        if l == nlvl - 1:
            levels.append(AMGLevel(A=device_operator(
                Al, dtype=npdt,
                prefer="dense" if Al.nrow <= 2048 else None)))
            break
        Pop, Rop = csr_transfer(Ps[l], dtype=npdt)
        sm = build_smoother(Al, param.smoother, relax=param.relaxation,
                            poly_degree=param.polynomial_degree, dtype=npdt)
        levels.append(AMGLevel(A=EllOperator.from_csr(Al, dtype=npdt),
                               P=Pop, R=Rop, smoother=sm))

    hier = AMGHierarchy(
        levels=levels, coarse=make_coarse_solver(host_levels[-1], npdt),
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=param.cycle_type,
        coarse_scaling=bool(param.coarse_scaling), **amli_fields(param))
    return hier if device is None else hier.to(device)
