"""BSR-native aggregation AMG setups, the reservoir path (port of
``faspsolver_tpu/precond/amg/setup_bsr.py``).

Reference: fasp_amg_setup_ua_bsr (PreAMGSetupUABSR.c:55) and
fasp_amg_setup_sa_bsr (PreAMGSetupSABSR.c:61): condense the blocks to a
scalar strength graph (condenseBSR, PreAMGAggregationBSR.inl:20),
aggregate there, expand the boolean P to blocks, block RAP
(fasp_blas_dbsr_rap), per-level precomputed block-diagonal inverses.

The block RAP with a boolean P is a segment sum over the (nnzb, nb, nb)
block array, with no sparse product; the levels carry a BsrEllOperator
and block multicolor smoothers.  Host code (NumPy / scipy); the result is
a CPU module tree that ``device=`` or a later ``.to(device)`` moves.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ... import as_tensor, np_dtype
from ...constants import AggregationType
from ...formats import BSRMatrix
from ...ops.operators import BsrEllOperator
from ...utils.params import AMGParam
from .aggregation import aggregate_pairwise, aggregate_vmb
from .bsr_smoothers import build_bsr_smoother
from .cycles import amli_fields
from .hierarchy import (AMGHierarchy, AMGLevel, NearKernel,
                        make_coarse_solver)
from .transfer import BlockAggProlong, BlockAggRestrict


def _near_kernel_data(B: np.ndarray, A_host: BSRMatrix, dtype) -> NearKernel:
    """NearKernel of one level: Ainv = pinv(B^T A B) on the host
    (reference: A_nk = R_nk A P_nk, PreAMGSetupUABSR.c:265)."""
    m = A_host.to_scipy().tocsr()
    gram = B.T @ (m @ B)
    return NearKernel(as_tensor(B, dtype),
                      as_tensor(np.linalg.pinv(gram), dtype))


def _restrict_basis_agg(B: np.ndarray, agg: np.ndarray, nagg: int,
                        nb: int) -> np.ndarray:
    """B_{l+1} = R_l B_l for the boolean block-aggregation restriction
    (reference: P_nk_{l+1} = R_l P_nk_l, PreAMGSetupUABSR.c:262)."""
    n = len(agg)
    m = B.shape[1]
    out = np.zeros((nagg, nb, m), dtype=B.dtype)
    np.add.at(out, agg, B.reshape(n, nb, m))
    return out.reshape(nagg * nb, m)


def _block_rap_agg(A: BSRMatrix, agg: np.ndarray, nagg: int) -> BSRMatrix:
    """Ac = P^T A P with boolean block P: the fine blocks summed into
    their coarse (agg[row], agg[col]) slots, one segment reduction
    (reference: fasp_blas_dbsr_rap specialized to boolean P)."""
    rows = np.repeat(np.arange(A.nrow_block), np.diff(A.indptr))
    key = agg[rows] * nagg + agg[A.indices]
    order = np.argsort(key, kind="stable")
    uniq, start = np.unique(key[order], return_index=True)
    sums = np.add.reduceat(A.data[order], start, axis=0)
    out_rows = (uniq // nagg).astype(np.int64)
    out_cols = (uniq % nagg).astype(np.int64)
    indptr = np.zeros(nagg + 1, dtype=np.int64)
    np.add.at(indptr, out_rows + 1, 1)
    return BSRMatrix(np.cumsum(indptr), out_cols, sums, (nagg, nagg))


def _from_scipy_bsr(m, shape) -> BSRMatrix:
    return BSRMatrix(m.indptr.astype(np.int64), m.indices.astype(np.int64),
                     np.ascontiguousarray(m.data), shape)


def _coarsen_levels(A: BSRMatrix, param: AMGParam, product: Callable
                    ) -> Tuple[List[BSRMatrix], list]:
    """The aggregation loop both setups share: aggregate on the condensed
    (signed L-inf, condenseBSRLinf) graph until the level is small, with
    the reference's adaptive VMB threshold (PreAMGSetupUABSR.c:199-206).
    ``product(cur, agg, nagg)`` returns (coarse matrix, what the level
    keeps for its transfers)."""
    host_levels: List[BSRMatrix] = [A]
    kept = []
    cur = A
    theta = param.strong_coupled
    max_levels = min(param.max_levels, 20)
    while (len(host_levels) < max_levels
           and cur.nrow_block > max(param.coarse_dof // max(cur.nb, 1), 8)):
        cond = cur.condense(norm_type=0)
        if param.aggregation_type == AggregationType.VMB:
            agg, nagg = aggregate_vmb(cond, theta, param.max_aggregation)
            if nagg * 4 > cond.nrow:
                theta /= 8.0
            elif nagg * 1.25 < cond.nrow:
                theta *= 1.5
        else:
            agg, nagg = aggregate_pairwise(cond, param.pair_number,
                                           param.quality_bound)
        if nagg >= cur.nrow_block:
            break
        Ac, keep = product(cur, agg, int(nagg))
        kept.append(keep)
        host_levels.append(Ac)
        cur = Ac
    return host_levels, kept


def _build_hierarchy(host_levels, transfers: Callable,
                     restrict_basis: Callable, param: AMGParam, npdt, nk,
                     device) -> AMGHierarchy:
    """Levels from the host matrices: ``transfers(l)`` gives level l's
    (P, R) modules, ``restrict_basis(l, B)`` the near-kernel basis of the
    next level."""
    A = host_levels[0]
    B = None
    if nk is not None:
        B = np.atleast_2d(np.asarray(nk, dtype=np.float64))
        if B.shape[0] != A.nrow:
            B = B.T
    levels = []
    last = len(host_levels) - 1
    for l, Al in enumerate(host_levels):
        nk_data = _near_kernel_data(B, Al, npdt) if B is not None else None
        Aop = BsrEllOperator.from_bsr(Al, dtype=npdt)
        if l == last:
            levels.append(AMGLevel(A=Aop, nk=nk_data))
            break
        P, R = transfers(l)
        sm = build_bsr_smoother(Al, param.smoother, relax=param.relaxation,
                                dtype=npdt)
        levels.append(AMGLevel(A=Aop, P=P, R=R, smoother=sm, nk=nk_data))
        if B is not None:
            B = restrict_basis(l, B)
    hier = AMGHierarchy(
        levels=levels, coarse=make_coarse_solver(host_levels[-1], npdt),
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=param.cycle_type,
        coarse_scaling=bool(param.coarse_scaling), **amli_fields(param))
    return hier if device is None else hier.to(device)


def setup_ua_bsr(A: BSRMatrix, param: Optional[AMGParam] = None,
                 dtype=None, nk: Optional[np.ndarray] = None,
                 device=None) -> AMGHierarchy:
    """BSR unsmoothed-aggregation setup in ``dtype`` (default float64),
    moved to ``device`` if given.  ``nk``: optional (n*nb, m) near-kernel
    basis carried down the hierarchy (restricted per level) with the
    cycle-level correction enabled (reference:
    fasp_solver_dbsr_krylov_nk_amg, SolBSR.c:634;
    PreAMGSetupUABSR.c:241-266)."""
    param = param or AMGParam()
    npdt = np_dtype(dtype)
    host_levels, aggs = _coarsen_levels(
        A, param, lambda cur, agg, nagg: (_block_rap_agg(cur, agg, nagg),
                                          (agg, nagg)))

    def transfers(l):
        agg, nagg = aggs[l]
        Al = host_levels[l]
        a32 = as_tensor(agg.astype(np.int32))
        return (BlockAggProlong(a32, Al.nrow_block, nagg, Al.nb),
                BlockAggRestrict(a32, Al.nrow_block, nagg, Al.nb))

    def restrict_basis(l, B):
        agg, nagg = aggs[l]
        return _restrict_basis_agg(B, agg, nagg, host_levels[l].nb)

    return _build_hierarchy(host_levels, transfers, restrict_basis, param,
                            npdt, nk, device)


def _smoothed_block_product(omega: float):
    def product(cur: BSRMatrix, agg: np.ndarray, nagg: int):
        # block tentative P (identity blocks) smoothed by damped block
        # Jacobi, P = (I - w D^-1 A) P_tent, in scipy's BSR space
        nb = cur.nb
        nrb = cur.nrow_block
        m = cur.to_scipy().tobsr(blocksize=(nb, nb))
        ptr = np.arange(nrb + 1, dtype=np.int64)
        eye = np.broadcast_to(np.eye(nb), (nrb, nb, nb))
        Pt = sp.bsr_matrix((np.ascontiguousarray(eye), agg.astype(np.int64),
                            ptr), shape=(nrb * nb, nagg * nb),
                           blocksize=(nb, nb))
        Dinv = sp.bsr_matrix((np.ascontiguousarray(cur.diag_inv()),
                              np.arange(nrb, dtype=np.int64), ptr),
                             shape=(nrb * nb, nrb * nb), blocksize=(nb, nb))
        P = (Pt - omega * (Dinv @ (m @ Pt))).tobsr(blocksize=(nb, nb))
        Ac = (P.T @ m @ P).tobsr(blocksize=(nb, nb))
        return (_from_scipy_bsr(Ac, (nagg, nagg)),
                _from_scipy_bsr(P, (nrb, nagg)))
    return product


def setup_sa_bsr(A: BSRMatrix, param: Optional[AMGParam] = None,
                 dtype=None, nk: Optional[np.ndarray] = None,
                 device=None) -> AMGHierarchy:
    """BSR smoothed-aggregation setup (reference: fasp_amg_setup_sa_bsr,
    PreAMGSetupSABSR.c:61): the tentative block P is smoothed with one
    damped block-Jacobi sweep and the Galerkin product taken on the
    smoothed P, host-side through scipy's BSR product.  The smoothed
    block P is a general BSR matrix, so the transfers are a BsrEllOperator
    pair (P, P^T) and not boolean block gathers."""
    param = param or AMGParam()
    npdt = np_dtype(dtype)
    nb = A.nb
    host_levels, Ps = _coarsen_levels(
        A, param, _smoothed_block_product(param.tentative_smooth))

    def transfers(l):
        P = Ps[l]
        PT = _from_scipy_bsr(P.to_scipy().T.tobsr(blocksize=(nb, nb)),
                             (P.shape[1], P.shape[0]))
        return (BsrEllOperator.from_bsr(P, dtype=npdt),
                BsrEllOperator.from_bsr(PT, dtype=npdt))

    def restrict_basis(l, B):
        return np.asarray(Ps[l].to_scipy().T @ B)

    return _build_hierarchy(host_levels, transfers, restrict_basis, param,
                            npdt, nk, device)
