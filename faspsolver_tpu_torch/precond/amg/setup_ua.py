"""Unsmoothed-aggregation AMG setup (port of ``setup_ua`` and
``build_hierarchy_from_host`` of ``faspsolver_tpu/precond/amg/setup_ua.py``).

Reference: fasp_amg_setup_ua (PreAMGSetupUA.c:55) ->
amg_setup_unsmoothP_unsmoothR (:101): per level {aggregate -> boolean
tentative P -> Ac = P^T A P (rap_agg)} until the coarse grid is small,
with an adaptive strength threshold per level (:234-238) and graceful
termination when aggregation stalls.  Each level becomes an
``EllOperator`` with gather / segment-sum transfers (no P matrix).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ... import np_dtype
from ...constants import AggregationType, CycleType
from ...formats import CSRMatrix
from ...ops.operators import EllOperator, device_operator
from ...utils.params import AMGParam
from .aggregation import _rap_boolean, aggregate
from .cycles import amli_fields
from .hierarchy import AMGHierarchy, AMGLevel, make_coarse_solver
from .smoothers import build_smoother
from .transfer import AggProlong, AggRestrict


def setup_ua(A: CSRMatrix, param: Optional[AMGParam] = None,
             dtype=None, structured: Optional[bool] = None,
             device=None) -> AMGHierarchy:
    """Build the UA-AMG hierarchy in ``dtype`` (default float64), moved to
    ``device`` if given.  Above 100k dof a PAIRWISE / NPAIR request takes
    the structured hierarchy (pairwise aggregation specialised to the
    grid) when the matrix has one; ``structured`` forces the choice."""
    param = param or AMGParam()
    npdt = np_dtype(dtype)

    if structured is None:
        compatible = int(param.aggregation_type) in (
            int(AggregationType.PAIRWISE), int(AggregationType.NPAIR))
        structured = A.nrow > 100_000 and compatible
    if structured:
        from .structured import setup_structured
        hier = setup_structured(A, param, dtype=npdt, device=device)
        if hier is not None:
            return hier

    host_levels: List[CSRMatrix] = [A]
    aggs: List[Tuple[np.ndarray, int]] = []

    cur = A
    theta = param.strong_coupled
    max_levels = min(param.max_levels, 20)
    while (len(host_levels) < max_levels
           and cur.nrow > max(param.coarse_dof, 1)):
        agg, nagg = aggregate(cur, param, theta)
        if nagg >= 0.95 * cur.nrow:   # aggregation stalled -> stop here
            break
        Ac = _rap_boolean(cur, agg, nagg)
        aggs.append((agg, nagg))
        # adaptive per-level strength threshold
        # (reference: PreAMGSetupUA.c:234-238)
        if nagg * 4.0 > cur.nrow:
            theta *= 0.5
        elif nagg * 1.25 < cur.nrow:
            theta *= 2.0
        host_levels.append(Ac)
        cur = Ac

    hier = build_hierarchy_from_host(host_levels, aggs, param, npdt)
    return hier if device is None else hier.to(device)


def build_hierarchy_from_host(host_levels: List[CSRMatrix],
                              aggs: List[Tuple[np.ndarray, int]],
                              param: AMGParam, dtype) -> AMGHierarchy:
    """Host CSR levels + aggregation maps -> the hierarchy (on the CPU)."""
    npdt = np_dtype(dtype)
    levels = []
    nlvl = len(host_levels)
    for l, Al in enumerate(host_levels):
        if l == nlvl - 1:
            levels.append(AMGLevel(A=device_operator(
                Al, dtype=npdt,
                prefer="dense" if Al.nrow <= 2048 else None)))
            break
        agg, nagg = aggs[l]
        sm = build_smoother(Al, param.smoother, relax=param.relaxation,
                            poly_degree=param.polynomial_degree, dtype=npdt)
        P = AggProlong.from_agg(agg, nagg)
        levels.append(AMGLevel(
            A=EllOperator.from_csr(Al, dtype=npdt), P=P,
            R=AggRestrict(P.agg, len(agg), int(nagg)), smoother=sm))

    # UA cycle-robustness rule (reference: amg_setup_unsmoothP_unsmoothR
    # tail, PreAMGSetupUA.c:110,384-402): per-level coarse-visit counts
    # xsi^lvl / (eta * fracratio * icum), clamped to [1, 2], read by the
    # NL-AMLI cycle (PreMGRecurAMLI.c:385); an operator complexity above
    # cplxmax = 3.0 upgrades a V-cycle request to nonlinear AMLI
    cycle_type = param.cycle_type
    nnz0 = max(host_levels[0].nnz, 1)
    op_cplx = sum(h.nnz for h in host_levels) / nnz0
    cplxmax, xsi = 3.0, 0.6
    if op_cplx > cplxmax and cycle_type == int(CycleType.V):
        cycle_type = int(CycleType.NL_AMLI)
    level_visits = ()
    if nlvl > 2:
        eta = xsi / ((1.0 - xsi) * (cplxmax - 1.0))
        icum = 1
        visits = [1]
        for lvl in range(1, nlvl - 1):
            frac = host_levels[lvl].nnz / nnz0
            v = max(1, min(2, int(xsi ** lvl / (eta * frac * icum))))
            visits.append(v)
            icum *= v
        level_visits = tuple(visits)

    return AMGHierarchy(
        levels=levels, coarse=make_coarse_solver(host_levels[-1], npdt),
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=cycle_type,
        coarse_scaling=bool(param.coarse_scaling),
        level_visits=level_visits, **amli_fields(param))
