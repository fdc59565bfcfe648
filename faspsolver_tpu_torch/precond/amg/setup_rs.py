"""Classical Ruge-Stuben AMG setup (port of ``_rap``, ``_smoothing_bands``
and ``setup_rs`` of ``faspsolver_tpu/precond/amg/setup_rs.py``).

Reference: fasp_amg_setup_rs (PreAMGSetupRS.c:52): per level
{coarsen -> guards -> interpolate -> R = P^T -> A_c = R A P} with the
graceful-degradation guards of :161-270.  The host setup (coarsening,
interpolation, Galerkin products) is the JAX package's code over the same
native C++ entries, so the f64 hierarchies agree; each level then gets
the operator its sparsity shape wants (``best_operator``): a factored
stencil (CUDA kernel) for the fine level of a grid problem, constant or
full bands with a COO remainder for the classical coarse levels.  The
result is a CPU module tree; ``device=`` (or a later ``.to(device)``)
moves it in one call.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import List, Optional

import numpy as np

from ... import as_tensor, np_dtype
from ...constants import CGPT, InterpType
from ...formats import CSRMatrix
from ...ops.operators import (CooOperator, DiaOperator, EllOperator,
                              best_operator, device_operator)
from ...utils.params import AMGParam
from .coarsen_rs import coarsen
from .hierarchy import AMGHierarchy, AMGLevel, make_coarse_solver
from .interp import interpolate
from .smoothers import build_smoother
from .transfer import banded_transfer, csr_transfer


def _rap(P: CSRMatrix, A: CSRMatrix, R: CSRMatrix) -> CSRMatrix:
    """Galerkin product A_c = R A P: the native fused kernel (the
    reference's fasp_blas_dcsr_rap, BlaSpmvCSR.c:999 analog), scipy's two
    SpGEMMs without it.  Both give the same sparsity; values differ by
    summation order (~1e-14)."""
    from ... import native
    out = native.rap(R, A, P)
    if out is not None:
        return out
    return CSRMatrix.from_scipy(
        (R.to_scipy() @ A.to_scipy() @ P.to_scipy()).tocsr())


# most diagonals kept by the filtered smoothing operator
_SMOOTH_MAX_BANDS = 64


def _smoothing_bands(Al: CSRMatrix, dtype):
    """Banded smoothing operator for a level whose exact operator is
    ELL/COO: the top-k diagonals (symmetric-pair completed) plus row-sum
    compensation on the diagonal for everything dropped (the SA
    smooth_filter rule).  Only the smoother sees it; residuals and
    transfers keep the exact operator."""
    npdt = np_dtype(dtype)
    n = Al.nrow
    rows = np.repeat(np.arange(n, dtype=np.int64), Al.row_nnz())
    off = Al.indices.astype(np.int64) - rows
    hist = np.bincount(off + n, minlength=2 * n + 1)
    cand = np.nonzero(hist)[0]
    order = cand[np.argsort(-hist[cand])][:_SMOOTH_MAX_BANDS]
    if n not in order:                     # always keep the diagonal
        order = np.concatenate([order, [n]])
    mirror = 2 * n - order
    extra = mirror[(hist[mirror] > 0) & ~np.isin(mirror, order)]
    if extra.size:
        order = np.concatenate([order, extra])
    keep = np.sort(order.astype(np.int64) - n)
    slot = np.full(2 * n + 1, -1, dtype=np.int32)
    slot[keep + n] = np.arange(len(keep), dtype=np.int32)
    s = slot[off + n]
    inb = s >= 0
    bands = np.zeros((len(keep), n), dtype=npdt)
    bands[s[inb], rows[inb]] = Al.data[inb]
    if not inb.all():
        comp = np.bincount(rows[~inb], weights=Al.data[~inb], minlength=n)
        z = int(np.flatnonzero(keep == 0)[0])
        bands[z] += comp.astype(npdt)
    return DiaOperator(as_tensor(bands), keep, n)


def _fine64(A: CSRMatrix):
    """Exact f64 fine operator for the refinement's true residuals: the
    structured setup's factored stencil when the matrix is a detectable
    grid and the stencil is small enough, else the adaptive-format f64
    operator."""
    from ... import native
    from ...ops.operators import dia_bands_from_csr
    from .structured import detect_dims, stencil_fine64
    # count distinct offsets before materializing bands: the NumPy band
    # fallback allocates (k, n) densely
    hist = native.dia_hist(A)
    if hist is not None:
        n_offs = int(np.count_nonzero(hist))
    else:
        r = np.repeat(np.arange(A.nrow, dtype=np.int64), np.diff(A.indptr))
        n_offs = np.unique(A.indices.astype(np.int64) - r).size
    if n_offs <= 36:
        offs, flat = dia_bands_from_csr(A)
        dims = detect_dims(offs, A.nrow)
        cand = None if dims is None else stencil_fine64(offs, flat, dims)
        if cand is not None:
            return cand
    est = A.nnz * 12
    if est > (256 << 20):
        warnings.warn(f"keep_f64_fine: unstructured fine level costs "
                      f"~{est / 1e6:.0f} MB of f64 device storage")
    return best_operator(A, dtype=np.float64)


def setup_rs(A: CSRMatrix, param: Optional[AMGParam] = None,
             dtype=None, keep_f64_fine: bool = False,
             timings: Optional[dict] = None,
             filter_smoother: bool = False,
             device=None) -> AMGHierarchy:
    """Build the classical RS-AMG hierarchy in ``dtype`` (default
    float64).

    ``keep_f64_fine`` attaches the exact f64 fine operator
    (``hier.fine64``) that mixed-precision refinement needs.
    ``timings`` (a dict) accumulates seconds per setup phase (coarsen /
    interp / rap / transfer / smoother / format).  ``filter_smoother``
    lets small ELL/COO levels smooth through a banded approximation
    (``AMGLevel.Asm``); off, every level smooths with its exact
    operator."""
    def _tick(key, t0):
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + (time.perf_counter() - t0)

    param = param or AMGParam()
    npdt = np_dtype(dtype)
    if param.ILU_levels > 0 or param.SWZ_levels > 0:
        raise NotImplementedError("ILU / Schwarz level smoothers are not "
                                  "ported (ROADMAP item 11)")
    if timings is not None and "host_cores" not in timings:
        timings["host_cores"] = os.cpu_count() or 1

    host_levels: List[CSRMatrix] = [A]
    Ps: List[CSRMatrix] = []
    markers: List[np.ndarray] = []

    cur = A
    max_levels = min(param.max_levels, 20)
    method = {5: "pmis", 3: "cr"}.get(int(param.coarsening_type), "rs")
    while (len(host_levels) < max_levels
           and cur.nrow > max(param.coarse_dof, 1)):
        lvl_method = method
        # aggressive coarsening on the first `aggressive_level` levels
        # (reference: AMG_aggressive_level / cfsplitting_agg)
        if method == "rs" and len(host_levels) - 1 < param.aggressive_level:
            lvl_method = "aggressive"
        t0 = time.perf_counter()
        marker, S = coarsen(cur, theta=param.strong_threshold,
                            max_row_sum=param.max_row_sum,
                            method=lvl_method,
                            aggressive_path=param.aggressive_path)
        _tick("coarsen_s", t0)
        nc = int((marker == CGPT).sum())
        # guards (reference: PreAMGSetupRS.c:161-270): coarsening failed
        # or stalled, too aggressive, or more than 10x in one step (the
        # strength graph barely connects the grid)
        if nc == 0 or nc >= cur.nrow or nc < 2 or cur.nrow > 10 * nc:
            break
        t0 = time.perf_counter()
        # aggressive coarsening pairs with standard interpolation, whose
        # F-F elimination reaches the 2-hop C points (reference:
        # cfsplitting_agg + interp_STD)
        itype = (int(InterpType.STANDARD) if lvl_method == "aggressive"
                 else param.interpolation_type)
        P = interpolate(cur, marker, S, interp_type=itype,
                        trunc_threshold=param.truncation_threshold)
        _tick("interp_s", t0)
        t0 = time.perf_counter()
        Ac = _rap(P, cur, P.transpose())
        _tick("rap_s", t0)
        # density guard: stop if the coarse operator is getting too dense
        if Ac.nnz > 0.8 * Ac.nrow * Ac.nrow and Ac.nrow > 64:
            break
        Ps.append(P)
        markers.append(marker)
        host_levels.append(Ac)
        cur = Ac

    levels = []
    nlvl = len(host_levels)
    for l, Al in enumerate(host_levels):
        if l == nlvl - 1:
            levels.append(AMGLevel(A=device_operator(
                Al, dtype=npdt,
                prefer="dense" if Al.nrow <= 2048 else None)))
            break
        # coarse dofs embedded at their C points' fine positions, so P/R
        # become shifted reads; COO when P does not band-compress
        t0 = time.perf_counter()
        bt = banded_transfer(Ps[l], np.flatnonzero(markers[l] == CGPT),
                             dtype=npdt)
        Pop, Rop = bt if bt is not None else csr_transfer(Ps[l], dtype=npdt)
        _tick("transfer_s", t0)
        t0 = time.perf_counter()
        sm = build_smoother(Al, param.smoother, relax=param.relaxation,
                            poly_degree=param.polynomial_degree, dtype=npdt)
        _tick("smoother_s", t0)
        t0 = time.perf_counter()
        Aop = best_operator(Al, dtype=npdt)
        Asm = None
        if filter_smoother and isinstance(Aop, (EllOperator, CooOperator)) \
                and Al.nrow <= 32768:
            # small gather-based level: band-approximate smoothing (the
            # JAX package's hybrid-level branch sits behind a gate no
            # level reaches, rem >= 2^60, and is not ported)
            Asm = _smoothing_bands(Al, npdt)
        levels.append(AMGLevel(A=Aop, P=Pop, R=Rop, smoother=sm, Asm=Asm))
        _tick("format_s", t0)

    coarse = make_coarse_solver(host_levels[-1], npdt)
    fine64 = _fine64(A) if keep_f64_fine else None

    hier = AMGHierarchy(
        levels=levels, coarse=coarse,
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=param.cycle_type,
        coarse_scaling=bool(param.coarse_scaling), fine64=fine64)
    return hier if device is None else hier.to(device)
