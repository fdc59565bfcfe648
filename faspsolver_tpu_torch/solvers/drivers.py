"""User-facing solver drivers: params -> preconditioner setup -> Krylov
(port of ``faspsolver_tpu/solvers/drivers.py``).

Reference: base/src/SolCSR.c (fasp_solver_dcsr_itsolver :56, _krylov
:249, _krylov_diag :341, _krylov_swz :401, _krylov_amg :476, _krylov_ilu
:588, _krylov_ilu_M :668, _krylov_amg_nk :748), SolBSR.c (_krylov_diag
:186, _krylov_ilu :286, _krylov_amg :349, _krylov_amg_nk :476,
_krylov_nk_amg :634), SolSTR.c (_krylov_diag :175, _krylov_ilu :236,
_krylov_blockgs :323), SolBLC.c (_krylov_block3/4 :188, :390,
_krylov_sweeping :507), SolAMG.c:49 (fasp_solver_amg with its GMRES
fallback :128-135), SolFAMG.c.

Every driver takes ``dtype`` (``None``: float64) and ``device``
(``None``: the device of an operator or preconditioner passed in already
on one, else the CUDA device; without one it raises, and ``"cpu"`` asks
for the CPU).  It builds on the host, moves what it built with
``.to(device)`` and returns a ``SolveResult`` whose ``x`` lies on
``device``.  The ILU and Schwarz drivers choose the operator of a CSR
matrix with ``best_operator``, so a grid matrix applies through the
stencil kernel.  Every driver takes the matrix families the JAX
package's does: CSR and BSR everywhere, an STR matrix in the
unpreconditioned, diagonal, ILU and block-smoother drivers, a BLC matrix
in the unpreconditioned, block and sweeping drivers.  The AMG drivers
raise a TypeError for STR and BLC matrices, and ``solve_amg`` answers it
with its GMRES fallback, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import as_tensor, default_device, torch_dtype
from ..constants import AMGType, SolverType
from ..formats import BLCMatrix, BSRMatrix, CSRMatrix, STRMatrix
from ..krylov import (BlockJacobiPrecond, JacobiPrecond, SolveResult,
                      bicgstab, gcg, gcr, gmres, minres, pcg, vfgmres, vgmres)
from ..ops.operators import best_operator, device_operator
from ..ops.str_ops import StrOperator
from ..precond import (AMGNKPrecond, AMGPrecond, setup_blc_precond,
                       setup_blc_sweeping, setup_bsr_ilu0, setup_ilu,
                       setup_schwarz, setup_str_blockgs, setup_str_diag,
                       setup_str_ilu, setup_str_schwarz)
from ..precond.blc_precond import BlcOperator
from ..precond.amg import (amg_solve, famg_solve, setup_rs, setup_sa,
                           setup_sa_bsr, setup_ua, setup_ua_bsr)
from ..utils import messages
from ..utils.errors import FaspError
from ..utils.params import AMGParam, ILUParam, ITSParam, SWZParam

_KRYLOV = {
    int(SolverType.CG): pcg,
    int(SolverType.BICGSTAB): bicgstab,
    int(SolverType.MINRES): minres,
    int(SolverType.GMRES): gmres,
    int(SolverType.VGMRES): vgmres,
    int(SolverType.VFGMRES): vfgmres,
    int(SolverType.GCG): gcg,
    int(SolverType.GCR): gcr,
}
_SAFE = {
    int(SolverType.SCG): pcg,
    int(SolverType.SBICGSTAB): bicgstab,
    int(SolverType.SMINRES): minres,
    int(SolverType.SGMRES): gmres,
    int(SolverType.SVGMRES): vgmres,
    int(SolverType.SVFGMRES): vfgmres,
}
_SAFE_RESTARTED = {int(SolverType.SGMRES), int(SolverType.SVGMRES),
                   int(SolverType.SVFGMRES)}
_BASE_TO_SAFE = {
    int(SolverType.CG): int(SolverType.SCG),
    int(SolverType.BICGSTAB): int(SolverType.SBICGSTAB),
    int(SolverType.MINRES): int(SolverType.SMINRES),
    int(SolverType.GMRES): int(SolverType.SGMRES),
    int(SolverType.VGMRES): int(SolverType.SVGMRES),
    int(SolverType.VFGMRES): int(SolverType.SVFGMRES),
}


class _NoAMGFormat(TypeError):
    """An STR or BLC matrix given to an AMG setup, which takes CSR and
    BSR matrices (the JAX package's setups raise a TypeError from
    ``device_operator`` for them)."""


# host-setup failures that send solve_amg to its GMRES fallback; an
# unported option and anything raised on the device are not among them
_SETUP_ERRORS = (FaspError, ValueError, np.linalg.LinAlgError, _NoAMGFormat)


def _resolve_device(device, *placed) -> torch.device:
    """``device`` when given; else the device of the first of ``placed``
    (operators, preconditioners) that already holds tensors; else the
    CUDA device (``default_device`` raises where there is none)."""
    if device is not None:
        return torch.device(device)
    for obj in placed:
        if isinstance(obj, torch.nn.Module):
            for t in obj.buffers():
                return t.device
    return default_device()


def _as_operator(A, dtype, device):
    """The operator of a host CSR, BSR, STR or BLC matrix on ``device``,
    or A itself when it is already an operator."""
    if isinstance(A, (CSRMatrix, BSRMatrix)):
        op = device_operator(A, dtype=dtype)
    elif isinstance(A, STRMatrix):
        op = StrOperator.from_str(A, dtype=dtype)
    elif isinstance(A, BLCMatrix):
        op = BlcOperator.from_blc(A, dtype=dtype)
    else:
        return A
    return op.to(device)


def _vec(v, dtype, device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return as_tensor(v, dtype, device)


def itsolver(A, b, x0=None, M=None, its: Optional[ITSParam] = None,
             dtype=None, device=None) -> SolveResult:
    """Krylov dispatch over an operator and an optional preconditioner
    already on ``device`` (reference: fasp_solver_dcsr_itsolver,
    SolCSR.c:56)."""
    its = its or ITSParam()
    device = _resolve_device(device, A, M)
    op = _as_operator(A, dtype, device)
    dt = getattr(op, "dtype", None) or torch_dtype(dtype)
    b = _vec(b, dt, device)
    x0 = _vec(x0, dt, device)
    stype = int(its.itsolver_type)
    kw = dict(tol=its.tol, abstol=its.abstol, maxit=its.maxit,
              stop_type=its.stop_type)
    if stype in _KRYLOV:
        fn = _KRYLOV[stype]
        if fn in (gmres, vgmres, vfgmres, gcr):
            kw["restart"] = its.restart
        # gcg: the reference's pgcg ignores itparam restart (full-memory
        # method, KryPgcg.c:70), so gcg's own full window applies
        return fn(op, b, x0=x0, M=M, **kw)
    if stype in _SAFE:
        if stype in _SAFE_RESTARTED:
            kw["restart"] = its.restart
        return _SAFE[stype](op, b, x0=x0, M=M, safe=True, **kw)
    raise FaspError(-40, f"unknown solver type {stype}")


def itsolver_s(A, b, x0=None, M=None, its: Optional[ITSParam] = None,
               dtype=None, device=None) -> SolveResult:
    """Safety-net Krylov dispatch: the best-iterate-tracking variant of
    the requested solver (reference: fasp_solver_dcsr_itsolver_s,
    SolCSR.c:163)."""
    its = its or ITSParam()
    stype = int(its.itsolver_type)
    its_s = dataclasses.replace(
        its, itsolver_type=_BASE_TO_SAFE.get(stype, stype))
    return itsolver(A, b, x0=x0, M=M, its=its_s, dtype=dtype, device=device)


def krylov_s(A, b, x0=None, its: Optional[ITSParam] = None, dtype=None,
             device=None) -> SolveResult:
    """Unpreconditioned safety-net Krylov (reference: _krylov_s,
    SolCSR.c:295)."""
    return itsolver_s(A, b, x0=x0, its=its, dtype=dtype, device=device)


def krylov(A, b, x0=None, its: Optional[ITSParam] = None, dtype=None,
           device=None) -> SolveResult:
    """Unpreconditioned Krylov (reference: fasp_solver_dcsr_krylov,
    SolCSR.c:249)."""
    return itsolver(A, b, x0=x0, its=its, dtype=dtype, device=device)


def krylov_diag(A, b, x0=None, its: Optional[ITSParam] = None, dtype=None,
                device=None) -> SolveResult:
    """Diagonally preconditioned Krylov (reference: _krylov_diag,
    SolCSR.c:341; the BSR twin SolBSR.c:186 and the STR twin SolSTR.c:175
    use the block-diagonal inverses)."""
    if isinstance(A, BSRMatrix):
        M = BlockJacobiPrecond.from_bsr(A, dtype)
    elif isinstance(A, CSRMatrix):
        M = JacobiPrecond.from_csr(A, dtype)
    elif isinstance(A, STRMatrix):
        M = setup_str_diag(A, dtype)
    else:
        raise FaspError(-41, "krylov_diag needs a host matrix")
    device = _resolve_device(device)
    M = M.to(device)
    return itsolver(A, b, x0=x0, M=M, its=its, dtype=dtype, device=device)


def _amg_setup_by_type(A, amg: AMGParam, dtype=None, nk=None):
    """The hierarchy ``AMG_type`` asks for.  A BSR matrix takes the
    BSR-native setups: aggregation on the condensed graph and block
    smoothers (reference: fasp_solver_dbsr_krylov_amg, SolBSR.c:349, and
    its SA twin fasp_amg_setup_sa_bsr); ``nk`` is their near-kernel
    basis.  An STR or BLC matrix raises a TypeError."""
    if isinstance(A, (STRMatrix, BLCMatrix)):
        raise _NoAMGFormat(f"cannot build device operator from {type(A)}")
    t = int(amg.AMG_type)
    if isinstance(A, BSRMatrix):
        setup = setup_sa_bsr if t == AMGType.SA else setup_ua_bsr
        return setup(A, amg, dtype=dtype, nk=nk)
    if t == AMGType.SA:
        return setup_sa(A, amg, dtype=dtype)
    if t == AMGType.UA:
        return setup_ua(A, amg, dtype=dtype)
    return setup_rs(A, amg, dtype=dtype)


def krylov_amg(A, b, x0=None, its: Optional[ITSParam] = None,
               amg: Optional[AMGParam] = None, dtype=None, device=None
               ) -> Tuple[SolveResult, object]:
    """AMG-preconditioned Krylov, the canonical driver (reference:
    fasp_solver_dcsr_krylov_amg, SolCSR.c:476).  Returns (result,
    hierarchy) so the hierarchy can serve more solves with the same
    matrix."""
    its = its or ITSParam()
    amg = amg or AMGParam()
    device = _resolve_device(device)
    hier = _amg_setup_by_type(A, amg, dtype).to(device)
    res = itsolver(A, b, x0=x0, M=AMGPrecond(hier, maxit=amg.maxit),
                   its=its, dtype=dtype, device=device)
    return res, hier


def solve_amg(A: CSRMatrix, b, x0=None, amg: Optional[AMGParam] = None,
              dtype=None, device=None) -> SolveResult:
    """AMG as a standalone solver, with the reference's GMRES fallback
    when the host setup fails (fasp_solver_amg, SolAMG.c:49, fallback
    :128-135).  Only host-setup errors (and an STR or BLC matrix, which
    no AMG setup takes) fall back; an unported option or a fault on the
    device raises."""
    amg = amg or AMGParam()
    device = _resolve_device(device)
    try:
        hier = _amg_setup_by_type(A, amg, dtype)
    except _SETUP_ERRORS as e:
        messages.warn(f"AMG setup failed ({e}); falling back to GMRES")
        its = ITSParam(itsolver_type=int(SolverType.GMRES), tol=amg.tol,
                       maxit=max(amg.maxit, 100))
        return itsolver(A, b, x0=x0, its=its, dtype=dtype, device=device)
    hier = hier.to(device)
    dt = hier.levels[0].A.dtype
    return amg_solve(hier, _vec(b, dt, device), _vec(x0, dt, device),
                     tol=amg.tol, maxit=amg.maxit)


def solve_famg(A: CSRMatrix, b, x0=None, amg: Optional[AMGParam] = None,
               dtype=None, device=None) -> SolveResult:
    """Full AMG as a solver (reference: fasp_solver_famg, SolFAMG.c:41)."""
    amg = amg or AMGParam()
    device = _resolve_device(device)
    hier = _amg_setup_by_type(A, amg, dtype).to(device)
    return famg_solve(hier, _vec(b, hier.levels[0].A.dtype, device),
                      tol=amg.tol, maxit=amg.maxit)


def krylov_amg_nk(A, b, nk, x0=None,
                  its: Optional[ITSParam] = None,
                  amg: Optional[AMGParam] = None, dtype=None, device=None
                  ) -> Tuple[SolveResult, object]:
    """AMG-preconditioned Krylov with an extra near-kernel correction
    (reference: fasp_solver_dcsr_krylov_amg_nk, SolCSR.c:748; BSR twin
    SolBSR.c:476, always over the UA hierarchy).  ``nk`` is an (n, m)
    array of near-kernel vectors."""
    its = its or ITSParam()
    amg = amg or AMGParam()
    device = _resolve_device(device)
    if isinstance(A, BSRMatrix):
        hier = setup_ua_bsr(A, amg, dtype=dtype)
    else:
        hier = _amg_setup_by_type(A, amg, dtype)
    op = _as_operator(A, dtype, "cpu")
    nk = np.atleast_2d(np.asarray(nk, dtype=np.float64))
    if nk.shape[0] != A.nrow:
        nk = nk.T
    gram_inv = np.linalg.pinv(nk.T @ (A.to_scipy() @ nk))
    M = AMGNKPrecond(hier, as_tensor(nk, op.dtype),
                     as_tensor(gram_inv, op.dtype), op,
                     maxit=amg.maxit).to(device)
    res = itsolver(M.A_op, b, x0=x0, M=M, its=its, dtype=dtype,
                   device=device)
    return res, M.mg.hier


def krylov_nk_amg(A, b, nk, x0=None, its: Optional[ITSParam] = None,
                  amg: Optional[AMGParam] = None, dtype=None, device=None
                  ) -> Tuple[SolveResult, object]:
    """Krylov preconditioned by AMG that carries the near-kernel basis
    inside the hierarchy: the basis is restricted level by level and the
    cycle applies the extra near-kernel solve after post-smoothing
    (reference: fasp_solver_dbsr_krylov_nk_amg, SolBSR.c:634;
    PreAMGSetupUABSR.c:241-266; PreMGCycle.c:369-391).  BSR only."""
    its = its or ITSParam()
    amg = amg or AMGParam()
    if not isinstance(A, BSRMatrix):
        raise FaspError(-41, "krylov_nk_amg: BSR path only (reference "
                        "SolBSR.c:634)")
    device = _resolve_device(device)
    hier = _amg_setup_by_type(A, amg, dtype, nk=nk).to(device)
    res = itsolver(A, b, x0=x0, M=AMGPrecond(hier, maxit=amg.maxit),
                   its=its, dtype=dtype, device=device)
    return res, hier


def _precond_solve(A, b, x0, M, its, dtype, device) -> SolveResult:
    """Krylov over ``best_operator(A)`` (a grid matrix: the stencil
    kernel) for a CSR matrix, or over M's own operator when it has one
    (Schwarz), preconditioned by M."""
    if isinstance(A, CSRMatrix):
        A = getattr(M, "A", None) or best_operator(A, dtype=dtype).to(device)
    return itsolver(A, b, x0=x0, M=M, its=its, dtype=dtype, device=device)


def krylov_ilu(A, b, x0=None, its: Optional[ITSParam] = None,
               ilu: Optional[ILUParam] = None, dtype=None, device=None
               ) -> SolveResult:
    """ILU-preconditioned Krylov (reference: fasp_solver_dcsr_krylov_ilu,
    SolCSR.c:588; BSR twin SolBSR.c:286; STR twin SolSTR.c:236).  The
    factorization runs on the host at setup; the apply is level-scheduled
    triangular solves on the device.  A BSR matrix with ``ILU_lfil = 0``
    takes the true block ILU(0) (fasp_ilu_dbsr_setup) and, should that
    setup fail or for ``lfil > 0``, the scalar ILU of its CSR expansion.
    An STR matrix with ``ILU_lfil`` 0 or 1 takes the banded-block ILU
    factored in band space (fasp_ilu_dstr_setup0/1), and the scalar ILU
    of its CSR expansion for more fill."""
    ilu = ilu or ILUParam()
    if not isinstance(A, (BSRMatrix, CSRMatrix, STRMatrix)):
        raise FaspError(-41, "krylov_ilu needs a host matrix")
    device = _resolve_device(device)
    M = None
    if isinstance(A, BSRMatrix) and int(ilu.ILU_lfil) == 0:
        try:
            M = setup_bsr_ilu0(A, dtype=dtype)
        except FaspError:
            pass
    if isinstance(A, STRMatrix) and int(ilu.ILU_lfil) <= 1:
        M = setup_str_ilu(A, fill=int(ilu.ILU_lfil), dtype=dtype)
    if M is None:
        M = setup_ilu(A if isinstance(A, CSRMatrix) else A.to_csr(), ilu,
                      dtype=dtype)
    return _precond_solve(A, b, x0, M.to(device), its, dtype, device)


def krylov_ilu_m(A: CSRMatrix, b, x0=None, its: Optional[ITSParam] = None,
                 ilu: Optional[ILUParam] = None, dtype=None, device=None
                 ) -> SolveResult:
    """ILU on the M-matrix massage of A: positive off-diagonals are moved
    onto the diagonal (row sums kept) before factorization, and the ILU
    of that M-matrix preconditions the original system (reference:
    fasp_solver_dcsr_krylov_ilu_M, SolCSR.c:668)."""
    if not isinstance(A, CSRMatrix):
        raise FaspError(-41, "krylov_ilu_m needs a CSRMatrix")
    device = _resolve_device(device)
    m = A.to_scipy().tocoo()
    off_pos = (m.row != m.col) & (m.data > 0)
    diag_add = np.bincount(m.row[off_pos], weights=m.data[off_pos],
                           minlength=A.nrow)
    keep = ~off_pos
    diag = np.arange(A.nrow)
    M_mat = sp.coo_matrix((np.concatenate([m.data[keep], diag_add]),
                           (np.concatenate([m.row[keep], diag]),
                            np.concatenate([m.col[keep], diag]))),
                          shape=m.shape).tocsr()
    M_mat.sum_duplicates()
    M = setup_ilu(CSRMatrix.from_scipy(M_mat), ilu or ILUParam(),
                  dtype=dtype).to(device)
    return _precond_solve(A, b, x0, M, its, dtype, device)


def krylov_swz(A: CSRMatrix, b, x0=None, its: Optional[ITSParam] = None,
               swz: Optional[SWZParam] = None, dtype=None, device=None
               ) -> SolveResult:
    """Schwarz-preconditioned Krylov (reference:
    fasp_solver_dcsr_krylov_swz, SolCSR.c:401)."""
    if not isinstance(A, CSRMatrix):
        raise FaspError(-41, "krylov_swz needs a CSRMatrix")
    device = _resolve_device(device)
    M = setup_schwarz(A, swz or SWZParam(), dtype=dtype).to(device)
    return _precond_solve(A, b, x0, M, its, dtype, device)


def krylov_blockgs(A, b, x0=None, its: Optional[ITSParam] = None,
                   nsweeps: int = 2, smoother: str = "blockgs", dtype=None,
                   device=None) -> SolveResult:
    """Block-smoother-preconditioned Krylov for structured-grid matrices
    (reference: fasp_solver_dstr_krylov_blockgs, SolSTR.c:323).
    ``smoother="schwarz"`` takes the overlapping-patch Schwarz smoother
    instead (reference: fasp_smoother_dstr_swz, ItrSmootherSTR.c:1665).
    Krylov runs over the smoother's own StrOperator."""
    if not isinstance(A, STRMatrix):
        raise FaspError(-41, "krylov_blockgs needs an STRMatrix")
    device = _resolve_device(device)
    if smoother == "schwarz":
        M = setup_str_schwarz(A, nsweeps=nsweeps, dtype=dtype)
    else:
        M = setup_str_blockgs(A, nsweeps=nsweeps, dtype=dtype)
    M = M.to(device)
    return itsolver(M.A, b, x0=x0, M=M, its=its, dtype=dtype, device=device)


def krylov_block(A, b, x0=None, its: Optional[ITSParam] = None,
                 mode: str = "diag", diag_solver: str = "amg",
                 amg: Optional[AMGParam] = None, dtype=None, device=None
                 ) -> SolveResult:
    """Block-preconditioned Krylov for block-composite systems
    (reference: fasp_solver_dblc_krylov_block3/_block4, SolBLC.c:188,
    :390: block diag / lower / upper / SGS with AMG on the diagonal
    blocks; one driver serves any block count)."""
    if not isinstance(A, BLCMatrix):
        raise FaspError(-41, "krylov_block needs a BLCMatrix")
    device = _resolve_device(device)
    M = setup_blc_precond(A, mode=mode, diag_solver=diag_solver, amg=amg,
                          dtype=dtype).to(device)
    return itsolver(A, b, x0=x0, M=M, its=its, dtype=dtype, device=device)


def krylov_sweeping(A, b, x0=None, its: Optional[ITSParam] = None,
                    diag_solver: str = "amg",
                    amg: Optional[AMGParam] = None, dtype=None, device=None
                    ) -> SolveResult:
    """Layered sweeping-preconditioned Krylov for block-tridiagonal
    systems (reference: fasp_solver_dblc_krylov_sweeping, SolBLC.c:507)."""
    if not isinstance(A, BLCMatrix):
        raise FaspError(-41, "krylov_sweeping needs a BLCMatrix")
    device = _resolve_device(device)
    M = setup_blc_sweeping(A, diag_solver=diag_solver, amg=amg,
                           dtype=dtype).to(device)
    return itsolver(A, b, x0=x0, M=M, its=its, dtype=dtype, device=device)
