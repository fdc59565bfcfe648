"""User-facing solver drivers: params -> preconditioner setup -> Krylov
(port of the CSR drivers of ``faspsolver_tpu/solvers/drivers.py``).

Reference: base/src/SolCSR.c (fasp_solver_dcsr_itsolver :56, _krylov
:249, _krylov_diag :341, _krylov_amg :476, _krylov_amg_nk :748),
SolAMG.c:49 (fasp_solver_amg with its GMRES fallback :128-135),
SolFAMG.c.

Every driver takes ``dtype`` (``None``: float64) and ``device``
(``None``: the device of an operator or preconditioner passed in already
on one, else the CUDA device; without one it raises, and ``"cpu"`` asks
for the CPU).  It builds on the host, moves what it built with
``.to(device)`` and returns a ``SolveResult`` whose ``x`` lies on
``device``.  The BSR,
STR and BLC branches and the ILU, Schwarz, block and sweeping drivers
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import as_tensor, default_device, torch_dtype
from ..constants import AMGType, SolverType
from ..formats import BLCMatrix, BSRMatrix, CSRMatrix, STRMatrix
from ..krylov import (JacobiPrecond, SolveResult, bicgstab, gcg, gcr, gmres,
                      minres, pcg, vfgmres, vgmres)
from ..ops.operators import device_operator
from ..precond import AMGNKPrecond, AMGPrecond
from ..precond.amg import (amg_solve, famg_solve, setup_rs, setup_sa,
                           setup_ua)
from ..utils import messages
from ..utils.errors import FaspError
from ..utils.params import AMGParam, ITSParam

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

# host-setup failures that send solve_amg to its GMRES fallback; an
# unported option (NotImplementedError) and anything raised on the
# device are not among them
_SETUP_ERRORS = (FaspError, ValueError, np.linalg.LinAlgError)


def _unported(A, item: int):
    raise NotImplementedError(
        f"{type(A).__name__} drivers are not ported (ROADMAP item {item})")


def _check_host(A):
    if isinstance(A, BSRMatrix):
        _unported(A, 10)
    if isinstance(A, (STRMatrix, BLCMatrix)):
        _unported(A, 11)


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
    """The operator of a host CSR matrix on ``device``, or A itself when
    it is already an operator."""
    _check_host(A)
    if isinstance(A, CSRMatrix):
        return device_operator(A, dtype=dtype).to(device)
    return A


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
    SolCSR.c:341)."""
    _check_host(A)
    if not isinstance(A, CSRMatrix):
        raise FaspError(-41, "krylov_diag needs a host matrix")
    device = _resolve_device(device)
    M = JacobiPrecond.from_csr(A, dtype).to(device)
    return itsolver(A, b, x0=x0, M=M, its=its, dtype=dtype, device=device)


def _amg_setup_by_type(A: CSRMatrix, amg: AMGParam, dtype=None):
    t = int(amg.AMG_type)
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
    _check_host(A)
    device = _resolve_device(device)
    hier = _amg_setup_by_type(A, amg, dtype).to(device)
    res = itsolver(A, b, x0=x0, M=AMGPrecond(hier, maxit=amg.maxit),
                   its=its, dtype=dtype, device=device)
    return res, hier


def solve_amg(A: CSRMatrix, b, x0=None, amg: Optional[AMGParam] = None,
              dtype=None, device=None) -> SolveResult:
    """AMG as a standalone solver, with the reference's GMRES fallback
    when the host setup fails (fasp_solver_amg, SolAMG.c:49, fallback
    :128-135).  Only host-setup errors fall back; an unported option or
    a fault on the device raises."""
    amg = amg or AMGParam()
    _check_host(A)
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
    _check_host(A)
    device = _resolve_device(device)
    hier = _amg_setup_by_type(A, amg, dtype).to(device)
    return famg_solve(hier, _vec(b, hier.levels[0].A.dtype, device),
                      tol=amg.tol, maxit=amg.maxit)


def krylov_amg_nk(A: CSRMatrix, b, nk, x0=None,
                  its: Optional[ITSParam] = None,
                  amg: Optional[AMGParam] = None, dtype=None, device=None
                  ) -> Tuple[SolveResult, object]:
    """AMG-preconditioned Krylov with an extra near-kernel correction
    (reference: fasp_solver_dcsr_krylov_amg_nk, SolCSR.c:748).  ``nk`` is
    an (n, m) array of near-kernel vectors."""
    its = its or ITSParam()
    amg = amg or AMGParam()
    _check_host(A)
    device = _resolve_device(device)
    hier = _amg_setup_by_type(A, amg, dtype)
    op = _as_operator(A, dtype, "cpu")
    nk = np.atleast_2d(np.asarray(nk, dtype=np.float64))
    if nk.shape[0] != A.nrow:
        nk = nk.T
    gram_inv = np.linalg.pinv(nk.T @ A.to_scipy().dot(nk))
    M = AMGNKPrecond(hier, as_tensor(nk, op.dtype),
                     as_tensor(gram_inv, op.dtype), op,
                     maxit=amg.maxit).to(device)
    res = itsolver(M.A_op, b, x0=x0, M=M, its=its, dtype=dtype,
                   device=device)
    return res, M.mg.hier


def _not_ported(name: str, what: str, item: int):
    def driver(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: {what} is not ported (ROADMAP item {item})")
    driver.__name__ = driver.__qualname__ = name
    driver.__doc__ = (f"The JAX package's ``{name}``; {what} waits for "
                      f"ROADMAP item {item}.")
    return driver


krylov_ilu = _not_ported("krylov_ilu", "ILU preconditioning", 11)
krylov_ilu_m = _not_ported("krylov_ilu_m", "ILU preconditioning", 11)
krylov_swz = _not_ported("krylov_swz", "Schwarz preconditioning", 11)
krylov_blockgs = _not_ported("krylov_blockgs", "STR block smoothing", 11)
krylov_block = _not_ported("krylov_block", "BLC block preconditioning", 11)
krylov_sweeping = _not_ported("krylov_sweeping", "BLC sweeping", 11)
krylov_nk_amg = _not_ported("krylov_nk_amg", "BSR near-kernel AMG", 10)
