"""Flat-array solver API, the binding surface for external codes (port of
``faspsolver_tpu/capi.py``).

Reference: base/src/SolWrapper.c (fasp_fwrapper_* / fasp_wrapper_*): raw
pointer + scalar entry points so that Fortran / C simulation codes call
the solvers without the library's data structures.  Here they are
functions over plain NumPy arrays (a ctypes / cffi / f2py shim builds
them from raw pointers with ``numpy.frombuffer``, no copy).

Every function takes the CSR / BSR components as flat arrays and returns
``(x, iterations, relative_residual)`` with x a NumPy array on the host.
The solve runs where the drivers run: ``device=None`` is the CUDA device
(an error where there is none), ``device="cpu"`` the CPU.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .formats import BSRMatrix, CSRMatrix
from .solvers import krylov_amg, krylov_ilu, solve_amg
from .utils.params import AMGParam, ILUParam, ITSParam


def _csr(n, indptr, indices, data) -> CSRMatrix:
    return CSRMatrix(np.asarray(indptr), np.asarray(indices),
                     np.asarray(data, dtype=np.float64), (n, n))


def _out(res) -> Tuple[np.ndarray, int, float]:
    return res.x.cpu().numpy(), int(res.iters), float(res.relres)


def dcsr_krylov_amg(n: int, indptr, indices, data, b,
                    tol: float = 1e-6, maxit: int = 500,
                    solver_type: int = 1, device=None
                    ) -> Tuple[np.ndarray, int, float]:
    """AMG-preconditioned Krylov from raw CSR arrays
    (reference: fasp_fwrapper_dcsr_krylov_amg_, SolWrapper.c:261)."""
    res, _ = krylov_amg(_csr(n, indptr, indices, data),
                        np.asarray(b, dtype=np.float64),
                        its=ITSParam(itsolver_type=solver_type, tol=tol,
                                     maxit=maxit), device=device)
    return _out(res)


def dcsr_amg(n: int, indptr, indices, data, b,
             tol: float = 1e-6, maxit: int = 100, device=None
             ) -> Tuple[np.ndarray, int, float]:
    """AMG as a solver from raw CSR arrays
    (reference: fasp_fwrapper_dcsr_amg_, SolWrapper.c:136)."""
    return _out(solve_amg(_csr(n, indptr, indices, data),
                          np.asarray(b, dtype=np.float64),
                          amg=AMGParam(tol=tol, maxit=maxit), device=device))


def dcsr_krylov_ilu(n: int, indptr, indices, data, b,
                    tol: float = 1e-6, maxit: int = 500, lfil: int = 0,
                    device=None) -> Tuple[np.ndarray, int, float]:
    """ILU-preconditioned Krylov from raw CSR arrays
    (reference: fasp_fwrapper_dcsr_krylov_ilu_, SolWrapper.c:195)."""
    return _out(krylov_ilu(_csr(n, indptr, indices, data),
                           np.asarray(b, dtype=np.float64),
                           its=ITSParam(tol=tol, maxit=maxit),
                           ilu=ILUParam(ILU_lfil=lfil), device=device))


def dbsr_krylov_amg(nb: int, nrow_block: int, indptr, indices, data, b,
                    tol: float = 1e-6, maxit: int = 500,
                    solver_type: int = 6, device=None
                    ) -> Tuple[np.ndarray, int, float]:
    """BSR AMG-preconditioned Krylov from raw block arrays
    (reference: fasp_fwrapper_dbsr_krylov_amg_, SolWrapper.c:397)."""
    blocks = np.asarray(data, dtype=np.float64).reshape(-1, nb, nb)
    A = BSRMatrix(np.asarray(indptr), np.asarray(indices), blocks,
                  (nrow_block, nrow_block))
    res, _ = krylov_amg(A, np.asarray(b, dtype=np.float64),
                        its=ITSParam(itsolver_type=solver_type, tol=tol,
                                     maxit=maxit), device=device)
    return _out(res)
