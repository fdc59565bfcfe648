"""Compare iterative solvers/preconditioners on one system.

Reference: tutorial/main/poisson-its.c (+ ini/its.dat); the port of
tutorials/poisson_its.py.
Run: python -m tutorials_torch.poisson_its [DATA_DIR] [--device cpu]
"""
import sys

from faspsolver_tpu_torch import solvers
from faspsolver_tpu_torch.constants import SolverType
from faspsolver_tpu_torch.io import read_csrvec
from faspsolver_tpu_torch.utils.params import ITSParam

from tutorials_torch import REFDATA, parse


def main(argv, device=None):
    args, device = parse(argv, device)
    data = args[0] if args else REFDATA
    A, b = read_csrvec(f"{data}/csrmat_FE.dat", f"{data}/rhs_FE.dat")
    rows = {}
    for name, run in [
        ("CG", lambda: solvers.krylov(
            A, b, its=ITSParam(tol=1e-8, maxit=2000), device=device)),
        ("CG+diag", lambda: solvers.krylov_diag(
            A, b, its=ITSParam(tol=1e-8, maxit=2000), device=device)),
        ("CG+ILU", lambda: solvers.krylov_ilu(
            A, b, its=ITSParam(tol=1e-8, maxit=500), device=device)),
        ("CG+AMG", lambda: solvers.krylov_amg(
            A, b, its=ITSParam(tol=1e-8, maxit=100), device=device)[0]),
        ("GMRES+AMG", lambda: solvers.krylov_amg(
            A, b, its=ITSParam(itsolver_type=int(SolverType.GMRES),
                               tol=1e-8, maxit=100, restart=30),
            device=device)[0]),
    ]:
        res = rows[name] = run()
        print(f"{name:10s}: iters={int(res.iters):5d} "
              f"relres={float(res.relres):.3e}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
