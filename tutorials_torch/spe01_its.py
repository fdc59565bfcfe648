"""BSR reservoir system (SPE01 black-oil Jacobian): vFGMRES + BSR-AMG.

Reference: tutorial/main/spe01-its.c (+ ini/its_bsr.dat); the port of
tutorials/spe01_its.py.
Run: python -m tutorials_torch.spe01_its [DATA_DIR] [--device cpu]
"""
import sys

import numpy as np

from faspsolver_tpu_torch.constants import SolverType
from faspsolver_tpu_torch.io import read_bsr, read_vec
from faspsolver_tpu_torch.solvers import krylov_amg
from faspsolver_tpu_torch.utils.params import ITSParam

from tutorials_torch import REFDATA, parse


def main(argv, device=None):
    args, device = parse(argv, device)
    data = args[0] if args else REFDATA
    A = read_bsr(f"{data}/bsrmat_SPE01.dat")
    b = read_vec(f"{data}/rhs_SPE01.dat")
    res, hierarchy = krylov_amg(
        A, b, its=ITSParam(itsolver_type=int(SolverType.VFGMRES),
                           tol=1e-9, maxit=500, restart=30), device=device)
    r = b - A.matvec(res.x.cpu().numpy())
    print(f"SPE01 vFGMRES+AMG: {int(res.iters)} iterations, relres "
          f"{np.linalg.norm(r)/np.linalg.norm(b):.3e}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
