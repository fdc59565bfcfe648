"""AMG as a standalone solver on the shipped FE Poisson system.

Reference: tutorial/main/poisson-amg.c (+ ini/amg.dat); the port of
tutorials/poisson_amg.py.
Run: python -m tutorials_torch.poisson_amg [DATA_DIR] [--device cpu]
"""
import sys

import numpy as np

from faspsolver_tpu_torch.io import read_csrvec
from faspsolver_tpu_torch.solvers import solve_amg
from faspsolver_tpu_torch.utils.params import AMGParam

from tutorials_torch import REFDATA, parse


def main(argv, device=None):
    args, device = parse(argv, device)
    data = args[0] if args else REFDATA
    A, b = read_csrvec(f"{data}/csrmat_FE.dat", f"{data}/rhs_FE.dat")
    res = solve_amg(A, b, amg=AMGParam(maxit=100, tol=1e-9), device=device)
    r = b - A.matvec(res.x.cpu().numpy())
    print(f"AMG: {int(res.iters)} cycles, relres "
          f"{np.linalg.norm(r)/np.linalg.norm(b):.3e}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
