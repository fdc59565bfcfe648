"""AMG-preconditioned CG on the shipped FE Poisson system.

Reference: tutorial/main/poisson-pcg.c (+ ini/pcg.dat); the port of
tutorials/poisson_pcg.py.
Run: python -m tutorials_torch.poisson_pcg [DATA_DIR] [--device cpu]
"""
import sys

from faspsolver_tpu_torch.io import read_csrvec
from faspsolver_tpu_torch.solvers import krylov_amg
from faspsolver_tpu_torch.utils.params import ITSParam

from tutorials_torch import REFDATA, parse


def main(argv, device=None):
    args, device = parse(argv, device)
    data = args[0] if args else REFDATA
    A, b = read_csrvec(f"{data}/csrmat_FE.dat", f"{data}/rhs_FE.dat")
    res, hierarchy = krylov_amg(A, b, its=ITSParam(tol=1e-10, maxit=200),
                                device=device)
    print(f"AMG-PCG: {int(res.iters)} iterations, relres "
          f"{float(res.relres):.3e}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
