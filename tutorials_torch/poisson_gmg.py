"""Matrix-free geometric multigrid for the Poisson equation.

Reference: tutorial/main/poisson-gmg.c; the port of
tutorials/poisson_gmg.py.
Run: python -m tutorials_torch.poisson_gmg [--device cpu]
"""
import sys

import numpy as np

from faspsolver_tpu_torch.precond import poisson_gmg_2d

from tutorials_torch import parse


def main(argv, device=None):
    _, device = parse(argv, device)
    n = 128                               # (n+1)x(n+1) grid incl. boundary
    h = 1.0 / n
    xs = np.arange(n + 1) * h
    X, Y = np.meshgrid(xs, xs)
    f = 2 * np.pi**2 * np.sin(np.pi * X) * np.sin(np.pi * Y)
    res = poisson_gmg_2d(f, n, tol=1e-9, device=device)
    uex = np.sin(np.pi * X) * np.sin(np.pi * Y)
    err = np.abs(res.x.cpu().numpy() - uex).max()
    print(f"GMG: {int(res.iters)} cycles, relres {float(res.relres):.3e}, "
          f"max err vs exact {err:.3e}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
