"""The 5-point Laplacian on an nx x nx interior grid of the unit square,
Dirichlet boundary eliminated, scaled by 1/h^2 (reference generator
test/src/FdmPoisson.c).  A frozen copy of the port's
``testgen.fdm.poisson_2d``; unknown (i, j) is row j * nx + i at the point
((i + 1) h, (j + 1) h), h = 1 / (nx + 1).  The right-hand side is the
source's b = A 1 (the solution all ones), as the port's ``bench.py``
headline solves."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from solverbench.problems import Problem, from_scipy


def build(nx: int) -> Problem:
    h2 = float((nx + 1) ** 2)
    T = sp.diags([-h2, 2 * h2, -h2], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()
    A.eliminate_zeros()        # scipy's kron goes through BSR: drop the
    A.sort_indices()           # explicit zeros its dense blocks introduce
    g = np.arange(1, nx + 1) / (nx + 1)
    X, Y = np.meshgrid(g, g)
    A = A.astype(np.float64)
    return from_scipy(A, np.stack([X.reshape(-1), Y.reshape(-1)], axis=1),
                      A @ np.ones(nx * nx))
