"""P1 finite-element Poisson problems (port of ``TriMesh``,
``unit_square_mesh``, ``_p1_geometry`` and ``assemble_poisson`` of
``faspsolver_tpu/testgen/fem.py``).

Reference: the libfasptest FEM generator — test/src/FemMesh.c (mesh),
FemQuadrature.c (triangle quadrature), FemPoisson.c (setup_poisson P1
assembly), FemAssemble.c (Dirichlet elimination).  The 1025^2-node mesh
gives the reference's stored-baseline problem: 1,046,529 interior dofs,
7,317,521 nonzeros.  Host NumPy/SciPy only; the arrays are the JAX
package's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp

from ..formats import CSRMatrix


@dataclass
class TriMesh:
    nodes: np.ndarray          # (nn, 2)
    elems: np.ndarray          # (ne, 3) int
    boundary: np.ndarray       # (nn,) bool — Dirichlet nodes

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_elems(self) -> int:
        return len(self.elems)


def unit_square_mesh(n: int) -> TriMesh:
    """Uniform triangulation of the unit square with (n+1)^2 nodes: each
    cell (i, j) splits into (a, b, d) and (a, d, c) along its diagonal
    (reference mesh.dat topology), cells in row-major order."""
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs)
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    i, j = np.meshgrid(np.arange(n, dtype=np.int64),
                       np.arange(n, dtype=np.int64), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)
    b, c, d = a + 1, a + (n + 1), a + (n + 2)
    elems = np.stack([np.stack([a, b, d], axis=1),
                      np.stack([a, d, c], axis=1)], axis=1).reshape(-1, 3)
    onb = ((nodes[:, 0] == 0) | (nodes[:, 0] == 1)
           | (nodes[:, 1] == 0) | (nodes[:, 1] == 1))
    return TriMesh(nodes=nodes, elems=elems, boundary=onb)


_QUAD_RULES = {
    1: (np.array([[1 / 3, 1 / 3, 1 / 3]]), np.array([1.0])),
    3: (np.array([[2 / 3, 1 / 6, 1 / 6],
                  [1 / 6, 2 / 3, 1 / 6],
                  [1 / 6, 1 / 6, 2 / 3]]), np.full(3, 1 / 3)),
    7: (np.array([[1 / 3, 1 / 3, 1 / 3],
                  [0.797426985353087, 0.101286507323456, 0.101286507323456],
                  [0.101286507323456, 0.797426985353087, 0.101286507323456],
                  [0.101286507323456, 0.101286507323456, 0.797426985353087],
                  [0.059715871789770, 0.470142064105115, 0.470142064105115],
                  [0.470142064105115, 0.059715871789770, 0.470142064105115],
                  [0.470142064105115, 0.470142064105115, 0.059715871789770]]),
        np.array([0.225,
                  0.125939180544827, 0.125939180544827, 0.125939180544827,
                  0.132394152788506, 0.132394152788506, 0.132394152788506])),
}


def quad_points(order: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric quadrature points + weights on the reference triangle."""
    for npts in (1, 3, 7):
        if npts >= order:
            return _QUAD_RULES[npts]
    return _QUAD_RULES[7]


def _p1_geometry(mesh: TriMesh):
    p = mesh.nodes[mesh.elems]                   # (ne, 3, 2)
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
    J = np.stack([v1 - v0, v2 - v0], axis=2)     # (ne, 2, 2) columns
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    # gradients of the barycentric basis (J^{-T} columns): grad lambda_i
    g = np.empty((len(p), 3, 2))
    g[:, 1, 0] = J[:, 1, 1]
    g[:, 1, 1] = -J[:, 0, 1]
    g[:, 2, 0] = -J[:, 1, 0]
    g[:, 2, 1] = J[:, 0, 0]
    g[:, 1:, :] /= detJ[:, None, None]
    g[:, 0] = -(g[:, 1] + g[:, 2])
    return area, g


def assemble_poisson(mesh: TriMesh,
                     f: Callable[[np.ndarray], np.ndarray],
                     u_exact: Callable[[np.ndarray], np.ndarray] = None,
                     quad_order: int = 3
                     ) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """Assemble -Δu = f with homogeneous (or manufactured) Dirichlet BCs.

    Returns (A, b, dof_map): A is the interior-node stiffness matrix after
    Dirichlet elimination, b the load, dof_map the interior node ids.
    """
    area, g = _p1_geometry(mesh)
    nn = mesh.num_nodes
    # local stiffness: area * grad_i . grad_j  -> (ne, 3, 3)
    K = np.einsum("eid,ejd->eij", g, g) * area[:, None, None]
    rows = np.repeat(mesh.elems, 3, axis=1).reshape(-1)
    cols = np.tile(mesh.elems, (1, 3)).reshape(-1)
    Afull = sp.coo_matrix((K.reshape(-1), (rows, cols)),
                          shape=(nn, nn)).tocsr()
    # load vector by quadrature
    lam, w = quad_points(quad_order)
    b = np.zeros(nn)
    pts = mesh.nodes[mesh.elems]                 # (ne, 3, 2)
    for lk, wk in zip(lam, w):
        x = np.einsum("k,ekd->ed", lk, pts)      # quad point per element
        fv = f(x)
        for i in range(3):
            np.add.at(b, mesh.elems[:, i], wk * area * fv * lk[i])

    interior = np.nonzero(~mesh.boundary)[0]
    if u_exact is not None:
        ub = np.zeros(nn)
        ub[mesh.boundary] = u_exact(mesh.nodes[mesh.boundary])
        b = b - Afull @ ub
    Ai = Afull[interior][:, interior].tocsr()
    return CSRMatrix.from_scipy(Ai), b[interior], interior
