"""The P1 finite-element Poisson stiffness on the uniform triangulation
of the unit square with (n + 1)^2 nodes, Dirichlet nodes eliminated
(reference: test/src/FemMesh.c, FemPoisson.c, FemAssemble.c).  A frozen
copy of the port's ``testgen.fem.unit_square_mesh`` and of
``assemble_poisson`` for f = 1 (the stiffness and the load vector by its
three-point rule); the unknowns are the interior nodes in node order, at
their points, and the right-hand side is the load vector of f = 1, as
test.c's problem 11 and the port's ``bench.py`` general stanza solve.  n = 1024 gives 1,046,529 unknowns and
7,317,521 nonzeros."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from solverbench.problems import Problem, from_scipy


def unit_square_mesh(n: int):
    """(nodes (nn, 2), elems (ne, 3), boundary (nn,) bool): each cell
    (i, j) splits into (a, b, d) and (a, d, c) along its diagonal, cells
    in row-major order."""
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
    return nodes, elems, onb


# the three-point rule of assemble_poisson(quad_order=3): barycentric
# points and weights on the reference triangle
QUAD_POINTS = np.array([[2 / 3, 1 / 6, 1 / 6],
                        [1 / 6, 2 / 3, 1 / 6],
                        [1 / 6, 1 / 6, 2 / 3]])
QUAD_WEIGHTS = np.full(3, 1 / 3)


def assemble(nodes, elems, boundary):
    """The interior-node stiffness matrix (area * grad_i . grad_j summed
    over the elements), the load vector of f = 1 at the interior nodes
    and the interior node ids."""
    p = nodes[elems]                             # (ne, 3, 2)
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
    J = np.stack([v1 - v0, v2 - v0], axis=2)     # (ne, 2, 2) columns
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    g = np.empty((len(p), 3, 2))                 # grad of each barycentric
    g[:, 1, 0] = J[:, 1, 1]
    g[:, 1, 1] = -J[:, 0, 1]
    g[:, 2, 0] = -J[:, 1, 0]
    g[:, 2, 1] = J[:, 0, 0]
    g[:, 1:, :] /= detJ[:, None, None]
    g[:, 0] = -(g[:, 1] + g[:, 2])
    K = np.einsum("eid,ejd->eij", g, g) * area[:, None, None]
    rows = np.repeat(elems, 3, axis=1).reshape(-1)
    cols = np.tile(elems, (1, 3)).reshape(-1)
    nn = len(nodes)
    Afull = sp.coo_matrix((K.reshape(-1), (rows, cols)),
                          shape=(nn, nn)).tocsr()
    b = np.zeros(nn)
    for lk, wk in zip(QUAD_POINTS, QUAD_WEIGHTS):
        for i in range(3):
            np.add.at(b, elems[:, i], wk * area * lk[i])
    interior = np.nonzero(~boundary)[0]
    return Afull[interior][:, interior].tocsr(), b[interior], interior


def build(n: int) -> Problem:
    nodes, elems, boundary = unit_square_mesh(n)
    A, b, interior = assemble(nodes, elems, boundary)
    return from_scipy(A, nodes[interior], b)
