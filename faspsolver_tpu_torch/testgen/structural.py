"""Structural (plane-stress elasticity) FE generators (host copy of
``faspsolver_tpu/testgen/structural.py``).

Stand-ins for the two conformance matrices the reference regression uses
but does not ship (test/main/regression_mm.c:115-321 reads bcsstk16.mtx /
s2rmq4m1.mtx):

- bcsstk16: Corps of Engineers dam, SPD shell model, n=4884, moderate
  conditioning -> ``plate_stress_syn`` generates a Q4 plane-stress plate
  of comparable size and structure (2 dof per node, SPD, block
  couplings).
- s2rmq4m1: scaled cylindrical-shell static analysis, n=5489,
  cond ~1e8 -> ``shell_stress_syn`` adds a 1e8 element-stiffness contrast
  (graded thickness), reproducing the scaled-shell conditioning class.

These are generated synthetic stand-ins with the same size, dof
structure, definiteness and conditioning regime, not the SuiteSparse
files.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..formats import CSRMatrix


def _q4_stiffness(E: float, nu: float, a: float, b: float) -> np.ndarray:
    """8x8 plane-stress Q4 element stiffness (2x2 Gauss) for a
    (2a x 2b) rectangle."""
    D = (E / (1 - nu * nu)) * np.array([[1, nu, 0],
                                        [nu, 1, 0],
                                        [0, 0, (1 - nu) / 2]])
    gp = np.array([-1, 1]) / np.sqrt(3.0)
    K = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array([
                [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)]])
            J = np.diag([a, b])
            dNxy = np.linalg.solve(J, dN)
            B = np.zeros((3, 8))
            B[0, 0::2] = dNxy[0]
            B[1, 1::2] = dNxy[1]
            B[2, 0::2] = dNxy[1]
            B[2, 1::2] = dNxy[0]
            K += (B.T @ D @ B) * a * b
    return K


def _assemble_plate(nex: int, ney: int, thick) -> CSRMatrix:
    """Assemble Q4 plane stress on an nex x ney element grid with
    per-element thickness ``thick(ex, ey)``; left edge clamped
    (Dirichlet rows eliminated)."""
    nnx, nny = nex + 1, ney + 1
    Ke = _q4_stiffness(E=2.1e5, nu=0.3, a=0.5 / nex, b=0.5 / ney)
    rows, cols, vals = [], [], []
    for ey in range(ney):
        for ex in range(nex):
            n0 = ey * nnx + ex
            nodes = [n0, n0 + 1, n0 + 1 + nnx, n0 + nnx]
            dofs = np.array([[2 * n, 2 * n + 1] for n in nodes]).ravel()
            t = thick(ex, ey)
            rows.append(np.repeat(dofs, 8))
            cols.append(np.tile(dofs, 8))
            vals.append((t * Ke).ravel())
    n = 2 * nnx * nny
    K = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    # clamp the left edge (x-index 0): eliminate those dofs
    fixed = np.zeros(n, dtype=bool)
    for ny_ in range(nny):
        node = ny_ * nnx
        fixed[2 * node] = fixed[2 * node + 1] = True
    keep = np.flatnonzero(~fixed)
    K = K[np.ix_(keep, keep)].tocsr()
    K = ((K + K.T) * 0.5).tocsr()      # exact symmetry (assembly roundoff)
    K.sort_indices()
    return CSRMatrix.from_scipy(K)


def plate_stress_syn() -> CSRMatrix:
    """bcsstk16-class: SPD plane-stress plate, n=4900-ish, uniform
    thickness (moderate conditioning)."""
    return _assemble_plate(60, 39, lambda ex, ey: 1.0)   # n = 4880


def shell_stress_syn() -> CSRMatrix:
    """s2rmq4m1-class: same structure with thickness graded over 1e8
    (the s*rmq4m1 family is the SAME shell scaled to conditioning
    levels; s2 sits at cond ~1e8)."""
    nex, ney = 55, 48                                     # n = 5390

    def thick(ex, ey):
        return 10.0 ** (-6.3 * ex / (nex - 1))
    return _assemble_plate(nex, ney, thick)
