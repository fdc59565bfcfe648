"""Frozen matrix generators, one module per generator name.

Each module has ``build(**params) -> Problem``: the matrix as host CSR
arrays (int64 indices, float64 values), the coordinates of its unknowns
and the source problem's own right-hand side, which the traffic
generator perturbs.  They are copies, kept
here so that the yardstick does not move with the program."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Problem:
    indptr: np.ndarray          # (n + 1,) int64
    indices: np.ndarray         # (nnz,) int64, sorted within each row
    data: np.ndarray            # (nnz,) float64
    coords: np.ndarray          # (n, 2) float64: each unknown's point
    rhs: np.ndarray             # (n,) float64: the source's own b

    @property
    def nrows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.indices)


FIELDS = ("indptr", "indices", "data", "coords", "rhs")


def from_scipy(A, coords, rhs) -> Problem:
    A = A.tocsr()
    A.sort_indices()
    return Problem(np.ascontiguousarray(A.indptr, dtype=np.int64),
                   np.ascontiguousarray(A.indices, dtype=np.int64),
                   np.ascontiguousarray(A.data, dtype=np.float64),
                   np.ascontiguousarray(coords, dtype=np.float64),
                   np.ascontiguousarray(rhs, dtype=np.float64))
