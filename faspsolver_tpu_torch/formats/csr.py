"""Host-side CSR container: the ingest/setup-phase sparse matrix.

TPU-native architecture note: the reference keeps one C struct (dCSRmat,
base/include/fasp.h:151-180) for both setup and solve.  The TPU build splits
the roles: this host container (numpy arrays) is used for I/O, format
conversion, and AMG/ILU setup-phase graph algorithms; the solve phase operates
on static-shaped device operators built from it (see
faspsolver_tpu.ops.device_formats).

Functionality parity targets (reference files):
- container ops:      base/src/BlaSparseCSR.c   (create/trans/getdiag/perm/...)
- property checks:    base/src/BlaSparseCheck.c (fasp_check_symm/diagpos/...)
- orderings:          base/src/BlaOrderingCSR.c (CMK / reverse CMK)
- multicoloring:      base/src/BlaSparseCSR.c:1687 dCSRmat_Multicoloring
- format conversion:  base/src/BlaFormat.c
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..constants import ERROR_DATA_STRUCTURE, ERROR_DATA_ZERODIAG
from ..utils.errors import FaspError


@dataclass
class CSRMatrix:
    """Compressed sparse row matrix with int32 indices, float64/float32 data."""

    indptr: np.ndarray       # (nrow+1,)
    indices: np.ndarray      # (nnz,)
    data: np.ndarray         # (nnz,)
    shape: Tuple[int, int]

    def __post_init__(self):
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int64)
        self.data = np.ascontiguousarray(self.data)
        if self.indptr.ndim != 1 or len(self.indptr) != self.shape[0] + 1:
            raise FaspError(ERROR_DATA_STRUCTURE, "bad indptr length")
        if len(self.indices) != len(self.data):
            raise FaspError(ERROR_DATA_STRUCTURE, "indices/data length mismatch")
        # canonicalize to row-sorted column order.  The reference's on-disk
        # convention stores the diagonal first in each row (DIAGONAL_PREF);
        # unsorted rows are a correctness hazard downstream: scipy wrappers
        # built on views may sort indices into a *copied* index array while
        # permuting the *shared* data array (int64->int32 index downcast),
        # silently corrupting this matrix.  Sorting once here makes every
        # later sort a no-op.
        if len(self.indices) and self.shape[0]:
            nnz_per_row = np.diff(self.indptr)
            rows = np.repeat(np.arange(self.shape[0], dtype=np.int64),
                             nnz_per_row)
            within = np.diff(self.indices) <= 0
            same_row = rows[1:] == rows[:-1]
            if np.any(within & same_row):
                order = np.lexsort((self.indices, rows))
                self.indices = self.indices[order]
                self.data = self.data[order]

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, sum_duplicates=True) -> "CSRMatrix":
        m = sp.coo_matrix((vals, (rows, cols)), shape=shape)
        if sum_duplicates:
            m.sum_duplicates()
        return cls.from_scipy(m.tocsr())

    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        m = m.tocsr()
        m.sort_indices()
        return cls(m.indptr, m.indices, m.data, m.shape)

    @classmethod
    def from_dense(cls, dense) -> "CSRMatrix":
        return cls.from_scipy(sp.csr_matrix(np.asarray(dense)))

    @classmethod
    def eye(cls, n, dtype=np.float64) -> "CSRMatrix":
        return cls(np.arange(n + 1), np.arange(n), np.ones(n, dtype=dtype),
                   (n, n))

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # -- basic properties ---------------------------------------------------

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @property
    def dtype(self):
        return self.data.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    # -- container operations (reference: BlaSparseCSR.c) -------------------

    def transpose(self) -> "CSRMatrix":
        """R = A^T (reference: fasp_dcsr_trans, BlaSparseCSR.c:~850)."""
        return CSRMatrix.from_scipy(self.to_scipy().T.tocsr())

    def diagonal(self) -> np.ndarray:
        """Extract diagonal (reference: fasp_dcsr_getdiag)."""
        return self.to_scipy().diagonal()

    def check_diag_nonzero(self) -> None:
        d = self.diagonal()
        if np.any(d == 0.0):
            raise FaspError(ERROR_DATA_ZERODIAG,
                            f"{np.count_nonzero(d == 0)} zero diagonal entries")

    def compress(self, drop_tol: float = 0.0) -> "CSRMatrix":
        """Drop small entries (reference: fasp_dcsr_compress)."""
        keep_mask_rows = []
        m = self.to_scipy().copy()
        m.data[np.abs(m.data) <= drop_tol] = 0.0
        m.eliminate_zeros()
        return CSRMatrix.from_scipy(m)

    def permute(self, p: np.ndarray) -> "CSRMatrix":
        """Symmetric permutation B = A[p,:][:,p] (reference: fasp_dcsr_perm)."""
        m = self.to_scipy()
        return CSRMatrix.from_scipy(m[p, :][:, p])

    def get_block(self, rows: np.ndarray, cols: np.ndarray) -> "CSRMatrix":
        """Submatrix extraction (reference: fasp_dcsr_getblk)."""
        m = self.to_scipy()
        return CSRMatrix.from_scipy(m[rows, :][:, cols])

    def sympart(self) -> "CSRMatrix":
        """Symmetric part (A + A^T)/2 (reference: fasp_dcsr_sympart)."""
        m = self.to_scipy()
        return CSRMatrix.from_scipy((m + m.T) * 0.5)

    def sym_diag_scale(self) -> Tuple["CSRMatrix", np.ndarray]:
        """D^{-1/2} A D^{-1/2} (reference: fasp_dcsr_symdiagscale)."""
        d = self.diagonal()
        if np.any(d <= 0):
            raise FaspError(ERROR_DATA_ZERODIAG, "non-positive diagonal")
        s = 1.0 / np.sqrt(d)
        m = self.to_scipy()
        D = sp.diags(s)
        return CSRMatrix.from_scipy(D @ m @ D), s

    def diag_pref(self) -> "CSRMatrix":
        """Reorder each row so the diagonal entry comes first
        (reference: fasp_dcsr_diagpref).  Host-side helper for ILU/GS setup."""
        indptr, indices, data = self.indptr, self.indices.copy(), self.data.copy()
        for i in range(self.nrow):
            s, e = indptr[i], indptr[i + 1]
            row = indices[s:e]
            hit = np.nonzero(row == i)[0]
            if hit.size:
                j = hit[0]
                row[0], row[j] = row[j], row[0]
                seg = data[s:e]
                seg[0], seg[j] = seg[j], seg[0]
        return CSRMatrix(indptr, indices, data, self.shape)

    # -- linear algebra (host reference implementations; device versions in
    #    ops/) --------------------------------------------------------------

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    def rap(self, R: "CSRMatrix", P: "CSRMatrix") -> "CSRMatrix":
        """Galerkin triple product R·A·P for setup phase
        (reference: fasp_blas_dcsr_rap, BlaSpmvCSR.c:999).  Setup-phase only;
        executed once per level on host."""
        return CSRMatrix.from_scipy(
            (R.to_scipy() @ self.to_scipy() @ P.to_scipy()).tocsr())

    # -- property checks (reference: BlaSparseCheck.c) ----------------------

    def is_symmetric(self, tol: float = 1e-12) -> bool:
        m = self.to_scipy()
        diff = (m - m.T)
        if diff.nnz == 0:
            return True
        scale = max(np.abs(m.data).max(), 1.0)
        return np.abs(diff.data).max() <= tol * scale

    def check_diag_positive(self) -> int:
        return int(np.count_nonzero(self.diagonal() > 0))

    def check_diag_dominant(self) -> int:
        """Count rows that are diagonally dominant."""
        m = self.to_scipy()
        abssum = np.abs(m).sum(axis=1).A1 if hasattr(np.abs(m).sum(axis=1), "A1") \
            else np.asarray(np.abs(m).sum(axis=1)).ravel()
        d = np.abs(self.diagonal())
        return int(np.count_nonzero(2 * d >= abssum))

    def validate(self) -> None:
        """Structural sanity (reference: fasp_check_dCSRmat, called by every
        solver driver at SolCSR.c:79)."""
        if np.any(np.diff(self.indptr) < 0):
            raise FaspError(ERROR_DATA_STRUCTURE, "indptr not monotone")
        if self.nnz and (self.indices.min() < 0 or
                         self.indices.max() >= self.ncol):
            raise FaspError(ERROR_DATA_STRUCTURE, "column index out of range")
        if not np.all(np.isfinite(self.data)):
            raise FaspError(ERROR_DATA_STRUCTURE, "non-finite matrix entries")

    # -- orderings (reference: BlaOrderingCSR.c) ----------------------------

    def cmk_order(self) -> np.ndarray:
        """Cuthill-McKee ordering (reference: fasp_dcsr_CMK_order)."""
        perm = sp.csgraph.reverse_cuthill_mckee(self.to_scipy(), symmetric_mode=False)
        return perm[::-1].copy()   # scipy returns the reverse ordering

    def rcm_order(self) -> np.ndarray:
        """Reverse Cuthill-McKee (reference: fasp_dcsr_RCMK_order)."""
        return sp.csgraph.reverse_cuthill_mckee(
            self.to_scipy(), symmetric_mode=False).astype(np.int64)

    # -- multicoloring (reference: BlaSparseCSR.c:1687) ---------------------

    def multicolor(self) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy distance-1 coloring of the adjacency graph.

        Returns (color_of_node[n], color_counts[ncolor]).  Enables the
        color-batched parallel Gauss-Seidel smoother — the same algorithmic
        strategy the reference uses for its OpenMP GS
        (MULTI_COLOR_ORDER, fasp.h:42-50; fasp_smoother_dcsr_gs_multicolor).
        """
        n = self.nrow
        from .. import native
        out = native.greedy_color(self.indptr, self.indices, n)
        if out is not None:
            color, ncolor = out
            color = color.astype(np.int64)
            return color, np.bincount(color, minlength=ncolor)
        colors = np.full(n, -1, dtype=np.int64)
        indptr, indices = self.indptr, self.indices
        maxdeg = int(self.row_nnz().max()) if n else 0
        scratch = np.zeros(maxdeg + 2, dtype=bool)
        for i in range(n):
            nbr_colors = colors[indices[indptr[i]:indptr[i + 1]]]
            scratch[:] = False
            valid = nbr_colors[(nbr_colors >= 0) & (nbr_colors < len(scratch))]
            scratch[valid] = True
            c = int(np.argmin(scratch))  # first False slot
            colors[i] = c
        ncolor = int(colors.max()) + 1 if n else 0
        counts = np.bincount(colors, minlength=ncolor)
        return colors, counts


def spgemm(A: CSRMatrix, B: CSRMatrix) -> CSRMatrix:
    """Host-side sparse matrix product for setup phase
    (reference: fasp_blas_dcsr_mxm, BlaSpmvCSR.c:893)."""
    return CSRMatrix.from_scipy((A.to_scipy() @ B.to_scipy()).tocsr())
