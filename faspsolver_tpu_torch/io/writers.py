"""Writers matching the reference on-disk formats (round-trip with readers).

Reference: base/src/BlaIO.c writer family (:1079-1700).
"""
from __future__ import annotations

import numpy as np

from ..formats import BSRMatrix, CSRMatrix


def write_csr(path: str, A: CSRMatrix, one_based: bool = True) -> None:
    """(reference: fasp_dcsr_write)."""
    off = 1 if one_based else 0
    with open(path, "w") as fh:
        fh.write(f"{A.nrow}\n")
        for v in A.indptr:
            fh.write(f"{int(v) + off}\n")
        for v in A.indices:
            fh.write(f"{int(v) + off}\n")
        for v in A.data:
            fh.write(f"{v:.16e}\n")


def write_coo(path: str, A: CSRMatrix) -> None:
    """(reference: fasp_dcoo_write)."""
    m = A.to_scipy().tocoo()
    with open(path, "w") as fh:
        fh.write(f"{A.nrow} {A.ncol} {A.nnz}\n")
        for i, j, v in zip(m.row, m.col, m.data):
            fh.write(f"{i} {j} {v:.16e}\n")


def write_bsr(path: str, A: BSRMatrix) -> None:
    """(reference: fasp_dbsr_write)."""
    with open(path, "w") as fh:
        fh.write(f"{A.nrow_block} {A.ncol_block} {A.nnz_block}\n")
        fh.write(f"{A.nb}\n0\n")
        fh.write(f"{len(A.indptr)}\n")
        for v in A.indptr:
            fh.write(f"{int(v)}\n")
        fh.write(f"{A.nnz_block}\n")
        for v in A.indices:
            fh.write(f"{int(v)}\n")
        flat = A.data.reshape(-1)
        fh.write(f"{len(flat)}\n")
        for v in flat:
            fh.write(f"{v:.16e}\n")


def write_vec(path: str, b: np.ndarray) -> None:
    """(reference: fasp_dvec_write)."""
    with open(path, "w") as fh:
        fh.write(f"{len(b)}\n")
        for v in b:
            fh.write(f"{v:.16e}\n")


def write_vecind(path: str, b: np.ndarray) -> None:
    """(reference: fasp_dvecind_write)."""
    with open(path, "w") as fh:
        fh.write(f"{len(b)}\n")
        for i, v in enumerate(b):
            fh.write(f"{i} {v:.16e}\n")


def write_mtx(path: str, A: CSRMatrix) -> None:
    """MatrixMarket coordinate writer (reference: BlaIO.c writers)."""
    m = A.to_scipy().tocoo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{A.nrow} {A.ncol} {A.nnz}\n")
        for i, j, v in zip(m.row, m.col, m.data):
            f.write(f"{i + 1} {j + 1} {v:.16e}\n")


def write_str(path: str, A) -> None:
    """STR banded writer (reference: fasp_dstr_write, BlaIO.c).  Bands are
    stored compactly: only the (ngrid - |offset|) valid block rows."""
    with open(path, "w") as f:
        f.write(f"{A.nx} {A.ny} {A.nz}\n{A.nc}\n{A.nband}\n")
        ng, nc = A.ngrid, A.nc
        f.write(f"{ng * nc * nc}\n")
        for v in A.diag.reshape(-1):
            f.write(f"{v:.16e}\n")
        for off, band in zip(A.offsets, A.offdiag):
            valid = band[:ng - off] if off > 0 else band[-off:]
            f.write(f"{off} {valid.size}\n")
            for v in valid.reshape(-1):
                f.write(f"{v:.16e}\n")


def write_coovec_bin(matpath: str, A: CSRMatrix, rhspath: str = None,
                     b=None, endian: str = "little") -> None:
    """Binary COO (+rhs) writer, endian-parameterized (reference:
    BlaIO.c binary writers + AuxConvert.c)."""
    import numpy as np
    sw = "<" if endian == "little" else ">"
    m = A.to_scipy().tocoo()
    with open(matpath, "wb") as f:
        np.asarray([A.nrow, A.nnz], dtype=sw + "i4").tofile(f)
        rec = np.empty(A.nnz, dtype=np.dtype(
            [("i", sw + "i4"), ("j", sw + "i4"), ("v", sw + "f8")]))
        rec["i"], rec["j"], rec["v"] = m.row, m.col, m.data
        rec.tofile(f)
    if rhspath is not None and b is not None:
        with open(rhspath, "wb") as f:
            np.asarray([len(b)], dtype=sw + "i4").tofile(f)
            np.asarray(b, dtype=sw + "f8").tofile(f)


def write_samg(basename: str, A: CSRMatrix) -> None:
    """Export in SAMG input format: ``basename.frm`` (header) +
    ``basename.amg`` (1-based indptr, column indices, values), diagonal
    entries first in each row (reference: fasp_dcsr_write_samg /
    XtrSamg.c:145 — matrix_type 11/12/21/22 by symmetry x zero-rowsum).
    """
    m = A.to_scipy().tocsr()
    n = m.shape[0]
    # diagonal-first row ordering (reference: fasp_dcsr_diagpref)
    indptr = m.indptr
    indices = m.indices.copy()
    data = m.data.copy()
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        row = indices[s:e]
        d = np.nonzero(row == i)[0]
        if len(d) and d[0] != 0:
            k = s + d[0]
            indices[s + 1:k + 1], indices[s] = indices[s:k].copy(), i
            v = data[k]
            data[s + 1:k + 1] = data[s:k].copy()
            data[s] = v
    symmetric = (abs(m - m.T) > 1e-12 * max(abs(m).max(), 1e-300)).nnz == 0
    rowsums_zero = bool(np.all(np.abs(np.asarray(m.sum(axis=1))).ravel()
                               < 1e-10))
    matrix_type = (21 if symmetric else 11) + (1 if rowsums_zero else 0)
    with open(basename + ".frm", "w") as fp:
        fp.write("f   4\n")
        fp.write(f"{m.nnz} {n} {matrix_type} 1 0\n")
    with open(basename + ".amg", "w") as fp:
        for v in indptr:
            fp.write(f"{int(v) + 1}\n")
        for v in indices:
            fp.write(f"{int(v) + 1}\n")
        for v in data:
            fp.write(f"{v:.15e}\n")
