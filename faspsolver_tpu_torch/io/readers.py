"""Readers for every reference on-disk matrix/vector format.

Reference: base/src/BlaIO.c.  Formats (all whitespace-separated text, with
optional leading ``%``/``!`` comment lines):

- CSR        (fasp_dcsr_read,     BlaIO.c:252):  n; IA[0..n]; JA[0..nnz-1];
              val[0..nnz-1].  1-based indices auto-detected and shifted.
- CSR+rhs    (fasp_dcsrvec_read2, BlaIO.c:164):  same matrix file (strictly
              1-based), rhs file: n; b[0..n-1].
- COO / IJ   (fasp_dcoo_read,     BlaIO.c:332):  nrow ncol nnz; then
              "i j a_ij" triplets, 0-based.
- MatrixMarket (fasp_dmtx_read / fasp_dmtxsym_read, BlaIO.c:567,624).
- STR        (fasp_dstr_read,     BlaIO.c:699):  nx ny nz; nc; nband; then
              diagonal band and per-offset bands.
- BSR        (fasp_dbsr_read,     BlaIO.c:807):  ROW COL NNZ; nb; storage;
              len+IA; len+JA; len+val.
- vec        (fasp_dvec_read,     BlaIO.c:938):  n; values.
- vec w/ind  (fasp_dvecind_read,  BlaIO.c:887):  n; "i value" pairs.
"""
from __future__ import annotations

import io as _io
from typing import List, Tuple

import numpy as np
import scipy.io as sio

from ..constants import ERROR_WRONG_FILE
from ..formats import BSRMatrix, CSRMatrix, STRMatrix
from ..utils.errors import FaspError


class _Tokens:
    """Stream of whitespace-separated tokens with comment skipping."""

    def __init__(self, path: str):
        toks: List[str] = []
        with open(path, "r") as fh:
            for line in fh:
                ls = line.lstrip()
                if ls.startswith("%") or ls.startswith("!"):
                    continue
                toks.extend(line.split())
        self._toks = toks
        self._pos = 0
        self.path = path

    def ints(self, k: int) -> np.ndarray:
        return self._array(k, np.int64)

    def floats(self, k: int) -> np.ndarray:
        return self._array(k, np.float64)

    def int1(self) -> int:
        return int(self._next())

    def float1(self) -> float:
        return float(self._next())

    def _array(self, k: int, dtype) -> np.ndarray:
        if self._pos + k > len(self._toks):
            raise FaspError(ERROR_WRONG_FILE,
                            f"{self.path}: truncated (need {k} more tokens)")
        out = np.array(self._toks[self._pos:self._pos + k], dtype=dtype)
        self._pos += k
        return out

    def _next(self) -> str:
        if self._pos >= len(self._toks):
            raise FaspError(ERROR_WRONG_FILE, f"{self.path}: truncated")
        t = self._toks[self._pos]
        self._pos += 1
        return t


def read_csr(path: str) -> CSRMatrix:
    """Square CSR file (reference: fasp_dcsr_read, BlaIO.c:252)."""
    t = _Tokens(path)
    n = t.int1()
    indptr = t.ints(n + 1)
    if indptr[0] == 1:
        indptr = indptr - 1
    nnz = int(indptr[n] - indptr[0])
    indices = t.ints(nnz)
    if nnz and indices[0] == 1:
        indices = indices - 1
    data = t.floats(nnz)
    return CSRMatrix(indptr, indices, data, (n, n))


def read_csrvec(matpath: str, rhspath: str) -> Tuple[CSRMatrix, np.ndarray]:
    """Matrix + rhs pair, 1-based matrix file
    (reference: fasp_dcsrvec_read2, BlaIO.c:164)."""
    t = _Tokens(matpath)
    n = t.int1()
    indptr = t.ints(n + 1) - 1
    nnz = int(indptr[n])
    indices = t.ints(nnz) - 1
    data = t.floats(nnz)
    A = CSRMatrix(indptr, indices, data, (n, n))
    b = read_vec(rhspath)
    if len(b) != n:
        raise FaspError(ERROR_WRONG_FILE,
                        f"rhs size {len(b)} != matrix size {n}")
    return A, b


def read_coo(path: str) -> CSRMatrix:
    """0-based IJ triplet file (reference: fasp_dcoo_read, BlaIO.c:332)."""
    t = _Tokens(path)
    nrow, ncol, nnz = t.int1(), t.int1(), t.int1()
    trip = t.floats(3 * nnz).reshape(nnz, 3)
    return CSRMatrix.from_coo(trip[:, 0].astype(np.int64),
                              trip[:, 1].astype(np.int64),
                              trip[:, 2], (nrow, ncol))


def read_mtx(path: str, symmetric=None) -> CSRMatrix:
    """MatrixMarket file (reference: fasp_dmtx_read / fasp_dmtxsym_read,
    BlaIO.c:567,624).

    The reference data ships *bannerless* mtx files: ``nrow ncol nnz`` header
    then 1-based ``i j v`` triplets, symmetric ones storing one triangle.
    Bannered MatrixMarket files are also accepted.  ``symmetric``:
    True = mirror the stored triangle; False = read as-is; None = auto
    (mirror iff all stored entries lie in one strict triangle).
    """
    with open(path, "r") as fh:
        first = fh.readline()
    if first.startswith("%%MatrixMarket"):
        return CSRMatrix.from_scipy(sio.mmread(path).tocsr())
    t = _Tokens(path)
    nrow, ncol, nnz = t.int1(), t.int1(), t.int1()
    trip = t.floats(3 * nnz).reshape(nnz, 3)
    rows = trip[:, 0].astype(np.int64) - 1
    cols = trip[:, 1].astype(np.int64) - 1
    vals = trip[:, 2]
    if symmetric is None:
        offdiag = rows != cols
        symmetric = (np.all(rows[offdiag] >= cols[offdiag])
                     or np.all(rows[offdiag] <= cols[offdiag])) \
            and bool(offdiag.any())
    if symmetric:
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, trip[off, 0].astype(np.int64) - 1])
        vals = np.concatenate([vals, vals[off]])
    return CSRMatrix.from_coo(rows, cols, vals, (nrow, ncol))


def read_bsr(path: str) -> BSRMatrix:
    """BSR file (reference: fasp_dbsr_read, BlaIO.c:807)."""
    t = _Tokens(path)
    ROW, COL, NNZ = t.int1(), t.int1(), t.int1()
    nb = t.int1()
    storage = t.int1()   # 0 = row-major within block (only manner shipped)
    nia = t.int1()
    indptr = t.ints(nia)
    nja = t.int1()
    indices = t.ints(nja)
    nval = t.int1()
    val = t.floats(nval)
    if nval != NNZ * nb * nb:
        raise FaspError(ERROR_WRONG_FILE,
                        f"{path}: val length {nval} != NNZ*nb^2")
    data = val.reshape(NNZ, nb, nb)
    if storage != 0:
        data = np.ascontiguousarray(data.transpose(0, 2, 1))
    return BSRMatrix(indptr, indices, data, (ROW, COL))


def read_str(path: str) -> STRMatrix:
    """STR banded file (reference: fasp_dstr_read, BlaIO.c:699)."""
    t = _Tokens(path)
    nx, ny, nz = t.int1(), t.int1(), t.int1()
    nc = t.int1()
    nband = t.int1()
    ngrid = nx * ny * nz
    ndiag = t.int1()
    diag = t.floats(ndiag).reshape(ngrid, nc, nc)
    offsets, bands = [], []
    for _ in range(nband):
        off = t.int1()
        ln = t.int1()
        band = np.zeros((ngrid, nc, nc))
        vals = t.floats(ln).reshape(-1, nc, nc)
        if off > 0:
            band[:ngrid - off] = vals
        else:
            band[-off:] = vals
        offsets.append(off)
        bands.append(band)
    return STRMatrix(nx, ny, nz, nc, diag, tuple(offsets), bands)


def read_vec(path: str) -> np.ndarray:
    """Plain vector file (reference: fasp_dvec_read, BlaIO.c:938)."""
    t = _Tokens(path)
    n = t.int1()
    return t.floats(n)


def read_vecind(path: str) -> np.ndarray:
    """Indexed vector file (reference: fasp_dvecind_read, BlaIO.c:887)."""
    t = _Tokens(path)
    n = t.int1()
    pairs = t.floats(2 * n).reshape(n, 2)
    out = np.zeros(n)
    out[pairs[:, 0].astype(np.int64)] = pairs[:, 1]
    return out


def matrix_read(path: str):
    """Generic dispatch by extension/content
    (reference: fasp_matrix_read, BlaIO.c:1735)."""
    if path.endswith(".mtx"):
        return read_mtx(path)
    if "bsr" in path:
        return read_bsr(path)
    return read_csr(path)


def read_coovec_bin(matpath: str, rhspath: str = None, endian: str = "little"
                    ) -> Tuple[CSRMatrix, np.ndarray]:
    """Binary COO matrix (+ optional rhs) with endianness handling
    (reference: fasp_dcoovec_bin_read, BlaIO.c:437 + fasp_aux_change_endian,
    AuxConvert.c).  Layout: int32 n, nnz; then nnz * (int32 i, int32 j,
    float64 v); rhs file: int32 n then n float64."""
    sw = "<" if endian == "little" else ">"
    with open(matpath, "rb") as f:
        hdr = np.fromfile(f, dtype=sw + "i4", count=2)
        if len(hdr) != 2:
            raise FaspError(ERROR_WRONG_FILE, f"truncated binary {matpath}")
        n, nnz = int(hdr[0]), int(hdr[1])
        rec = np.dtype([("i", sw + "i4"), ("j", sw + "i4"),
                        ("v", sw + "f8")])
        trip = np.fromfile(f, dtype=rec, count=nnz)
    if len(trip) != nnz:
        raise FaspError(ERROR_WRONG_FILE, f"truncated binary {matpath}")
    A = CSRMatrix.from_coo(trip["i"].astype(np.int64),
                           trip["j"].astype(np.int64),
                           trip["v"].astype(np.float64), (n, n))
    b = None
    if rhspath is not None:
        with open(rhspath, "rb") as f:
            nb = int(np.fromfile(f, dtype=sw + "i4", count=1)[0])
            b = np.fromfile(f, dtype=sw + "f8", count=nb).astype(np.float64)
    return A, b


def _hb_fields(lines, nlines, fmt, count, conv):
    """Read `count` fixed-width Fortran fields from `nlines` lines.

    fmt is a Fortran edit descriptor like (16I5), (4E20.12), (1P5D16.8);
    HB fields may be packed with no separating whitespace, so slicing by
    the declared width is the only correct parse."""
    import re
    m = re.search(r"\(\s*(?:\d+\s*P\s*,?\s*)?(\d*)\s*([IEDFG])\s*(\d+)",
                  fmt.upper())
    if m is None:
        raise FaspError(ERROR_WRONG_FILE, f"bad HB format '{fmt}'")
    width = int(m.group(3))
    out = []
    for _ in range(nlines):
        line = next(lines).rstrip("\n")
        for i in range(0, len(line), width):
            s = line[i:i + width].strip()
            if s:
                out.append(conv(s.replace("D", "E").replace("d", "e")))
    if len(out) < count:
        raise FaspError(ERROR_WRONG_FILE, "truncated HB data section")
    return out[:count]


def read_hb(path: str) -> Tuple[CSRMatrix, np.ndarray]:
    """Harwell-Boeing reader (reference: fasp_hb_read, BlaIO.c:2206, backed
    by base/extra/hb_io).  Returns (A, rhs-or-None).

    Own fixed-format parser (scipy's hb_read rejects symmetric files).
    Symmetric/Hermitian/skew storage (mxtype[1] in 'SHZ') keeps one
    triangle on disk and is expanded here; general ('U'/'R') matrices —
    including genuinely triangular ones — are left untouched, keyed on the
    header's type flag exactly as the reference does (BlaIO.c:2340), never
    on a triangularity heuristic."""
    import scipy.sparse as sp
    with open(path, "r") as f:
        lines = iter(f.readlines())
    try:
        next(lines)                                   # title/key
        crd = next(lines)
        totcrd = int(crd[0:14])                       # noqa: F841
        ptrcrd = int(crd[14:28])
        indcrd = int(crd[28:42])
        valcrd = int(crd[42:56])
        rhscrd = int(crd[56:70]) if len(crd.rstrip()) > 56 else 0
        l3 = next(lines)
        mxtype = l3[0:3].upper()
        nrow = int(l3[14:28])
        ncol = int(l3[28:42])
        nnz = int(l3[42:56])
        l4 = next(lines)
        ptrfmt, indfmt = l4[0:16], l4[16:32]
        valfmt = l4[32:52]
        rhsfmt = l4[52:72] if len(l4.rstrip()) > 52 else ""
        if rhscrd > 0:
            next(lines)                               # RHSTYP line
        colptr = np.array(_hb_fields(lines, ptrcrd, ptrfmt, ncol + 1, int),
                          dtype=np.int64) - 1
        rowind = np.array(_hb_fields(lines, indcrd, indfmt, nnz, int),
                          dtype=np.int64) - 1
        if mxtype[0] == "P" or valcrd == 0:           # pattern-only
            vals = np.ones(nnz)
        else:
            vals = np.array(_hb_fields(lines, valcrd, valfmt, nnz, float))
        rhs = None
        if rhscrd > 0:
            rhs = np.array(_hb_fields(lines, rhscrd, rhsfmt, nrow, float))
    except (StopIteration, ValueError) as e:
        raise FaspError(ERROR_WRONG_FILE, f"bad HB file {path}: {e}")
    m = sp.csc_matrix((vals, rowind, colptr), shape=(nrow, ncol)).tocsr()
    sym_flag = mxtype[1] if len(mxtype) >= 2 else "U"
    if sym_flag in ("S", "H", "Z"):
        off = sp.triu(m, k=1) + sp.tril(m, k=-1)   # stored off-diag triangle
        sign = -1.0 if sym_flag == "Z" else 1.0
        m = m + sign * off.T
    return CSRMatrix.from_scipy(m.tocsr()), rhs


def read_mesh(path: str):
    """Reference FEM mesh file (test/src/FemMesh.c): ``nn dim`` + nodes,
    then ``ne dim`` + 1-based element connectivity.  Returns a
    testgen.fem.TriMesh with boundary = nodes on the bounding box."""
    from ..testgen.fem import TriMesh
    t = _Tokens(path)
    nn, dim = t.int1(), t.int1()
    nodes = t.floats(nn * dim).reshape(nn, dim)
    ne, dk = t.int1(), t.int1()
    elems = t.floats(ne * dk).reshape(ne, dk).astype(np.int64) - 1
    lo = nodes.min(axis=0)
    hi = nodes.max(axis=0)
    onb = np.zeros(nn, dtype=bool)
    for d in range(dim):
        onb |= (nodes[:, d] == lo[d]) | (nodes[:, d] == hi[d])
    return TriMesh(nodes=nodes, elems=elems, boundary=onb)
