"""The port's ctypes loader for the native (C++) setup kernels.

There is one source of truth: the library is compiled from the JAX
package's ``faspsolver_tpu/native/fasp_native.cpp`` and ``band_ops.cpp``
(read as sources, never modified or written next to) into the port's
build directory, with the same g++ flags the JAX loader uses, so both
packages run the same setup arithmetic.  Bound: the structured-setup
entries (``dia_from_csr``, ``smoothed_rap``) and the classical RS-AMG
ones (``dia_hist``, ``dia_split``, ``rap``, ``strength_graph``,
``agg_strength``, ``rs_cf_split2``, ``rs_ff_pass``, ``interp_std``,
``fgs_sweeps``).  Like the JAX loader, each entry returns None when the
library cannot be built; the callers then take their NumPy path.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils.build import build_shared

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCES = (os.path.join(_REPO, "faspsolver_tpu", "native", "fasp_native.cpp"),
            os.path.join(_REPO, "faspsolver_tpu", "native", "band_ops.cpp"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _gxx(sources, out):
    return ["g++", "-O3", "-march=native", "-std=c++17", "-fopenmp",
            "-shared", "-fPIC", *sources, "-o", out]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_shared("fasp_native", _SOURCES, _gxx))
        except (OSError, RuntimeError, FileNotFoundError) as e:
            build_error = str(e)
            return None
        lib.fasp_dia_offsets.restype = ctypes.c_int64
        lib.fasp_dia_offsets.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                         ctypes.c_int64, _i64p]
        for suf, fp, ct in (("f64", _f64p, ctypes.c_double),
                            ("f32", _f32p, ctypes.c_float)):
            fill = getattr(lib, f"fasp_dia_fill_{suf}")
            fill.restype = None
            fill.argtypes = [ctypes.c_int64, _i64p, _i64p, _f64p,
                             ctypes.c_int64, _i64p, fp]
            sr = getattr(lib, f"fasp_smoothed_rap_3d_{suf}")
            sr.restype = ctypes.c_int
            sr.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _i32p, fp, fp, ct,
                           ctypes.c_int, ctypes.c_int, _i32p, fp]
            split = getattr(lib, f"fasp_dia_split_{suf}")
            split.restype = ctypes.c_int64
            split.argtypes = [ctypes.c_int64, _i64p, _i64p, _f64p,
                              ctypes.c_int64, _i64p, fp, _i32p, _i32p, fp,
                              ctypes.c_int64]
        lib.fasp_dia_hist.restype = None
        lib.fasp_dia_hist.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
        lib.fasp_rap.restype = ctypes.c_int64
        lib.fasp_rap.argtypes = [ctypes.c_int64,
                                 _i64p, _i64p, _f64p,
                                 _i64p, _i64p, _f64p,
                                 _i64p, _i64p, _f64p,
                                 ctypes.c_int64, _i64p, _i64p, _f64p]
        lib.fasp_strength_graph.restype = ctypes.c_int64
        lib.fasp_strength_graph.argtypes = [ctypes.c_int, _i32p, _i32p,
                                            _f64p, ctypes.c_double,
                                            ctypes.c_double, _i32p, _i32p]
        lib.fasp_agg_strength.restype = ctypes.c_int64
        lib.fasp_agg_strength.argtypes = [ctypes.c_int, _i32p, _i32p,
                                          _i32p, ctypes.c_int, _i32p,
                                          _i32p, ctypes.c_int64]
        lib.fasp_rs_cf_split2.restype = ctypes.c_int
        lib.fasp_rs_cf_split2.argtypes = [ctypes.c_int, _i32p, _i32p, _i32p]
        lib.fasp_rs_ff_pass.restype = ctypes.c_int
        lib.fasp_rs_ff_pass.argtypes = [ctypes.c_int, _i32p, _i32p, _i32p]
        lib.fasp_interp_std.restype = ctypes.c_int
        lib.fasp_interp_std.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                        _i32p, _i32p, _i32p, ctypes.c_int,
                                        _i32p, _i32p, _f64p, ctypes.c_int64]
        lib.fasp_fgs_sweeps.restype = ctypes.c_int
        lib.fasp_fgs_sweeps.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                        _i32p, _f64p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def dia_from_csr(A, max_k: int = 128,
                 out_dtype=None) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(offsets, row-aligned (k, n) bands) for a square f64 CSR matrix;
    None when the library is unavailable, the data is not f64, or
    k > max_k."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64 or A.nrow != A.ncol \
            or A.nrow == 0:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    n = A.nrow
    offs = np.empty(max_k, dtype=np.int64)
    k = int(lib.fasp_dia_offsets(n, indptr, indices, max_k, offs))
    if k < 0 or k > max_k:
        return None
    offs = offs[:k].copy()
    out_dtype = np.dtype(out_dtype) if out_dtype is not None \
        else np.dtype(np.float64)
    bands = np.zeros((k, n), dtype=out_dtype)
    if out_dtype == np.float32:
        lib.fasp_dia_fill_f32(n, indptr, indices, data, k, offs, bands)
    elif out_dtype == np.float64:
        lib.fasp_dia_fill_f64(n, indptr, indices, data, k, offs, bands)
    else:
        return None
    return offs, bands


def smoothed_rap(dims, coords, bands, dinv, omega: float, s: int):
    """Fused coarse Galerkin product over a 2-D / 3-D grid:
    Ac = P^T (I - w A D^-1) A (I - w D^-1 A) P with P the boolean
    s-per-axis grouping over every axis of extent > 1 (w = 0: plain UA
    RAP).  bands: (k, *dims); coords: (k, nd) int32; dinv: grid array.
    Returns (coarse_coords, coarse_bands (kc, *cdims), cdims) or None."""
    lib = _load()
    if lib is None:
        return None
    nd = len(dims)
    if nd == 2:
        ny, nx = dims
        nz = 1
        k = len(coords)
        cf = np.zeros((k, 3), dtype=np.int32)
        cf[:, 1:] = coords
        bands = bands.reshape(k, 1, ny, nx)
    elif nd == 3:
        nz, ny, nx = dims
        cf = np.ascontiguousarray(coords, dtype=np.int32)
    else:
        return None
    k = len(cf)
    dtype = bands.dtype
    if dtype not in (np.float32, np.float64):
        return None
    # symbolic bound on the coarse band count: coords of M = A + A2 + A3
    # phase-divided by s (mirror of the C++ symbolic pass)
    acc = {tuple(int(v) for v in c) for c in cf}
    if float(omega) != 0.0:
        a2 = {tuple(x + y for x, y in zip(c1, c2)) for c1 in acc for c2 in acc}
        a3 = {tuple(x + y for x, y in zip(c1, c2)) for c1 in a2 for c2 in acc}
        mset = acc | a2 | a3
    else:
        mset = acc
    grp = [d > 1 for d in (nz, ny, nx)]
    uniq = set()
    for m in mset:
        for az in range(s if grp[0] else 1):
            for ay in range(s if grp[1] else 1):
                for ax in range(s if grp[2] else 1):
                    uniq.add(tuple(
                        (c + a) // s if g else c
                        for c, a, g in zip(m, (az, ay, ax), grp)))
    max_kc = len(uniq)
    fn = (lib.fasp_smoothed_rap_3d_f32 if dtype == np.float32
          else lib.fasp_smoothed_rap_3d_f64)
    cdims3 = [nz, ny, nx]
    for d in range(3):
        if grp[d]:
            cdims3[d] = (cdims3[d] + s - 1) // s
    F = np.ascontiguousarray(bands)
    dv = np.ascontiguousarray(dinv.reshape(-1), dtype=dtype)
    cc = np.empty((max_kc, 3), dtype=np.int32)
    C = np.empty((max_kc, cdims3[0], cdims3[1], cdims3[2]), dtype=dtype)
    kc = fn(nz, ny, nx, k, cf, F, dv, dtype.type(omega), int(s),
            max_kc, cc, C)
    if kc < 0:
        return None
    if nd == 2:
        return (cc[:kc, 1:], C[:kc].reshape(kc, cdims3[1], cdims3[2]),
                tuple(cdims3[1:]))
    return cc[:kc], C[:kc], tuple(cdims3)


def _csr_arrays(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    return indptr, indices, data, A.shape[0]


def dia_hist(A) -> Optional[np.ndarray]:
    """Histogram of diagonal offsets: (2n+1,) int64 counts with
    hist[off + n] = #entries on diagonal ``off``; None without the
    library."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64 or A.nrow != A.ncol \
            or A.nrow == 0:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    hist = np.zeros(2 * A.nrow + 1, dtype=np.int64)
    lib.fasp_dia_hist(A.nrow, indptr, indices, hist)
    return hist


def dia_split(A, keep_offs: np.ndarray, dtype, nrem: int,
              rem_pad: int) -> Optional[tuple]:
    """Split CSR into row-aligned bands over ``keep_offs`` (ascending)
    plus a COO remainder (CSR order, padded to ``rem_pad`` with
    row=n / col=0 / val=0).  Returns (bands, rem_rows, rem_cols,
    rem_vals) or None without the library."""
    lib = _load()
    dtype = np.dtype(dtype)
    if lib is None or A.data.dtype != np.float64 \
            or dtype not in (np.float32, np.float64):
        return None
    n = A.nrow
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    keep_offs = np.ascontiguousarray(keep_offs, dtype=np.int64)
    k = len(keep_offs)
    bands = np.zeros((k, n), dtype=dtype)
    pad = max(int(rem_pad), 1)
    rem_rows = np.full(pad, n, dtype=np.int32)
    rem_cols = np.zeros(pad, dtype=np.int32)
    rem_vals = np.zeros(pad, dtype=dtype)
    fn = lib.fasp_dia_split_f32 if dtype == np.float32 \
        else lib.fasp_dia_split_f64
    got = int(fn(n, indptr, indices, data, k, keep_offs, bands,
                 rem_rows, rem_cols, rem_vals, pad))
    if got != nrem:
        return None
    return bands, rem_rows, rem_cols, rem_vals


def rap(R, A, P):
    """Fused Galerkin product C = R A P for general CSR matrices (the
    reference's fasp_blas_dcsr_rap, BlaSpmvCSR.c:999).  Returns a
    CSRMatrix with sorted row indices, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    from ..formats import CSRMatrix

    def _arrs(M):
        return (np.ascontiguousarray(M.indptr, dtype=np.int64),
                np.ascontiguousarray(M.indices, dtype=np.int64),
                np.ascontiguousarray(M.data, dtype=np.float64))

    Rp, Rj, Rx = _arrs(R)
    Ap_, Aj, Ax = _arrs(A)
    Pp, Pj, Px = _arrs(P)
    nc = R.shape[0]
    Cp = np.empty(nc + 1, dtype=np.int64)
    cap = max(int(1.3 * A.nnz) + 8 * nc, 1 << 12)
    for _ in range(3):
        Cj = np.empty(cap, dtype=np.int64)
        Cx = np.empty(cap, dtype=np.float64)
        nnz = int(lib.fasp_rap(nc, Rp, Rj, Rx, Ap_, Aj, Ax, Pp, Pj, Px,
                               cap, Cp, Cj, Cx))
        if nnz >= 0:
            return CSRMatrix(Cp, Cj[:nnz].copy(), Cx[:nnz].copy(),
                             (nc, P.shape[1]))
        cap *= 4
    return None


def strength_graph(A, theta: float, max_row_sum: float):
    """Strength CSR (indptr, indices); the data is implicitly all ones."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    s_indptr = np.zeros(n + 1, dtype=np.int32)
    s_indices = np.empty(max(len(indices), 1), dtype=np.int32)
    snnz = lib.fasp_strength_graph(n, indptr, indices, data,
                                   float(theta), float(max_row_sum),
                                   s_indptr, s_indices)
    return s_indptr, s_indices[:snnz]


def agg_strength(s_indptr, s_indices, n: int, cf: np.ndarray,
                 path: int, num_c: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Strength graph between temporary C points for aggressive
    coarsening (reference: strong_couplings_agg1/agg2,
    PreAMGCoarsenRS.c): a direct S edge or >= ``path`` distinct 2-hop
    paths through F points.  (sh_indptr, sh_indices) over coarse
    indices, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    sp_ = np.ascontiguousarray(s_indptr, dtype=np.int32)
    si_ = np.ascontiguousarray(s_indices, dtype=np.int32)
    cf_ = np.ascontiguousarray(cf, dtype=np.int32)
    shp = np.zeros(num_c + 1, dtype=np.int32)
    cap = max(int(si_.size) * 4 + 16 * num_c, 1 << 12)
    for _ in range(3):
        shi = np.empty(cap, dtype=np.int32)
        nnz = int(lib.fasp_agg_strength(n, sp_, si_, cf_, path, shp,
                                        shi, cap))
        if nnz >= 0:
            return shp, shi[:nnz].copy()
        cap *= 4
    return None


def rs_cf_split2(s_indptr, s_indices, n: int) -> Optional[np.ndarray]:
    """Bucket-list classical RS first pass (S^T built internally)."""
    lib = _load()
    if lib is None:
        return None
    cf = np.empty(n, dtype=np.int32)
    lib.fasp_rs_cf_split2(
        n, np.ascontiguousarray(s_indptr, dtype=np.int32),
        np.ascontiguousarray(s_indices, dtype=np.int32), cf)
    return cf


def rs_ff_pass(S, cf: np.ndarray) -> Optional[np.ndarray]:
    """RS pass 2: promote F points whose strong F-F pair shares no C.
    cf: int array (1=C, 0=F, 2=isolated); returns the updated copy."""
    lib = _load()
    if lib is None:
        return None
    s_indptr, s_indices, _, n = _csr_arrays(S)
    out = np.ascontiguousarray(cf, dtype=np.int32).copy()
    lib.fasp_rs_ff_pass(n, s_indptr, s_indices, out)
    return out


def interp_std(A, cf: np.ndarray, S, mode: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Interpolation triplets (rows, coarse cols, vals).
    mode: 0 = standard, 1 = ext+i, 2 = direct."""
    lib = _load()
    if lib is None:
        return None
    m = A.to_scipy().tocsr()
    indptr, indices, data, n = _csr_arrays(m)
    Sr = S.tocsr()
    s_indptr = np.ascontiguousarray(Sr.indptr, dtype=np.int32)
    s_indices = np.ascontiguousarray(Sr.indices, dtype=np.int32)
    cf32 = np.ascontiguousarray(cf, dtype=np.int32)
    cap = max(int(m.nnz * 2) + n + 16, 256)
    for _ in range(6):
        p_rows = np.empty(cap, dtype=np.int32)
        p_cols = np.empty(cap, dtype=np.int32)
        p_vals = np.empty(cap, dtype=np.float64)
        nnz = lib.fasp_interp_std(n, indptr, indices, data, cf32,
                                  s_indptr, s_indices, int(mode),
                                  p_rows, p_cols, p_vals, cap)
        if nnz >= 0:
            return p_rows[:nnz], p_cols[:nnz], p_vals[:nnz]
        cap *= 4
    return None


def fgs_sweeps(A, marker: np.ndarray, e: np.ndarray, sweeps: int
               ) -> Optional[np.ndarray]:
    """F-point Gauss-Seidel sweeps on A e = 0 (the compatible-relaxation
    smoother of CR coarsening)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    mk = np.ascontiguousarray(marker, dtype=np.int32)
    out = np.ascontiguousarray(e, dtype=np.float64).copy()
    lib.fasp_fgs_sweeps(n, indptr, indices, data, mk, out, int(sweeps))
    return out
