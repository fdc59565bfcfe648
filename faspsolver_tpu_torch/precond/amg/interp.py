"""Classical AMG interpolation operators: direct / standard / extended
with truncation, and energy-minimizing (``interp_energymin``) (port of
``faspsolver_tpu/precond/amg/interp.py``; host NumPy/SciPy and the
shared native C++ entry, the same code as the JAX package's).

Reference: base/src/PreAMGInterp.c:64 (fasp_amg_interp dispatch ->
interp_DIR / interp_STD / interp_EXT + amg_interp_trunc) and
PreAMGInterpEM.c (energy-minimizing interpolation).  The resulting
P becomes a banded or COO transfer module (``transfer.py``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ...constants import CGPT, FGPT, ISPT, InterpType
from ...formats import CSRMatrix


def interpolate(A: CSRMatrix, cf_marker: np.ndarray, S: sp.csr_matrix,
                interp_type: int = int(InterpType.DIRECT),
                trunc_threshold: float = 0.2) -> CSRMatrix:
    if interp_type == InterpType.STANDARD:
        P = interp_standard(A, cf_marker, S)
    elif interp_type == InterpType.EXTENDED:
        P = interp_extended(A, cf_marker, S)
    elif interp_type == InterpType.ENERGYMIN:
        P = interp_energymin(A, cf_marker, S)
    else:
        P = interp_direct(A, cf_marker, S)
    return truncate(P, trunc_threshold)


def interp_energymin(A: CSRMatrix, cf_marker: np.ndarray, S: sp.csr_matrix,
                     iters: int = 4, omega: float = 0.6) -> CSRMatrix:
    """Energy-minimizing interpolation (reference: fasp_amg_interp_em,
    PreAMGInterpEM.c: local least-squares energy minimization).

    Starts from direct interpolation and runs damped constrained-Jacobi
    energy-minimization sweeps

        P <- P - omega D^-1 A P,   restricted to the sparsity pattern
                                   of P0 and rescaled to row sum 1,

    the standard sparsity-constrained iteration (the objective of the
    reference's local solves: least energy of the coarse basis functions
    under partition of unity)."""
    P0 = interp_direct(A, cf_marker, S)
    m = A.to_scipy()
    d = A.diagonal()
    dinv = 1.0 / np.where(d != 0.0, d, 1.0)
    P = P0.to_scipy().tocsr()
    pattern = P.copy()
    pattern.data = np.ones_like(pattern.data)
    for _ in range(iters):
        upd = (sp.diags(omega * dinv) @ (m @ P)).multiply(pattern)
        P = (P - upd).tocsr()
        # re-impose partition of unity (row sums 1 where P0 had mass)
        rs = np.asarray(P.sum(axis=1)).ravel()
        scale = np.where(np.abs(rs) > 1e-12, 1.0 / np.where(rs != 0, rs, 1.0),
                         1.0)
        P = (sp.diags(scale) @ P).tocsr()
    return CSRMatrix.from_scipy(P)


def _csr_from_sorted_triplets(pr, pc, pv, n: int, nc: int) -> CSRMatrix:
    """CSR from row-sorted COO triplets (the native interp kernels emit
    rows in ascending order with no duplicates): indptr by bincount —
    skips scipy's duplicate-sum lexsort."""
    counts = np.bincount(pr, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    mat = sp.csr_matrix((pv, pc.astype(np.int32), indptr), shape=(n, nc))
    mat.sort_indices()
    return CSRMatrix.from_scipy(mat)


def _coarse_index(cf_marker: np.ndarray) -> np.ndarray:
    idx = np.full(len(cf_marker), -1, dtype=np.int64)
    cpts = np.nonzero(cf_marker == CGPT)[0]
    idx[cpts] = np.arange(len(cpts))
    return idx


def interp_direct(A: CSRMatrix, cf_marker: np.ndarray, S: sp.csr_matrix
                  ) -> CSRMatrix:
    """Direct interpolation (reference: interp_DIR, PreAMGInterp.c).

    For an F point i with strong coarse set C_i:
        alpha = (sum of negative off-diag a_ik) / (sum of negative a_ij, j in C_i)
        beta  = analogous ratio for positive entries
        P_ij  = -alpha * a_ij / a_ii   (a_ij < 0, j in C_i)
        P_ij  = -beta  * a_ij / a_ii   (a_ij > 0, j in C_i)
    Positive mass with no positive coarse entries folds into the diagonal.
    C points interpolate identically.

    Fully vectorized (no per-row Python): strong-set membership of each A
    entry is a sorted-key searchsorted; the per-row sums are bincounts.
    Setup-compiled analog of the reference's C row loop.
    """
    n = A.nrow
    cidx = _coarse_index(cf_marker)
    nc = int((cf_marker == CGPT).sum())
    from ... import native
    nat = native.interp_std(A, cf_marker, S, mode=2)
    if nat is not None:
        pr, pc, pv = nat
        return _csr_from_sorted_triplets(pr, pc, pv, n, nc)
    m = A.to_scipy().tocsr()
    Sr = S.tocsr()

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr))
    cols = m.indices.astype(np.int64)
    a = m.data.astype(np.float64)

    # membership of each A entry (i, j) in the strong graph S
    skey = np.sort(np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(Sr.indptr)) * n
                   + Sr.indices.astype(np.int64))
    akey = rows * n + cols
    pos_in_s = np.searchsorted(skey, akey)
    pos_in_s[pos_in_s >= len(skey)] = max(len(skey) - 1, 0)
    in_strong = (len(skey) > 0) & (skey[pos_in_s] == akey)

    diag_mask = cols == rows
    is_F = cf_marker[rows] == FGPT
    offd = ~diag_mask
    neg = offd & (a < 0)
    pos = offd & (a > 0)
    in_C = in_strong & (cf_marker[cols] == CGPT)
    negC = in_C & neg & is_F
    posC = in_C & pos & is_F

    aii = np.bincount(rows[diag_mask], a[diag_mask], minlength=n)
    aii = np.where(aii != 0.0, aii, 1.0)
    sum_neg = np.bincount(rows[neg], a[neg], minlength=n)
    sum_pos = np.bincount(rows[pos], a[pos], minlength=n)
    sum_negC = np.bincount(rows[negC], a[negC], minlength=n)
    sum_posC = np.bincount(rows[posC], a[posC], minlength=n)

    alpha = np.where(sum_negC != 0.0, sum_neg / np.where(sum_negC != 0.0,
                                                         sum_negC, 1.0), 0.0)
    has_posC = sum_posC != 0.0
    beta = np.where(has_posC, sum_pos / np.where(has_posC, sum_posC, 1.0),
                    0.0)
    aii = aii + np.where(has_posC, 0.0, sum_pos)   # fold positive mass

    keep = negC | posC
    coef = np.where(a < 0, alpha[rows], beta[rows])
    out_rows = rows[keep]
    out_cols = cidx[cols[keep]]
    out_vals = (-coef[keep] * a[keep] / aii[out_rows])

    cpts = np.nonzero(cf_marker == CGPT)[0]
    out_rows = np.concatenate([out_rows, cpts])
    out_cols = np.concatenate([out_cols, cidx[cpts]])
    out_vals = np.concatenate([out_vals, np.ones(len(cpts))])

    return CSRMatrix.from_coo(out_rows, out_cols, out_vals, (n, nc))


def interp_standard(A: CSRMatrix, cf_marker: np.ndarray, S: sp.csr_matrix
                    ) -> CSRMatrix:
    """Standard interpolation (reference: interp_STD, PreAMGInterp.c):
    strong F-F connections are eliminated by substituting the F neighbor's
    own equation, then the result is collapsed onto the coarse set.

    Compiled path: native fasp_interp_std (row loops in C++, the same cost
    model as the reference's compiled setup); the Python loop below is the
    toolchain-free twin."""
    n = A.nrow
    cidx = _coarse_index(cf_marker)
    nc = int((cf_marker == CGPT).sum())
    from ... import native
    nat = native.interp_std(A, cf_marker, S, mode=0)
    if nat is not None:
        pr, pc, pv = nat
        return _csr_from_sorted_triplets(pr, pc, pv, n, nc)
    m = A.to_scipy().tocsr()
    Sr = S.tocsr()

    rows, cols, vals = [], [], []
    for i in range(n):
        if cf_marker[i] == CGPT:
            rows.append(i)
            cols.append(cidx[i])
            vals.append(1.0)
            continue
        if cf_marker[i] == ISPT:
            continue

        strong = set(Sr.indices[Sr.indptr[i]:Sr.indptr[i + 1]])
        # accumulate an extended row: a_hat over {i} u N(i) u N(strong F)
        acc = {}
        s, e = m.indptr[i], m.indptr[i + 1]
        for k in range(s, e):
            acc[m.indices[k]] = acc.get(m.indices[k], 0.0) + m.data[k]

        for j in list(acc.keys()):
            if j == i or cf_marker[j] != FGPT or j not in strong:
                continue
            aij = acc.pop(j)
            # distribute a_ij via j's row, weighted by j's negative entries
            sj, ej = m.indptr[j], m.indptr[j + 1]
            jidx = m.indices[sj:ej]
            ja = m.data[sj:ej]
            jd = ja[jidx == j].sum() if (jidx == j).any() else 1.0
            neg = (jidx != j) & (ja < 0)
            denom = ja[neg].sum()
            if denom == 0.0:
                acc[i] = acc.get(i, 0.0) + aij    # no path: to diagonal
                continue
            w = aij / denom
            for k in np.nonzero(neg)[0]:
                acc[jidx[k]] = acc.get(jidx[k], 0.0) + w * ja[k]

        aii = acc.pop(i, 1.0)
        negsum = sum(v for j, v in acc.items() if v < 0)
        possum = sum(v for j, v in acc.items() if v > 0)
        negC = {j: v for j, v in acc.items()
                if v < 0 and cf_marker[j] == CGPT}
        posC = {j: v for j, v in acc.items()
                if v > 0 and cf_marker[j] == CGPT}
        alpha = (negsum / sum(negC.values())) if negC else 0.0
        if posC:
            beta = possum / sum(posC.values())
        else:
            beta = 0.0
            aii += possum
        for j, v in negC.items():
            rows.append(i)
            cols.append(cidx[j])
            vals.append(-alpha * v / aii)
        for j, v in posC.items():
            rows.append(i)
            cols.append(cidx[j])
            vals.append(-beta * v / aii)

    return CSRMatrix.from_coo(np.array(rows, dtype=np.int64),
                              np.array(cols, dtype=np.int64),
                              np.array(vals), (n, nc))


def interp_extended(A: CSRMatrix, cf_marker: np.ndarray, S: sp.csr_matrix
                    ) -> CSRMatrix:
    """Extended+i interpolation (reference: interp_EXT, PreAMGInterp.c —
    De Sterck/Yang ext+i): a strong F-F connection a_ij is distributed
    only over j's coarse neighbors *and the point i itself*, not over all
    of j's negative neighbors (which is the standard scheme's rule).  This
    keeps the interpolatory set to distance-2 C points and is the robust
    choice with aggressive coarsening.

    Compiled path: native fasp_interp_std with ext_mode=1; Python twin
    below."""
    n = A.nrow
    cidx = _coarse_index(cf_marker)
    nc = int((cf_marker == CGPT).sum())
    from ... import native
    nat = native.interp_std(A, cf_marker, S, mode=1)
    if nat is not None:
        pr, pc, pv = nat
        return _csr_from_sorted_triplets(pr, pc, pv, n, nc)
    m = A.to_scipy().tocsr()
    Sr = S.tocsr()

    rows, cols, vals = [], [], []
    for i in range(n):
        if cf_marker[i] == CGPT:
            rows.append(i)
            cols.append(cidx[i])
            vals.append(1.0)
            continue
        if cf_marker[i] == ISPT:
            continue

        strong = set(Sr.indices[Sr.indptr[i]:Sr.indptr[i + 1]])
        acc = {}
        s, e = m.indptr[i], m.indptr[i + 1]
        for k in range(s, e):
            acc[m.indices[k]] = acc.get(m.indices[k], 0.0) + m.data[k]

        for j in list(acc.keys()):
            if j == i or cf_marker[j] != FGPT or j not in strong:
                continue
            aij = acc.pop(j)
            sj, ej = m.indptr[j], m.indptr[j + 1]
            jidx = m.indices[sj:ej]
            ja = m.data[sj:ej]
            # ext+i rule: distribute over j's C neighbors and over i
            keep = (ja < 0) & ((cf_marker[jidx] == CGPT) | (jidx == i))
            denom = ja[keep].sum()
            if denom == 0.0:
                acc[i] = acc.get(i, 0.0) + aij
                continue
            w = aij / denom
            for k in np.nonzero(keep)[0]:
                acc[jidx[k]] = acc.get(jidx[k], 0.0) + w * ja[k]

        aii = acc.pop(i, 1.0)
        negsum = sum(v for j, v in acc.items() if v < 0)
        possum = sum(v for j, v in acc.items() if v > 0)
        negC = {j: v for j, v in acc.items()
                if v < 0 and cf_marker[j] == CGPT}
        posC = {j: v for j, v in acc.items()
                if v > 0 and cf_marker[j] == CGPT}
        alpha = (negsum / sum(negC.values())) if negC else 0.0
        if posC:
            beta = possum / sum(posC.values())
        else:
            beta = 0.0
            aii += possum
        for j, v in negC.items():
            rows.append(i)
            cols.append(cidx[j])
            vals.append(-alpha * v / aii)
        for j, v in posC.items():
            rows.append(i)
            cols.append(cidx[j])
            vals.append(-beta * v / aii)

    return CSRMatrix.from_coo(np.array(rows, dtype=np.int64),
                              np.array(cols, dtype=np.int64),
                              np.array(vals), (n, nc))


def truncate(P: CSRMatrix, eps: float) -> CSRMatrix:
    """Drop small P entries and rescale rows to preserve row sums
    (reference: amg_interp_trunc, PreAMGInterp.c).  Vectorized: per-row
    max/sum via segment reductions, one boolean compaction."""
    if eps <= 0:
        return P
    m = P.to_scipy().tocsr()
    n = P.nrow
    counts = np.diff(m.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    absd = np.abs(m.data)
    # per-row max / sums via segment reduceat on the row-sorted layout
    starts = np.minimum(m.indptr[:-1].astype(np.int64), max(m.nnz - 1, 0))
    nonempty = counts > 0
    rmax = np.zeros(n)
    tot = np.zeros(n)
    if m.nnz:
        rmax[nonempty] = np.maximum.reduceat(absd, starts)[nonempty]
        tot[nonempty] = np.add.reduceat(m.data, starts)[nonempty]
    keep = absd >= eps * rmax[rows]
    ks = np.zeros(n)
    if m.nnz:
        kept = np.where(keep, m.data, 0.0)
        ks[nonempty] = np.add.reduceat(kept, starts)[nonempty]
    scale = np.where(ks != 0.0, tot / np.where(ks != 0.0, ks, 1.0), 1.0)
    new_counts = np.zeros(n, dtype=np.int64)
    if m.nnz:
        kc = np.where(keep, 1, 0)
        new_counts[nonempty] = np.add.reduceat(kc, starts)[nonempty]
    indptr = np.concatenate([[0], np.cumsum(new_counts)])
    out = sp.csr_matrix((m.data[keep] * scale[rows[keep]],
                         m.indices[keep], indptr), shape=P.shape)
    return CSRMatrix.from_scipy(out)
