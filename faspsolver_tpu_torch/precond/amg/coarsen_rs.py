"""Classical AMG coarsening: strength of connection + C/F splitting
(port of ``faspsolver_tpu/precond/amg/coarsen_rs.py``; host NumPy/SciPy
and the shared native C++ entries, the same code as the JAX package's).

Reference: base/src/PreAMGCoarsenRS.c:76 (fasp_amg_coarsening_rs) —
strong_couplings (theta-threshold strength graph), cfsplitting_cls
(two-pass Ruge-Stuben with a lambda bucket), cfsplitting_mis.

Two splitting algorithms:
- ``rs``: faithful sequential two-pass Ruge-Stuben (host loop) — matches
  the reference's convergence behavior; setup cost is host-bound like the
  reference's serial C setup.
- ``pmis``: Luby-round parallel maximal-independent-set splitting —
  fully vectorized numpy, the right choice for very large systems where
  Python-loop RS would dominate setup time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ...constants import CGPT, FGPT, ISPT
from ...formats import CSRMatrix


def strong_couplings(A: CSRMatrix, theta: float,
                     max_row_sum: float = 0.9) -> sp.csr_matrix:
    """Strength matrix S: S[i,j]=1 iff j strongly influences i:
    -a_ij > theta * max_k|a_ik| over off-diagonals
    (reference: strong_couplings, PreAMGCoarsenRS.c:324-384 — the row
    scale is the largest ABSOLUTE off-diagonal, so on matrices whose
    large couplings are positive (steam2-class) the negative couplings
    all fall below the cut and the row has no strong connections; only
    negative entries can be strong, matching the n-couplings branch).

    Rows whose off-diagonal mass is negligible relative to the diagonal
    (max_row_sum criterion: sum|a_ij| < (2-mrs)|a_ii|) get no strong
    couplings (isolated).
    """
    from ... import native
    n = A.nrow
    nat = native.strength_graph(A, theta, max_row_sum)
    if nat is not None:
        s_indptr, s_indices = nat
        return sp.csr_matrix((np.ones(len(s_indices)), s_indices, s_indptr),
                             shape=A.shape)
    m = A.to_scipy().tocsr()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr))
    off = m.indices != rows
    neg = np.where(off, -m.data, 0.0)         # -a_ij for off-diagonals

    # per-row max of |a_ij| / abs off-diagonal sums via segment reduceat
    # (row-sorted CSR layout — no scattered .at updates)
    starts = m.indptr[:-1].astype(np.int64)
    nonempty = starts < m.indptr[1:]
    row_max = np.zeros(n)
    offsum = np.zeros(n)
    if m.nnz:
        absoff = np.where(off, np.abs(m.data), 0.0)
        rm = np.maximum.reduceat(absoff, np.minimum(starts, m.nnz - 1))
        os_ = np.add.reduceat(absoff, np.minimum(starts, m.nnz - 1))
        row_max[nonempty] = rm[nonempty]
        offsum[nonempty] = os_[nonempty]

    # rows dominated by their diagonal: drop all couplings
    d = np.abs(A.diagonal())
    # strict < for exact reference parity (row_sum < (2-mrs)|a_ii|,
    # PreAMGCoarsenRS.c strong_couplings; ADVICE r4)
    isolated = offsum < (1.0 - max_row_sum) * d

    keep = off & (neg > theta * np.maximum(row_max[rows], 1e-300)) \
        & (neg > 0) & (~isolated[rows])
    nk = np.count_nonzero(keep)
    counts = np.bincount(rows[keep], minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    S = sp.csr_matrix((np.ones(nk), m.indices[keep], indptr), shape=A.shape)
    return S


def _c1_filter(S: sp.csr_matrix) -> Tuple[sp.csr_matrix, np.ndarray]:
    """RS_C1 criterion (fasp.h:64, ON by default): a point whose strength
    ROW is empty cannot be interpolated, so it is removed from the
    splitting entirely — marked ISPT, and its in-edges dropped so no
    splitting method selects it as a C point (the reference's splitting
    skips ISPT neighbors, cfsplitting_cls, PreAMGCoarsenRS.c:577-633).
    Returns (filtered S, empty-row mask)."""
    empty = np.diff(S.indptr) == 0
    if not empty.any():
        return S, empty
    n = S.shape[0]
    keep = ~empty[S.indices]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))[keep]
    counts = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    S2 = sp.csr_matrix((np.ones(int(keep.sum())), S.indices[keep], indptr),
                       shape=S.shape)
    return S2, empty


def cf_split_rs(A: CSRMatrix, S: sp.csr_matrix) -> np.ndarray:
    """Classic two-pass Ruge-Stuben C/F splitting
    (reference: cfsplitting_cls, PreAMGCoarsenRS.c, bucket lists in
    PreAMGUtil.inl:20-296).  Returns vertex marker array
    (CGPT=1 / FGPT=0 / ISPT=2)."""
    n = A.nrow
    from ... import native
    nat = native.rs_cf_split2(S.indptr, S.indices, n)
    if nat is not None:
        # native first pass (heap worklist) + native F-F second pass —
        # the compiled twin of the Python loops below (same 1=C/0=F
        # contract; isolated points detected here)
        marker = nat.astype(np.int64)
        deg_out = np.diff(S.indptr)
        deg_in = np.bincount(S.indices, minlength=n)
        marker[(deg_out == 0) & (deg_in == 0)] = ISPT
        out = native.rs_ff_pass(S, marker)
        if out is not None:
            return out.astype(np.int64)
        marker[marker == ISPT] = -1        # fall through to Python pass 2

    ST = S.T.tocsr()                       # points influenced by i
    lam = np.diff(ST.indptr).astype(np.int64).copy()   # |S^T_i|
    marker = np.full(n, -1, dtype=np.int64)

    # isolated points: no in- or out-influence
    deg_out = np.diff(S.indptr)
    iso = (lam == 0) & (deg_out == 0)
    marker[iso] = ISPT

    # simple bucket priority structure
    import heapq
    heap = [(-lam[i], i) for i in range(n) if marker[i] == -1]
    heapq.heapify(heap)
    sp_indptr, sp_indices = S.indptr, S.indices
    st_indptr, st_indices = ST.indptr, ST.indices

    while heap:
        negl, i = heapq.heappop(heap)
        if marker[i] != -1 or -negl != lam[i]:
            continue                        # stale entry
        marker[i] = CGPT
        # points strongly influenced by i become F
        for j in st_indices[st_indptr[i]:st_indptr[i + 1]]:
            if marker[j] == -1:
                marker[j] = FGPT
                # their strong influences gain priority
                for k in sp_indices[sp_indptr[j]:sp_indptr[j + 1]]:
                    if marker[k] == -1:
                        lam[k] += 1
                        heapq.heappush(heap, (-lam[k], k))

    # second pass: every F-F strong pair must share a C point
    # (reference: cfsplitting_cls pass 2 / clean_ff_couplings)
    S_csr = S.tocsr()
    for i in range(n):
        if marker[i] != FGPT:
            continue
        Ci = set(j for j in sp_indices[sp_indptr[i]:sp_indptr[i + 1]]
                 if marker[j] == CGPT)
        for j in sp_indices[sp_indptr[i]:sp_indptr[i + 1]]:
            if marker[j] != FGPT:
                continue
            Cj = set(k for k in sp_indices[sp_indptr[j]:sp_indptr[j + 1]]
                     if marker[k] == CGPT)
            if not (Ci & Cj):
                marker[i] = CGPT            # promote i
                break

    marker[marker == -1] = FGPT
    return marker


def cf_split_pmis(A: CSRMatrix, S: sp.csr_matrix,
                  seed: int = 0) -> np.ndarray:
    """PMIS splitting: Luby-style random-priority maximal independent set
    on the strength graph — fully vectorized (the parallel counterpart of
    the reference's cfsplitting_mis)."""
    n = A.nrow
    G = ((S + S.T) > 0).astype(np.float64).tocsr()  # symmetrized influence
    deg = np.diff(G.indptr)
    rng = np.random.default_rng(seed)
    # weight = influence count + random tiebreak
    w = np.diff(S.T.tocsr().indptr) + rng.random(n)
    marker = np.full(n, -1, dtype=np.int64)
    marker[(deg == 0)] = ISPT

    active = marker == -1
    while np.any(active):
        wa = np.where(active, w, -np.inf)
        # node is a local max among active neighbors -> C point
        nbr_max = np.full(n, -np.inf)
        coo = G.tocoo()
        valid = active[coo.row] & active[coo.col]
        np.maximum.at(nbr_max, coo.row[valid], wa[coo.col[valid]])
        is_c = active & (wa > nbr_max)
        marker[is_c] = CGPT
        # neighbors of new C points become F
        newly_f = np.zeros(n, dtype=bool)
        cm = is_c[coo.col] & active[coo.row]
        newly_f[coo.row[cm]] = True
        newly_f &= marker == -1
        marker[newly_f] = FGPT
        active = marker == -1
        if not np.any(is_c) and np.any(active):
            marker[active] = CGPT           # safety: avoid stall
            break
    return marker


def cf_split_cr(A: CSRMatrix, S: sp.csr_matrix, nu: int = 4,
                target_rate: float = 0.7, max_passes: int = 6) -> np.ndarray:
    """Compatible-relaxation C/F splitting (reference:
    fasp_amg_coarsening_cr, PreAMGCoarsenCR.c; habituated F-point GS via
    fasp_smoother_dcsr_gscr).

    Run ``nu`` sweeps of F-point-restricted Gauss-Seidel on A e = 0 from a
    random iterate; where the error decays slowly, relaxation cannot handle
    the mode and the worst points are promoted to C.  Repeat until the CR
    rate clears ``target_rate``.
    """
    n = A.nrow
    m = A.to_scipy().tocsr()
    indptr, indices, data = m.indptr, m.indices, m.data
    d = A.diagonal()
    d = np.where(d != 0.0, d, 1.0)
    rng = np.random.default_rng(42)

    marker = np.full(n, FGPT, dtype=np.int64)

    def fgs_sweeps(e, sweeps):
        """F-point GS on A e = 0 (the gscr smoother), C values pinned 0.
        Native kernel when available; Python twin otherwise."""
        from ... import native
        out = native.fgs_sweeps(A, marker, e, sweeps)
        if out is not None:
            return out
        for _ in range(sweeps):
            for i in range(n):
                if marker[i] != FGPT:
                    continue
                s, t = indptr[i], indptr[i + 1]
                acc = 0.0
                for p in range(s, t):
                    j = indices[p]
                    if j != i:
                        acc += data[p] * e[j]
                e[i] = -acc / d[i]
        return e

    for _ in range(max_passes):
        e = rng.standard_normal(n)
        e[marker != FGPT] = 0.0
        e = fgs_sweeps(e, 1)
        norm0 = np.linalg.norm(e[marker == FGPT]) or 1.0
        e = fgs_sweeps(e, nu)
        norm1 = np.linalg.norm(e[marker == FGPT])
        rate = (norm1 / norm0) ** (1.0 / nu)
        if rate <= target_rate or (marker == FGPT).sum() == 0:
            break
        # promote slowest-decaying F points (largest |e|) to C, keeping
        # candidates independent in the strength graph
        fmask = marker == FGPT
        cand = np.nonzero(fmask)[0]
        score = np.abs(e[cand])
        thresh = np.quantile(score, 0.75) if len(score) else 0.0
        chosen = cand[score >= thresh]
        order = chosen[np.argsort(-np.abs(e[chosen]))]
        taken = np.zeros(n, dtype=bool)
        for i in order:
            if taken[i]:
                continue
            marker[i] = CGPT
            nbrs = S.indices[S.indptr[i]:S.indptr[i + 1]]
            taken[nbrs] = True
    if (marker == CGPT).sum() == 0:            # degenerate: fall back
        return cf_split_rs(A, S)
    return marker


def cf_split_aggressive(A: CSRMatrix, S: sp.csr_matrix,
                        path: int = 2) -> np.ndarray:
    """Aggressive coarsening (reference: cfsplitting_agg,
    PreAMGCoarsenRS.c): a standard RS pass first, then a second RS pass on
    the C-point subgraph using distance-``path`` strong connections, so
    only C points that are strongly path-connected stay coarse."""
    marker = cf_split_rs(A, S)
    cpts = np.nonzero(marker == CGPT)[0]
    if len(cpts) < 4:
        return marker
    # Sh: strength among temporary C points.  Native path is
    # reference-exact (strong_couplings_agg1/agg2, PreAMGCoarsenRS.c):
    # C-C direct S edge, or >= `path` DISTINCT 2-hop paths through F
    # points — an O(sum of 2-hop neighborhoods) stamp walk, no SpGEMM.
    from ... import native
    cf32 = np.where(marker == CGPT, 1,
                    np.where(marker == ISPT, 2, 0)).astype(np.int32)
    nat = native.agg_strength(S.indptr, S.indices, A.nrow, cf32,
                              int(path), len(cpts))
    if nat is not None:
        shp, shi = nat
        Sc = sp.csr_matrix((np.ones(len(shi), dtype=np.float64), shi,
                            shp), shape=(len(cpts), len(cpts)))
    else:
        # toolchain-free fallback: boolean path closure (length <=
        # path+1) — an approximation of the reference's distinct-path
        # count; slightly denser Sh, same coarsening character
        Sb = S.copy()
        Sb.data = np.ones_like(Sb.data)
        S2 = Sb
        for _ in range(path):
            S2 = (S2 @ Sb + S2).tocsr()
        Sc = S2[cpts][:, cpts].tocsr()
        Sc.setdiag(0)
        Sc.eliminate_zeros()
    # reuse the RS heuristic on the C-subgraph (the reference's phase-2
    # loop is the classical bucket-list split run on Sh).  cf_split_rs
    # reads only nrow from its matrix argument, so a shim avoids the
    # ~0.2 s scipy submatrix extraction at 1M dof.
    shim = type("_SubShim", (), {"nrow": len(cpts)})()
    sub = cf_split_rs(shim, Sc)
    out = marker.copy()
    out[cpts] = np.where(sub == CGPT, CGPT, FGPT)
    if (out == CGPT).sum() == 0:       # degenerate: keep the first pass
        return marker
    return out


def coarsen(A: CSRMatrix, theta: float = 0.25, max_row_sum: float = 0.9,
            method: str = "rs", aggressive_path: int = 2
            ) -> Tuple[np.ndarray, sp.csr_matrix]:
    """(cf_marker, strength matrix)."""
    S, empty = _c1_filter(strong_couplings(A, theta, max_row_sum))
    if method == "pmis":
        marker = cf_split_pmis(A, S)
    elif method == "cr":
        marker = cf_split_cr(A, S)
    elif method == "aggressive":
        marker = cf_split_aggressive(A, S, aggressive_path)
    else:
        marker = cf_split_rs(A, S)
    marker[empty] = ISPT
    return marker, S
