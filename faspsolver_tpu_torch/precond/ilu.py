"""Incomplete LU factorization preconditioners (port of
``faspsolver_tpu/precond/ilu.py``).

Reference: base/src/BlaILU.c (fasp_iluk :72, fasp_ilut :467, fasp_ilutp
:906: SPARSKIT-style row-wise IKJ factorization), BlaILUSetupCSR.c:40
(dispatch), PreCSR.c:198 (fasp_precond_ilu: z = U^-1 L^-1 r), and for BSR
fasp_ilu_dbsr_setup (BlaILUSetupBSR.c) with the appliers
fasp_precond_dbsr_ilu / _ilu_ls_omp (PreBSR.c:347, :844).

The factorization is host code of the setup phase (the native C++
entries, with NumPy / scipy fallbacks).  The apply is *level-scheduled*
substitution, the strategy of the reference's own parallel ILU appliers
(topologic_sort_ILU): rows grouped into dependency levels, each level one
gather, multiply, row sum, subtract, scale and ``index_copy_``.  A
solver is one loop over its levels.  All levels live in four flat
buffers (one upload), and each level reads its slices.

The loop launches half a dozen small kernels per level, and a factor of a
2-D grid has thousands of levels, so on a CUDA device the apply is bound
by the rate at which the host can launch them.  There each
preconditioner captures one apply (every level, static index tensors, no
host read) in a CUDA graph at its first call and replays it afterwards
(``utils.graphs.GraphedModule``): the results are those of the eager
loop (``eager``), which CPU tensors always take.  A capture that fails
raises.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from torch import nn

from .. import as_tensor, np_dtype
from ..constants import ERROR_SOLVER_ILUSETUP, ILUType
from ..formats import CSRMatrix
from ..ops.operators import (_buf, block_diag_apply, block_ell_apply,
                             block_ell_layout)
from ..utils.errors import FaspError
from ..utils.graphs import GraphedModule
from ..utils.params import ILUParam


# ---------------------------------------------------------------------------
# factorization (host, setup phase): fallbacks for a missing native library
# ---------------------------------------------------------------------------

def iluk_factor(A: CSRMatrix, lfil: int = 0
                ) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """ILU(k): level-of-fill incomplete factorization (reference:
    fasp_symbfactor + fasp_iluk, BlaILU.c:72).

    Two passes: a symbolic level-of-fill pass fixes the pattern, then a
    numeric IKJ pass fills it.  Explicit zeros in the input count as
    pattern entries (level 0), as in the reference's pattern-driven
    symbolic factorization.  Returns (L, U), L unit-diagonal."""
    n = A.nrow
    m = A.to_scipy().tocsr().copy()
    m.sort_indices()

    upper_patterns: List[dict] = []    # levels of U-part rows (j >= i)
    full_patterns: List[set] = []      # complete row patterns
    for i in range(n):
        lev = {int(c): 0 for c in m.indices[m.indptr[i]:m.indptr[i + 1]]}
        lev[i] = 0
        work = sorted(c for c in lev if c < i)
        w = 0
        while w < len(work):
            k = work[w]
            w += 1
            lev_ik = lev[k]
            for j, lev_kj in upper_patterns[k].items():
                if j <= k:
                    continue
                l_new = lev_ik + lev_kj + 1
                if j in lev:
                    if l_new < lev[j]:
                        lev[j] = l_new
                elif l_new <= lfil:
                    lev[j] = l_new
                    if j < i:
                        # a new dependency is eliminated in order
                        bisect.insort(work, j)
        upper_patterns.append({j: lv for j, lv in lev.items() if j >= i})
        full_patterns.append(set(lev))

    Urows: List[dict] = []
    Lrows: List[dict] = []
    for i in range(n):
        row = {j: 0.0 for j in full_patterns[i]}
        for idx in range(m.indptr[i], m.indptr[i + 1]):
            row[int(m.indices[idx])] = m.data[idx]
        for k in sorted(c for c in row if c < i):
            uk = Urows[k]
            ukk = uk.get(k, 0.0)
            if ukk == 0.0:
                continue
            lik = row[k] / ukk
            row[k] = lik
            for j, ukj in uk.items():
                if j > k and j in row:
                    row[j] -= lik * ukj
        Urows.append({j: v for j, v in row.items() if j >= i})
        Lrows.append({j: v for j, v in row.items() if j < i})

    def build(rows_list, extra_diag):
        indptr = [0]
        indices = []
        data = []
        for i, row in enumerate(rows_list):
            items = sorted(row.items())
            if extra_diag:
                items.append((i, 1.0))
                items.sort()
            indices.extend(j for j, _ in items)
            data.extend(v for _, v in items)
            indptr.append(len(indices))
        return sp.csr_matrix((np.array(data), np.array(indices),
                              np.array(indptr)), shape=(n, n))

    return build(Lrows, True), build(Urows, False)


def ilut_factor(A: CSRMatrix, droptol: float = 1e-3, lfil: int = None
                ) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """ILUt: threshold-based incomplete factorization (reference:
    fasp_ilut, BlaILU.c:467) through SuperLU's ILUTP in scipy, with the
    column permutation disabled."""
    n = A.nrow
    fill = 10.0 if lfil is None else max(float(lfil), 1.0)
    ilu = spla.spilu(A.to_scipy().tocsc(), drop_tol=droptol,
                     fill_factor=fill, permc_spec="NATURAL",
                     diag_pivot_thresh=0.0)
    # NATURAL + diag_pivot_thresh=0 keeps the permutations identity,
    # except when a zero diagonal forces SuperLU to row-pivot.  Dropping
    # such a permutation would corrupt the preconditioner: check, and let
    # the caller take the pivoted path.
    if not (np.array_equal(ilu.perm_r, np.arange(n))
            and np.array_equal(ilu.perm_c, np.arange(n))):
        raise FaspError(ERROR_SOLVER_ILUSETUP,
                        "ILUt: SuperLU pivoted despite NATURAL ordering "
                        "(zero diagonal?): use ILUtp")
    return ilu.L.tocsr(), ilu.U.tocsr()


def ilutp_factor(A: CSRMatrix, droptol: float = 1e-3, permtol: float = 0.05
                 ) -> Tuple[sp.csr_matrix, sp.csr_matrix, tuple]:
    """ILUtp with partial pivoting (reference: fasp_ilutp, BlaILU.c:906)
    through scipy's SuperLU."""
    ilu = spla.spilu(A.to_scipy().tocsc(), drop_tol=droptol,
                     fill_factor=10.0)
    return ilu.L.tocsr(), ilu.U.tocsr(), (ilu.perm_r, ilu.perm_c)


# ---------------------------------------------------------------------------
# level-scheduled triangular solve (device, solve phase)
# ---------------------------------------------------------------------------

def _level_depth(indptr, indices, n: int, lower: bool) -> np.ndarray:
    """Depth of every row in the triangular dependency DAG (reference:
    topologic_sort_ILU, BlaILUSetupBSR.c): the native entry, else a NumPy
    loop."""
    from .. import native
    out = native.level_schedule(indptr, indices, n, lower)
    if out is not None:
        return out[0].astype(np.int64)
    depth = np.zeros(n, dtype=np.int64)
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        j = indices[indptr[i]:indptr[i + 1]]
        deps = j[j < i] if lower else j[j > i]
        depth[i] = depth[deps].max() + 1 if len(deps) else 0
    return depth


class _LevelBuffers(nn.Module):
    """The flat buffers of a level-scheduled solver and the per-level
    views of them, rebuilt after the module moves."""

    def __init__(self):
        super().__init__()
        self._views = None

    def _apply(self, fn, *args, **kwargs):
        self._views = None
        return super()._apply(fn, *args, **kwargs)

    def levels(self):
        if self._views is None:
            self._views = self._make_views()
        return self._views


class TriangularSolver(_LevelBuffers):
    """Level-scheduled sparse triangular solve.  Level l holds
    ``sizes[l] = (m, k)``: m rows with at most k off-diagonal entries;
    ``rows`` (n,) lists the rows level by level, ``dinv`` (n,) their
    inverse diagonals, and ``cols`` / ``vals`` the (m, k) dependency
    blocks of all levels one after another, short rows padded with
    column 0 and value 0."""

    def __init__(self, rows, cols, vals, dinv, sizes, n: int):
        super().__init__()
        self.register_buffer("rows", _buf(rows).to(torch.int64))
        self.register_buffer("cols", _buf(cols))
        self.register_buffer("vals", _buf(vals))
        self.register_buffer("dinv", _buf(dinv))
        self.sizes = tuple((int(m), int(k)) for m, k in sizes)
        self.n = int(n)

    @property
    def num_levels(self) -> int:
        return len(self.sizes)

    def _make_views(self):
        views, ro, eo = [], 0, 0
        for m, k in self.sizes:
            views.append((slice(ro, ro + m), self.rows[ro:ro + m],
                          self.cols[eo:eo + m * k],
                          self.vals[eo:eo + m * k].view(m, k),
                          self.dinv[ro:ro + m]))
            ro += m
            eo += m * k
        return views

    def level_arrays(self):
        """(rows, cols (m, k), vals (m, k), dinv) of every level."""
        return [(rows, cols.view(vals.shape), vals, dinv)
                for _, rows, cols, vals, dinv in self.levels()]

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        x = torch.zeros_like(b)
        bs = b.index_select(0, self.rows)
        for sl, rows, cols, vals, dinv in self.levels():
            acc = (vals * x.index_select(0, cols).view(vals.shape)).sum(dim=1)
            x.index_copy_(0, rows, dinv * (bs[sl] - acc))
        return x

    @classmethod
    def from_sparse(cls, T: sp.csr_matrix, lower: bool, dtype=None
                    ) -> "TriangularSolver":
        npdt = np_dtype(dtype)
        T = T.tocsr()
        T.sort_indices()
        n = T.shape[0]
        d = T.diagonal()
        d = np.where(d != 0.0, d, 1.0)
        depth = _level_depth(T.indptr, T.indices, n, lower)
        order = np.argsort(depth, kind="stable")       # rows, level by level
        m_l = np.bincount(depth, minlength=1 if n else 0)

        # strict-triangle entries, in CSR order, and their slot in the row
        rr = np.repeat(np.arange(n), np.diff(T.indptr))
        keep = (T.indices < rr) if lower else (T.indices > rr)
        kr = rr[keep]
        counts = np.bincount(kr, minlength=n)
        slot = np.arange(len(kr)) - (np.cumsum(counts) - counts)[kr]

        k_l = np.maximum(np.maximum.reduceat(counts[order], np.cumsum(m_l)
                                             - m_l), 1) if n else m_l
        lvl_off = np.cumsum(m_l * k_l) - m_l * k_l     # level's first entry
        pos = np.empty(n, dtype=np.int64)              # row -> place in order
        pos[order] = np.arange(n)
        local = pos - (np.cumsum(m_l) - m_l)[depth]    # place within level
        row_off = lvl_off[depth] + local * k_l[depth]
        total = int((m_l * k_l).sum())
        cols = np.zeros(total, dtype=np.int32)
        vals = np.zeros(total, dtype=npdt)
        cols[row_off[kr] + slot] = T.indices[keep]
        vals[row_off[kr] + slot] = T.data[keep]
        return cls(torch.from_numpy(order), torch.from_numpy(cols),
                   torch.from_numpy(vals),
                   as_tensor((1.0 / d[order]).astype(npdt)),
                   zip(m_l, k_l), n)


class ILUPrecond(GraphedModule):
    """z = U^-1 L^-1 r by level-scheduled solves (reference:
    fasp_precond_ilu, PreCSR.c:198).

    For pivoted factorizations (ILUtp) the permutations apply around the
    solves: w = r[perm_in]; z = U^-1 L^-1 w; out = z[perm_out]."""

    def __init__(self, Lsolve: TriangularSolver, Usolve: TriangularSolver,
                 perm_in=None, perm_out=None):
        super().__init__()
        self.Lsolve = Lsolve
        self.Usolve = Usolve
        for name, p in (("perm_in", perm_in), ("perm_out", perm_out)):
            self.register_buffer(
                name, None if p is None else _buf(p).to(torch.int64))

    @property
    def num_levels(self) -> int:
        return self.Lsolve.num_levels + self.Usolve.num_levels

    def eager(self, r: torch.Tensor) -> torch.Tensor:
        if self.perm_in is not None:
            r = r.index_select(0, self.perm_in)
        z = self.Usolve(self.Lsolve(r))
        if self.perm_out is not None:
            z = z.index_select(0, self.perm_out)
        return z


# ---------------------------------------------------------------------------
# block ILU(0) for BSR
# ---------------------------------------------------------------------------

class BlockTriangularSolver(_LevelBuffers):
    """Level-scheduled BLOCK triangular solve (reference:
    fasp_precond_dbsr_ilu_ls_omp, PreBSR.c:844).  Level l holds
    ``sizes[l] = (m, k)`` block rows; ``rows`` (n,) lists them level by
    level, ``cols`` / ``blocks`` hold every level's (m, k) block-column
    ids (padding points at the zero scratch row n) and its dependency
    blocks in ``block_ell_layout``, one level after another, and
    ``dinv`` (n, nb, nb) the inverse diagonal blocks in that row order
    (None: unit diagonal, the L factor).  Each level is one batched
    (nb, k*nb) x (k*nb,) product and, for U, one batched (nb, nb) x
    (nb,) product."""

    def __init__(self, rows, cols, blocks, dinv, sizes, n: int, nb: int):
        super().__init__()
        self.register_buffer("rows", _buf(rows).to(torch.int64))
        self.register_buffer("cols", _buf(cols))
        self.register_buffer("blocks", _buf(blocks))
        self.register_buffer("dinv", None if dinv is None else _buf(dinv))
        self.sizes = tuple((int(m), int(k)) for m, k in sizes)
        self.n = int(n)
        self.nb = int(nb)

    @property
    def num_levels(self) -> int:
        return len(self.sizes)

    def _make_views(self):
        nb = self.nb
        views, ro, eo = [], 0, 0
        for m, k in self.sizes:
            views.append((
                slice(ro, ro + m), self.rows[ro:ro + m],
                self.cols[eo:eo + m * k].view(m, k),
                self.blocks[eo * nb * nb:(eo + m * k) * nb * nb].view(
                    m, nb, k, nb),
                None if self.dinv is None else self.dinv[ro:ro + m]))
            ro += m
            eo += m * k
        return views

    def level_arrays(self):
        """(rows, cols (m, k), vals (m, k, nb, nb), dinv) of every
        level."""
        return [(rows, cols, blocks.permute(0, 2, 1, 3), dinv)
                for _, rows, cols, blocks, dinv in self.levels()]

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        """b: (n, nb) block vector."""
        x = b.new_zeros(self.n + 1, self.nb)
        bs = b.index_select(0, self.rows)
        for sl, rows, cols, blocks, dinv in self.levels():
            rhs = bs[sl] - block_ell_apply(blocks, cols, x)
            x.index_copy_(0, rows, rhs if dinv is None
                          else block_diag_apply(dinv, rhs))
        return x[:self.n]


class BSRILUPrecond(GraphedModule):
    """z = U^-1 L^-1 r with true nb x nb block ILU(0) factors, no CSR
    expansion (reference: fasp_ilu_dbsr_setup + fasp_precond_dbsr_ilu,
    BlaILUSetupBSR.c, PreBSR.c:347)."""

    def __init__(self, Lsolve: BlockTriangularSolver,
                 Usolve: BlockTriangularSolver, nb: int):
        super().__init__()
        self.Lsolve = Lsolve
        self.Usolve = Usolve
        self.nb = int(nb)

    @property
    def num_levels(self) -> int:
        return self.Lsolve.num_levels + self.Usolve.num_levels

    def eager(self, r: torch.Tensor) -> torch.Tensor:
        return self.Usolve(self.Lsolve(r.reshape(-1, self.nb))).reshape(-1)


def _block_levels(n, indptr, indices, vals, dinv, lower, dtype
                  ) -> BlockTriangularSolver:
    """Pack one triangle of the factored BSR pattern into level batches."""
    nb = vals.shape[1]
    npdt = np_dtype(dtype)
    rows_all = np.repeat(np.arange(n), np.diff(indptr))
    tri = (indices < rows_all) if lower else (indices > rows_all)
    tri_counts = np.bincount(rows_all[tri], minlength=n)
    tri_indptr = np.concatenate([[0], np.cumsum(tri_counts)]).astype(np.int32)
    tri_indices = indices[tri].astype(np.int32)
    tri_vals = vals[tri]
    depth = _level_depth(tri_indptr, tri_indices, n, lower)
    nlev = int(depth.max()) + 1 if n else 0

    order, cols_l, blocks_l, sizes = [], [], [], []
    for lv in range(nlev):
        rows = np.nonzero(depth == lv)[0]
        counts = tri_counts[rows]
        m = len(rows)
        k = max(int(counts.max()) if m else 0, 1)
        cols = np.full((m, k), n, dtype=np.int32)
        blks = np.zeros((m, k, nb, nb), dtype=npdt)
        starts = tri_indptr[rows]
        for s in range(k):
            has = counts > s
            cols[has, s] = tri_indices[starts[has] + s]
            blks[has, s] = tri_vals[starts[has] + s]
        order.append(rows)
        cols_l.append(cols.reshape(-1))
        blocks_l.append(block_ell_layout(torch.from_numpy(blks)).reshape(-1))
        sizes.append((m, k))
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    return BlockTriangularSolver(
        torch.from_numpy(order),
        torch.from_numpy(np.concatenate(cols_l)) if cols_l
        else torch.zeros(0, dtype=torch.int32),
        torch.cat(blocks_l) if blocks_l else torch.zeros(0),
        None if lower else as_tensor(dinv[order].astype(npdt)),
        sizes, n, nb)


def setup_bsr_ilu0(A, dtype=None, device=None) -> BSRILUPrecond:
    """Block ILU(0) on the BSR pattern with a batched nb x nb apply
    (reference: fasp_ilu_dbsr_setup, BlaILUSetupBSR.c).  Raises FaspError
    when the factorization fails (a missing or singular diagonal block),
    so callers can take the CSR expansion instead."""
    from .. import native
    n = A.nrow_block
    nb = A.nb
    # canonical sorted block rows
    indptr = A.indptr.astype(np.int64)
    indices = A.indices.astype(np.int64)
    order = np.lexsort((indices, np.repeat(np.arange(n), np.diff(indptr))))
    indices = indices[order]
    data = A.data[order]

    out = native.bsr_ilu0(indptr, indices, data, n, nb)
    if out is None:
        out = _bsr_ilu0_py(n, nb, indptr, indices, data)
    if out is None:
        raise FaspError(ERROR_SOLVER_ILUSETUP, "block ILU(0) setup failed")
    fvals, dinv = out
    M = BSRILUPrecond(
        _block_levels(n, indptr, indices, fvals, dinv, True, dtype),
        _block_levels(n, indptr, indices, fvals, dinv, False, dtype), nb)
    return M if device is None else M.to(device)


def _bsr_ilu0_py(n, nb, indptr, indices, data):
    """NumPy twin of the native fasp_bsr_ilu0 (block IKJ in the pattern
    of A)."""
    vals = np.array(data, dtype=np.float64, copy=True)
    dinv = np.zeros((n, nb, nb))
    try:
        for i in range(n):
            s, e = int(indptr[i]), int(indptr[i + 1])
            pos = {int(indices[p]): p for p in range(s, e)}
            for p in range(s, e):
                k = int(indices[p])
                if k >= i:
                    break
                vals[p] = vals[p] @ dinv[k]
                for q in range(int(indptr[k]), int(indptr[k + 1])):
                    j = int(indices[q])
                    if j <= k or j not in pos:
                        continue
                    vals[pos[j]] -= vals[p] @ vals[q]
            if i not in pos:
                return None
            dinv[i] = np.linalg.inv(vals[pos[i]])
    except np.linalg.LinAlgError:
        return None
    return vals, dinv


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def _solvers(L, U, dtype):
    return (TriangularSolver.from_sparse(L, lower=True, dtype=dtype),
            TriangularSolver.from_sparse(U, lower=False, dtype=dtype))


def setup_ilu(A: CSRMatrix, param: Optional[ILUParam] = None, dtype=None,
              device=None) -> ILUPrecond:
    """Factor on the host and build the level-scheduled solvers
    (reference: fasp_ilu_dcsr_setup, BlaILUSetupCSR.c:40), moved to
    ``device`` if given."""
    from .. import native
    param = param or ILUParam()
    t = int(param.ILU_type)

    # ILUt / ILUtp row-fill budget: the reference ignores ILU_lfil for the
    # threshold variants and uses n/2+1, so droptol governs the fill
    # (BlaILUSetupCSR.c:68-72); an explicit positive lfil still bounds rows
    lfilt = param.ILU_lfil if param.ILU_lfil > 0 else A.nrow // 2 + 1

    def pivoted() -> ILUPrecond:
        # the native ILUtp first (reference: fasp_ilutp, BlaILU.c:906, a
        # row-wise ILUT with column pivoting): L U ~= A P, so the solve
        # ends with x = y[argsort(perm)].  SuperLU only as the last resort.
        out = native.ilutp(A, lfilt, param.ILU_droptol, param.ILU_permtol)
        if out is not None:
            L, U, perm = out
            return ILUPrecond(*_solvers(L, U, dtype),
                              perm_out=torch.from_numpy(np.argsort(perm)))
        L, U, (perm_r, perm_c) = ilutp_factor(A, param.ILU_droptol,
                                              param.ILU_permtol)
        return ILUPrecond(
            *_solvers(L, U, dtype),
            perm_in=torch.from_numpy(np.argsort(perm_r)),
            perm_out=torch.from_numpy(np.asarray(perm_c, dtype=np.int64)))

    def factor():
        if t == ILUType.ILUK:
            out = native.iluk(A, param.ILU_lfil)
            if out is not None:
                return out
            if A.nrow <= 20000:
                return iluk_factor(A, param.ILU_lfil)
            # no toolchain and too big for the Python ILU(k): ILUt
            return ilut_factor(A, param.ILU_droptol)
        out = native.ilut(A, lfilt, param.ILU_droptol)
        if out is not None:
            return out
        return ilut_factor(A, param.ILU_droptol,
                           None if param.ILU_lfil == 0 else param.ILU_lfil)

    if t == ILUType.ILUTP:
        M = pivoted()
    else:
        try:
            M = ILUPrecond(*_solvers(*factor(), dtype))
        except FaspError:              # a zero diagonal forced pivoting
            M = pivoted()
    return M if device is None else M.to(device)
