"""Block (BSR) smoothers: block Jacobi and color-batched block
Gauss-Seidel (port of ``faspsolver_tpu/precond/amg/bsr_smoothers.py``).

Reference: base/src/ItrSmootherBSR.c (fasp_smoother_dbsr_jacobi,
gs_ascend / descend over the precomputed block inverses of
fasp_dbsr_getdiaginv, BlaSparseBSR.c).

Each color's block rows are gathered at setup; a sweep is one gather, one
batched (nb, k*nb) x (k*nb,) product and one batched (nb, nb) x (nb,)
product per color: the block form of the multicolor Gauss-Seidel of
``smoothers.py``.  The color blocks are filled with array operations over
all stored blocks at once (no Python loop over blocks).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ... import as_tensor, np_dtype
from ...constants import SmootherType
from ...formats import BSRMatrix
from ...ops.operators import (_buf, block_diag_apply, block_ell_apply,
                              block_ell_layout)


class BsrColorBlock(nn.Module):
    """One color's block rows, diagonal blocks excluded: ``rows`` (nc,)
    block-row ids, ``cols`` (nc, k) block-column ids, ``vals``
    (nc, k, nb, nb) and ``dinv`` (nc, nb, nb) the inverse diagonal blocks
    of those rows.  The off-diagonal blocks are kept in
    ``block_ell_layout``; ``vals`` is a view."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, rows, cols, vals, dinv):
        super().__init__()
        self.register_buffer("rows", _buf(rows).to(torch.int64))
        self.register_buffer("cols", _buf(cols))
        self.register_buffer("blocks", block_ell_layout(vals))
        self.register_buffer("dinv", _buf(dinv))

    @property
    def vals(self) -> torch.Tensor:
        return self.blocks.permute(0, 2, 1, 3)


class BsrSmootherData(nn.Module):
    """What one block level's sweeps need; ``kind`` selects the sweep."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, kind: int, relax: float, nb: int, dinv=None,
                 colors: Sequence[BsrColorBlock] = ()):
        super().__init__()
        self.kind = int(kind)
        self.relax = float(relax)
        self.nb = int(nb)
        self.register_buffer("dinv", None if dinv is None else _buf(dinv))
        self.colors = nn.ModuleList(colors)


def _color_block_arrays(A: BSRMatrix, rows: np.ndarray, npdt):
    """(cols (nc, k), vals (nc, k, nb, nb)) of the off-diagonal blocks of
    the block rows ``rows``, in stored order; k is the longest stored row
    (its diagonal block counted), at least 1."""
    nb = A.nb
    nnz_per = (A.indptr[rows + 1] - A.indptr[rows]).astype(np.int64)
    k = max(int(nnz_per.max()) if len(rows) else 0, 1)
    cols = np.zeros((len(rows), k), dtype=np.int32)
    vals = np.zeros((len(rows), k, nb, nb), dtype=npdt)
    total = int(nnz_per.sum())
    if total:
        first = np.cumsum(nnz_per) - nnz_per          # first entry per row
        ri = np.repeat(np.arange(len(rows)), nnz_per)
        ent = np.arange(total) - first[ri] + A.indptr[rows][ri]
        j = A.indices[ent]
        off = j != rows[ri]
        before = np.cumsum(off) - off                 # off-diagonals so far
        row_base = before[np.minimum(first, total - 1)]
        slot = before - row_base[ri]
        cols[ri[off], slot[off]] = j[off]
        vals[ri[off], slot[off]] = A.data[ent[off]]
    return cols, vals


def build_bsr_smoother(A: BSRMatrix, kind: int, *, relax: float = 1.0,
                       dtype=None) -> BsrSmootherData:
    """Smoother data for a BSR level (host setup): block Jacobi for the
    Jacobi kinds, multicolor block Gauss-Seidel on the block graph
    otherwise."""
    npdt = np_dtype(dtype)
    nb = A.nb
    dinv = A.diag_inv().astype(npdt)
    kind = int(kind)

    if kind in (SmootherType.JACOBI, SmootherType.JACOBIF,
                SmootherType.L1DIAG):
        return BsrSmootherData(int(SmootherType.JACOBI), relax, nb,
                               dinv=as_tensor(dinv))

    colors, counts = A.condense(norm_type=1).multicolor()
    blocks = []
    for c in range(len(counts)):
        rows = np.nonzero(colors == c)[0]
        cols, vals = _color_block_arrays(A, rows, npdt)
        blocks.append(BsrColorBlock(as_tensor(rows.astype(np.int32)),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(vals),
                                    as_tensor(dinv[rows])))
    return BsrSmootherData(kind, relax, nb, dinv=as_tensor(dinv),
                           colors=blocks)


def bsr_color_sweep(sm: BsrSmootherData, x, b, order):
    """One multicolor block GS / SOR sweep; ``order`` = color visit
    order.  Each color writes its block rows into a new tensor
    (``index_copy`` out of place), never into the caller's x."""
    xb = x.reshape(-1, sm.nb)
    bb = b.reshape(-1, sm.nb)
    for ci in order:
        blk = sm.colors[ci]
        rhs = bb.index_select(0, blk.rows) - block_ell_apply(
            blk.blocks, blk.cols, xb)
        xn = block_diag_apply(blk.dinv, rhs)
        if sm.relax != 1.0:
            xr = xb.index_select(0, blk.rows)
            xn = xr + sm.relax * (xn - xr)
        xb = xb.index_copy(0, blk.rows, xn)
    return xb.reshape(-1)


def bsr_smooth(sm: BsrSmootherData, A, x, b, nsweeps: int, forward: bool):
    """``nsweeps`` block sweeps; ``forward`` orders the colors so pre-
    and post-smoothing are adjoint."""
    kind = sm.kind
    nc = len(sm.colors)
    for _ in range(nsweeps):
        if kind == SmootherType.JACOBI:
            r = (b - A(x)).reshape(-1, sm.nb)
            x = x + sm.relax * block_diag_apply(sm.dinv, r).reshape(-1)
        elif kind in (int(SmootherType.GS), int(SmootherType.SOR)):
            x = bsr_color_sweep(sm, x, b, range(nc) if forward
                                else range(nc - 1, -1, -1))
        elif kind in (int(SmootherType.SGS), int(SmootherType.SSOR)):
            x = bsr_color_sweep(sm, x, b, range(nc))
            x = bsr_color_sweep(sm, x, b, range(nc - 1, -1, -1))
        else:
            raise ValueError(f"unsupported BSR smoother {kind}")
    return x
