"""Overlapping Schwarz preconditioner (port of
``faspsolver_tpu/precond/schwarz.py``).

Reference: base/src/BlaSchwarzSetup.c:46 (fasp_swz_dcsr_setup): maximal-
independent-set roots -> BFS level sets to SWZ_maxlvl depth ->
overlapping blocks; per-block direct factorization; forward / backward
multiplicative sweeps (fasp_dcsr_swz_forward / backward), wrapped as a
preconditioner (fasp_precond_swz, PreCSR.c:371).

Blocks are padded to a common size and their inverses live as one
batched (nblk, m, m) array per color, so a color's block solves are one
batched product.  The reference's sequential multiplicative sweep
becomes color-batched: blocks are colored on their overlap graph; within
a color all solves run in one batch, colors run in sequence (forward) or
in reverse (backward), as in the multicolor Gauss-Seidel smoother.  The
setup is host Python over blocks, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .. import np_dtype
from ..constants import SchwarzType
from ..formats import CSRMatrix
from ..ops.operators import _buf, best_operator, block_diag_apply
from ..utils.graphs import capturable
from ..utils.params import SWZParam


def _mis_roots(adj: sp.csr_matrix) -> np.ndarray:
    """Greedy maximal independent set (reference: fasp_sparse_mis,
    BlaSparseUtil.c)."""
    n = adj.shape[0]
    state = np.zeros(n, dtype=np.int8)   # 0 undecided, 1 in MIS, -1 out
    indptr, indices = adj.indptr, adj.indices
    for i in range(n):
        if state[i] == 0:
            state[i] = 1
            nbr = indices[indptr[i]:indptr[i + 1]]
            state[nbr] = np.where(state[nbr] == 0, -1, state[nbr])
    return np.nonzero(state == 1)[0]


def _bfs_block(indptr, indices, root: int, maxlvl: int, maxsize: int
               ) -> np.ndarray:
    seen = {int(root)}
    frontier = [int(root)]
    for _ in range(maxlvl):
        nxt = []
        for u in frontier:
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
                    if len(seen) >= maxsize:
                        return np.array(sorted(seen))
        frontier = nxt
        if not frontier:
            break
    return np.array(sorted(seen))


class _ColorGroup(nn.Module):
    """One color's blocks: ``dofs`` (nblk, m) dof ids padded with the
    ghost index n, ``mask`` (nblk, m) 1.0 valid / 0.0 padding, ``inv``
    (nblk, m, m) block inverses (factored on the host)."""

    capturable = True       # buffers only (utils/graphs.py)

    def __init__(self, dofs, mask, inv):
        super().__init__()
        self.register_buffer("dofs", _buf(dofs).to(torch.int64))
        self.register_buffer("mask", _buf(mask))
        self.register_buffer("inv", _buf(inv))


class SchwarzPrecond(nn.Module):
    """Color-batched overlapping Schwarz (the SWZ_data of fasp.h:726-796).
    ``A`` is the operator of the residual updates.  The colors are
    walked by Python index and every shape is fixed at setup; the apply
    allocates (``torch.cat``, ``new_zeros``), which a capture takes into
    its pool, and reads nothing back to the host: it is capturable when
    ``A`` is."""

    @property
    def capturable(self) -> bool:
        return capturable(self.A)

    def __init__(self, groups: Sequence[_ColorGroup], A, n: int,
                 swz_type: int = int(SchwarzType.FORWARD)):
        super().__init__()
        self.groups = nn.ModuleList(groups)
        self.A = A
        self.n = int(n)
        self.swz_type = int(swz_type)

    def _sweep(self, x, r, order):
        n = self.n
        for gi in order:
            g = self.groups[gi]
            # the current residual on each block; the ghost index reads
            # the appended zero
            rp = torch.cat([r, r.new_zeros(1)])
            rloc = rp.index_select(0, g.dofs.reshape(-1)).view(g.dofs.shape)
            e = block_diag_apply(g.inv, rloc) * g.mask
            # a color's blocks share no dof, so the sum is exact in any
            # order; the ghost slot n takes the padding and is dropped
            dx = x.new_zeros(n + 1).index_add_(
                0, g.dofs.reshape(-1), e.reshape(-1))[:n]
            x = x + dx
            r = r - self.A(dx)
        return x, r

    def forward(self, r0: torch.Tensor) -> torch.Tensor:
        x = torch.zeros_like(r0)
        fwd = range(len(self.groups))
        bwd = range(len(self.groups) - 1, -1, -1)
        if self.swz_type == SchwarzType.BACKWARD:
            x, _ = self._sweep(x, r0, bwd)
        elif self.swz_type == SchwarzType.SYMMETRIC:
            x, r = self._sweep(x, r0, fwd)
            x, _ = self._sweep(x, r, bwd)
        else:
            x, _ = self._sweep(x, r0, fwd)
        return x


def schwarz_blocks(A: CSRMatrix, param: SWZParam):
    """(blocks, color per block): the overlapping dof blocks grown from
    the independent-set roots, singletons for dofs none of them reached,
    and a greedy coloring of their overlap graph (a shared dof is a
    conflict)."""
    n = A.nrow
    adj = A.to_scipy().tocsr().copy()
    adj.setdiag(0)
    adj.eliminate_zeros()
    blocks = [_bfs_block(adj.indptr, adj.indices, r, param.SWZ_maxlvl,
                         param.SWZ_mmsize) for r in _mis_roots(adj)]
    covered = np.zeros(n, dtype=bool)
    for blk in blocks:
        covered[blk] = True
    for i in np.nonzero(~covered)[0]:
        blocks.append(np.array([i]))

    owner: dict = {}
    conflicts = [set() for _ in blocks]
    for bi, blk in enumerate(blocks):
        for d in blk:
            if d in owner:
                for o in owner[d]:
                    conflicts[bi].add(o)
                    conflicts[o].add(bi)
                owner[d].append(bi)
            else:
                owner[d] = [bi]
    colors = np.full(len(blocks), -1, dtype=np.int64)
    for bi in range(len(blocks)):
        used = {colors[o] for o in conflicts[bi]}
        c = 0
        while c in used:
            c += 1
        colors[bi] = c
    return blocks, colors


def setup_schwarz(A: CSRMatrix, param: Optional[SWZParam] = None,
                  dtype=None, device=None) -> SchwarzPrecond:
    """Blocks, colors and per-block inverses on the host; the result is
    moved to ``device`` if given.  The residual operator is
    ``best_operator(A)``: a grid matrix applies through the stencil
    kernel."""
    param = param or SWZParam()
    npdt = np_dtype(dtype)
    n = A.nrow
    m = A.to_scipy().tocsr()
    blocks, colors = schwarz_blocks(A, param)

    msize = max(len(b) for b in blocks)
    sizes = np.array([len(b) for b in blocks])
    rows = np.repeat(np.arange(n), np.diff(m.indptr))
    groups: List[_ColorGroup] = []
    for c in range(int(colors.max()) + 1):
        idx = np.nonzero(colors == c)[0]
        nblk = len(idx)
        # a color's blocks share no dof: each dof has one block and one
        # place in it, so every block's submatrix is filled from one pass
        # over the entries of A whose row and column lie in one block
        member = np.concatenate([blocks[bi] for bi in idx])
        blk_of = np.repeat(np.arange(nblk), sizes[idx])
        place = np.arange(len(member)) - np.repeat(
            np.cumsum(sizes[idx]) - sizes[idx], sizes[idx])
        dofs = np.full((nblk, msize), n, dtype=np.int32)
        mask = np.zeros((nblk, msize), dtype=npdt)
        dofs[blk_of, place] = member
        mask[blk_of, place] = 1.0
        owner = np.full(n, -1, dtype=np.int64)
        local = np.zeros(n, dtype=np.int64)
        owner[member] = blk_of
        local[member] = place
        inside = (owner[rows] >= 0) & (owner[rows] == owner[m.indices])
        mats = np.tile(np.eye(msize, dtype=npdt), (nblk, 1, 1))
        mats[blk_of, place, place] = 0.0
        np.add.at(mats, (owner[rows[inside]], local[rows[inside]],
                         local[m.indices[inside]]), m.data[inside])
        # per-block direct factorization on the host (the reference
        # factorizes with UMFPACK / dense LU, BlaSchwarzSetup.c); the
        # device keeps the inverses for the batched apply
        inv = np.linalg.inv(mats.astype(np.float64)).astype(npdt)
        groups.append(_ColorGroup(torch.from_numpy(dofs),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(inv)))

    M = SchwarzPrecond(groups, best_operator(A, dtype=npdt), n,
                       swz_type=param.SWZ_type)
    return M if device is None else M.to(device)
