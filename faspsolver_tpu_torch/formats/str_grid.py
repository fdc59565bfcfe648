"""Structured-grid banded matrix (STR) container.

Reference: base/include/fasp.h:316-348 dSTRmat — banded storage for
structured grids with nc×nc blocks: a diagonal band plus ``nband`` off-bands
at fixed offsets.  On TPU this layout is ideal: each band is a dense
(ngrid, nc, nc) array and SpMV is a sum of shifted batched block products —
no gathers at all.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from .csr import CSRMatrix


@dataclass
class STRMatrix:
    nx: int
    ny: int
    nz: int
    nc: int                      # block size
    diag: np.ndarray             # (ngrid, nc, nc)
    offsets: Tuple[int, ...]     # band offsets (nonzero, in grid indices)
    offdiag: List[np.ndarray]    # per band: (ngrid, nc, nc); entry g couples
                                 # grid point g with grid point g+offset

    @property
    def ngrid(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def nrow(self) -> int:
        return self.ngrid * self.nc

    @property
    def nband(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.diag.dtype

    def to_csr(self) -> CSRMatrix:
        """Expand bands to CSR (reference: fasp_format_dstr_dcsr,
        BlaFormat.c).  The entries are listed in the JAX package's order
        (the diagonal blocks, then each band's blocks, each block row by
        row), built by array operations instead of one Python append per
        entry, so the CSR is the same bit for bit."""
        ng, nc = self.ngrid, self.nc
        g = np.arange(ng)
        grow, gcol, blocks = [g], [g], [self.diag]
        for off, band in zip(self.offsets, self.offdiag):
            ok = g[(g + off >= 0) & (g + off < ng)]
            grow.append(ok)
            gcol.append(ok + off)
            blocks.append(band[ok])
        grow, gcol = np.concatenate(grow), np.concatenate(gcol)
        a = np.arange(nc)
        rows = grow[:, None, None] * nc + a[None, :, None]
        cols = gcol[:, None, None] * nc + a[None, None, :]
        shape = (len(grow), nc, nc)
        return CSRMatrix.from_coo(np.broadcast_to(rows, shape).reshape(-1),
                                  np.broadcast_to(cols, shape).reshape(-1),
                                  np.concatenate(blocks).reshape(-1),
                                  (ng * nc, ng * nc))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Banded block SpMV (host reference; device version in ops/spmv)."""
        ng, nc = self.ngrid, self.nc
        xb = x.reshape(ng, nc)
        y = np.einsum("gab,gb->ga", self.diag, xb)
        for off, band in zip(self.offsets, self.offdiag):
            if off > 0:
                y[:ng - off] += np.einsum("gab,gb->ga", band[:ng - off],
                                          xb[off:])
            else:
                k = -off
                y[k:] += np.einsum("gab,gb->ga", band[k:], xb[:ng - k])
        return y.reshape(-1)

    def to_bsr(self):
        """Expand bands to block-CSR (reference: fasp_format_dstr_dbsr,
        BlaFormat.c)."""
        from .bsr import BSRMatrix
        ng, nc = self.ngrid, self.nc
        rows_l, cols_l, blocks_l = [], [], []
        rows_l.append(np.arange(ng))
        cols_l.append(np.arange(ng))
        blocks_l.append(self.diag)
        for off, band in zip(self.offsets, self.offdiag):
            if off > 0:
                g = np.arange(ng - off)
                rows_l.append(g)
                cols_l.append(g + off)
                blocks_l.append(band[:ng - off])
            else:
                g = np.arange(-off, ng)
                rows_l.append(g)
                cols_l.append(g + off)
                blocks_l.append(band[-off:])
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        blocks = np.concatenate(blocks_l, axis=0)
        order = np.lexsort((cols, rows))
        rows, cols, blocks = rows[order], cols[order], blocks[order]
        indptr = np.zeros(ng + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return BSRMatrix(indptr, cols, blocks, (ng, ng))
