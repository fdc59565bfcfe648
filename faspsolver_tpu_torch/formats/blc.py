"""Block-composite matrix: a 2D grid of CSR sub-blocks.

Reference: base/include/fasp_block.h:74-85 dBLCmat — matrix-of-CSR-blocks
used for coupled multi-physics systems (e.g. 2x2 saddle-point, 3x3/4x4
reservoir systems, SolBLC.c drivers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .csr import CSRMatrix


@dataclass
class BLCMatrix:
    blocks: List[List[Optional[CSRMatrix]]]   # brow x bcol grid; None = zero

    @property
    def brow(self) -> int:
        return len(self.blocks)

    @property
    def bcol(self) -> int:
        return len(self.blocks[0])

    def row_sizes(self) -> List[int]:
        sizes = [0] * self.brow
        for i, row in enumerate(self.blocks):
            for b in row:
                if b is not None:
                    sizes[i] = b.nrow
                    break
        return sizes

    def col_sizes(self) -> List[int]:
        sizes = [0] * self.bcol
        for j in range(self.bcol):
            for row in self.blocks:
                if row[j] is not None:
                    sizes[j] = row[j].ncol
                    break
        return sizes

    @property
    def nrow(self) -> int:
        return sum(self.row_sizes())

    def to_csr(self) -> CSRMatrix:
        """Merge to one CSR (reference: fasp_format_dblc_dcsr, BlaFormat.c)."""
        rs, cs = self.row_sizes(), self.col_sizes()
        grid = [[(b.to_scipy() if b is not None else None) for b in row]
                for row in self.blocks]
        # fill Nones with explicit zero blocks of right size
        for i in range(self.brow):
            for j in range(self.bcol):
                if grid[i][j] is None:
                    grid[i][j] = sp.csr_matrix((rs[i], cs[j]))
        return CSRMatrix.from_scipy(sp.bmat(grid, format="csr"))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        rs, cs = self.row_sizes(), self.col_sizes()
        roff = np.concatenate([[0], np.cumsum(rs)])
        coff = np.concatenate([[0], np.cumsum(cs)])
        y = np.zeros(roff[-1], dtype=x.dtype)
        for i in range(self.brow):
            for j in range(self.bcol):
                b = self.blocks[i][j]
                if b is not None:
                    y[roff[i]:roff[i + 1]] += b.matvec(x[coff[j]:coff[j + 1]])
        return y
