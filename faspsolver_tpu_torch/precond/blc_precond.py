"""Block-composite (BLC) preconditioners (port of
``faspsolver_tpu/precond/blc_precond.py``).

Reference: base/src/PreBLC.c — block-diagonal / block-lower / block-upper
/ block-SGS preconditioners for 2x2..4x4 coupled systems, with AMG (or
diagonal) approximations of the diagonal blocks, and the layered
"sweeping" preconditioner for block-tridiagonal systems
(fasp_precond_dblc_sweeping; data fasp_block.h:398-414).

Each sub-block is a device operator (``device_operator``) and each
diagonal-block inverse a UA-AMG V-cycle or Jacobi (``JacobiPrecond``).
A block grid with holes keeps its operators in an ``nn.ModuleDict``
keyed ``"i,j"`` (a missing key is a zero block), so one ``.to(device)``
moves all of them.
Slices of a vector are ``narrow`` views and the pieces are joined with
``torch.cat``; the block sizes and the grid's keys are fixed at setup, so
no apply reads back to the host, and each module is capturable when all
its parts are (a resident Krylov loop over it is one CUDA graph).  Plain
PyTorch: the JAX package computes these outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import as_tensor, torch_dtype
from ..formats import CSRMatrix
from ..formats.blc import BLCMatrix
from ..krylov.precond import JacobiPrecond
from ..ops.operators import device_operator
from ..utils.graphs import capturable
from ..utils.params import AMGParam


def _split(x: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    out, off = [], 0
    for s in sizes:
        out.append(x.narrow(0, off, s))
        off += s
    return out


def _grid(ops: Dict[Tuple[int, int], nn.Module]) -> nn.ModuleDict:
    return nn.ModuleDict({f"{i},{j}": op for (i, j), op in ops.items()})


class BlcOperator(nn.Module):
    """Device operator for a matrix of blocks: y_i = sum_j A_ij x_j
    (reference: fasp_blas_dblc_aAxpy, BlaSpmvBLC.c).  ``ops`` maps
    (i, j) to the operator of a nonzero block."""

    @property
    def capturable(self) -> bool:
        return all(capturable(op) for op in self.ops.values())

    def __init__(self, ops: Dict[Tuple[int, int], nn.Module],
                 row_sizes: Sequence[int], col_sizes: Sequence[int]):
        super().__init__()
        self.ops = _grid(ops)
        self.row_sizes = tuple(int(s) for s in row_sizes)
        self.col_sizes = tuple(int(s) for s in col_sizes)

    def block(self, i: int, j: int) -> Optional[nn.Module]:
        return self.ops[f"{i},{j}"] if f"{i},{j}" in self.ops else None

    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(self.row_sizes), sum(self.col_sizes))

    @property
    def dtype(self):
        for op in self.ops.values():
            return op.dtype
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = _split(x, self.col_sizes)
        ys = []
        for i, n in enumerate(self.row_sizes):
            acc = x.new_zeros(n)
            for j in range(len(self.col_sizes)):
                op = self.block(i, j)
                if op is not None:
                    acc = acc + op(xs[j])
            ys.append(acc)
        return torch.cat(ys)

    @classmethod
    def from_blc(cls, A: BLCMatrix, dtype=None) -> "BlcOperator":
        dtype = torch_dtype(dtype)
        ops = {(i, j): device_operator(b, dtype=dtype)
               for i, row in enumerate(A.blocks)
               for j, b in enumerate(row) if b is not None}
        return cls(ops, A.row_sizes(), A.col_sizes())


def _diag_solver(block: CSRMatrix, kind: str, amg: Optional[AMGParam],
                 dtype) -> nn.Module:
    """Approximate inverse of one diagonal block: 'amg' (UA-AMG) |
    'diag' (Jacobi, also for blocks of at most 64 rows)."""
    if kind == "diag" or block.nrow <= 64:
        d = block.diagonal()
        d = np.where(d != 0.0, d, 1.0)
        return JacobiPrecond(as_tensor(1.0 / d, dtype))
    from .amg.setup_ua import setup_ua
    from .preconditioners import AMGPrecond
    return AMGPrecond(setup_ua(block, amg or AMGParam(), dtype=dtype))


class BlcPrecond(nn.Module):
    """Block diag / lower / upper / SGS preconditioner (reference:
    PreBLC.c fasp_precond_dblc_diag_/lower_/upper_/sgs_{2,3,4}):
    ``solvers[i]`` approximates A_ii^{-1}, ``offdiag`` maps (i, j), i != j,
    to the operator of a nonzero off-diagonal block."""

    @property
    def capturable(self) -> bool:
        return all(capturable(m) for m in (*self.solvers,
                                           *self.offdiag.values()))

    def __init__(self, solvers: Sequence[nn.Module],
                 offdiag: Dict[Tuple[int, int], nn.Module], mode: str,
                 sizes: Sequence[int]):
        super().__init__()
        self.solvers = nn.ModuleList(solvers)
        self.offdiag = _grid(offdiag)
        self.mode = mode                   # diag | lower | upper | sgs
        self.sizes = tuple(int(s) for s in sizes)

    def _gs(self, rs, zs, order):
        """Block GS updates in the given order using the current iterate:
        z_i <- M_i^{-1}(r_i - sum_{j != i} A_ij z_j)."""
        nb = len(self.sizes)
        for i in order:
            acc = rs[i]
            for j in range(nb):
                key = f"{i},{j}"
                if j != i and key in self.offdiag and zs[j] is not None:
                    acc = acc - self.offdiag[key](zs[j])
            zs[i] = self.solvers[i](acc)
        return zs

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        rs = _split(r, self.sizes)
        nb = len(self.sizes)
        if self.mode == "diag":
            zs = [self.solvers[i](rs[i]) for i in range(nb)]
        elif self.mode == "lower":
            zs = self._gs(rs, [None] * nb, range(nb))
        elif self.mode == "upper":
            zs = self._gs(rs, [None] * nb, range(nb - 1, -1, -1))
        else:                                   # sgs: forward then backward
            zs = self._gs(rs, [None] * nb, range(nb))
            zs = self._gs(rs, zs, range(nb - 1, -1, -1))
        return torch.cat(zs)


def setup_blc_precond(A: BLCMatrix, mode: str = "diag",
                      diag_solver: str = "amg",
                      amg: Optional[AMGParam] = None,
                      dtype=None) -> BlcPrecond:
    """A block preconditioner whose diagonal blocks get AMG (or Jacobi)
    approximate inverses (reference: fasp_precond_dblc_diag_3_amg etc.),
    built on the host."""
    dtype = torch_dtype(dtype)
    nb = A.brow
    if nb != A.bcol:
        raise ValueError("block preconditioner needs a square block grid")
    solvers = [_diag_solver(A.blocks[i][i], diag_solver, amg, dtype)
               for i in range(nb)]
    offdiag = {(i, j): device_operator(A.blocks[i][j], dtype=dtype)
               for i in range(nb) for j in range(nb)
               if i != j and A.blocks[i][j] is not None}
    return BlcPrecond(solvers, offdiag, mode, A.row_sizes())


class BlcSweepingPrecond(nn.Module):
    """Layered sweeping preconditioner for block-tridiagonal systems
    (reference: fasp_precond_dblc_sweeping, PreBLC.c; data
    fasp_block.h:398-414): forward elimination with per-layer
    approximate solves, then backward substitution.  ``lower`` /
    ``upper`` map a layer i to its sub- (A_{i+1,i}) / super- (A_{i,i+1})
    diagonal operator where that block is nonzero."""

    @property
    def capturable(self) -> bool:
        return all(capturable(m) for m in (*self.solvers,
                                           *self.lower.values(),
                                           *self.upper.values()))

    def __init__(self, solvers: Sequence[nn.Module],
                 lower: Dict[int, nn.Module], upper: Dict[int, nn.Module],
                 sizes: Sequence[int]):
        super().__init__()
        self.solvers = nn.ModuleList(solvers)
        self.lower = nn.ModuleDict({str(i): op for i, op in lower.items()})
        self.upper = nn.ModuleDict({str(i): op for i, op in upper.items()})
        self.sizes = tuple(int(s) for s in sizes)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        nb = len(self.sizes)
        rs = _split(r, self.sizes)
        # forward sweep
        zs = [None] * nb
        zs[0] = self.solvers[0](rs[0])
        for i in range(1, nb):
            acc = rs[i]
            if str(i - 1) in self.lower:
                acc = acc - self.lower[str(i - 1)](zs[i - 1])
            zs[i] = self.solvers[i](acc)
        # backward sweep
        for i in range(nb - 2, -1, -1):
            if str(i) in self.upper:
                zs[i] = zs[i] - self.solvers[i](self.upper[str(i)](zs[i + 1]))
        return torch.cat(zs)


def setup_blc_sweeping(A: BLCMatrix, diag_solver: str = "amg",
                       amg: Optional[AMGParam] = None,
                       dtype=None) -> BlcSweepingPrecond:
    dtype = torch_dtype(dtype)
    nb = A.brow
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) > 1 and A.blocks[i][j] is not None:
                raise ValueError("sweeping preconditioner needs a "
                                 "block-tridiagonal system")
    solvers = [_diag_solver(A.blocks[i][i], diag_solver, amg, dtype)
               for i in range(nb)]
    lower = {i: device_operator(A.blocks[i + 1][i], dtype=dtype)
             for i in range(nb - 1) if A.blocks[i + 1][i] is not None}
    upper = {i: device_operator(A.blocks[i][i + 1], dtype=dtype)
             for i in range(nb - 1) if A.blocks[i][i + 1] is not None}
    return BlcSweepingPrecond(solvers, lower, upper, A.row_sizes())
