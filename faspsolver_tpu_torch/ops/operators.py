"""Device operators as ``nn.Module``s.

Port of ``faspsolver_tpu/ops/operators.py``: the structured path's
DiaOperator, DiaNdOperator, FactoredBand, StencilNdOperator and
DenseOperator, the general path's EllOperator, ConstDiaOperator,
SumOperator, CooOperator, HybridDiaOperator with the per-level format
choice ``best_operator`` / ``device_operator``, the block path's
BsrEllOperator, and MatFreeOperator over any callable.  Arrays are registered
buffers, so ``.to(device)`` on any enclosing module moves them.  Every
2-D stencil apply with offsets in {-1, 0, 1}^2 goes through
``ops/stencil2d.py``: the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors.  The other operators are plain PyTorch.  The
DIA, stencil, ELL and block-ELL operators also take a row-split DTensor
vector of the distribution layer and apply as ``parallel/`` sets out
(halo exchange for the banded ones, a gathered x for ELL and BSR).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import as_tensor, is_dtensor, np_dtype, torch_dtype
from ..formats import BSRMatrix, CSRMatrix
from ..utils.graphs import capturable
from .stencil2d import (ROW_BROADCAST, ROW_INDEXED, Band2d, StencilPlan,
                        full_band, kernel_covers)


def _buf(a, dtype=None) -> torch.Tensor:
    """Tensor as given, or a host array copied into a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return as_tensor(a, dtype)


def full_precision_matmul() -> None:
    """float32 products in full float32 (no TF32): the counterpart of the
    JAX package's ``precision=Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class DiaOperator(nn.Module):
    """Flat banded operator: ``bands[k, i] = A[i, i + offsets[k]]``; the
    apply is a sum of shifted multiplies over the zero-padded vector."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, bands, offsets, n: int):
        super().__init__()
        self.register_buffer("bands", _buf(bands))
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(x):
            # row-split: the halo from the neighbouring ranks
            from ..parallel.comm import local_rows
            from ..parallel.halo import halo_dia_apply
            mesh = x.device_mesh
            return halo_dia_apply(local_rows(self.bands, mesh, 1),
                                  self.offsets, x, mesh, self.n)
        n = self.n
        pad = max(max(abs(o) for o in self.offsets), 1)
        xp = F.pad(x, (pad, pad))
        y = torch.zeros_like(x)
        for k, off in enumerate(self.offsets):
            y = y + self.bands[k] * xp[pad + off:pad + off + n]
        return y

    def diagonal(self) -> torch.Tensor:
        for k, off in enumerate(self.offsets):
            if off == 0:
                return self.bands[k]
        return self.bands.new_zeros(self.n)

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None) -> "DiaOperator":
        offsets, bands = dia_bands_from_csr(A)
        return cls(as_tensor(bands, dtype), offsets, A.nrow)


def _nd_pad(v: torch.Tensor, halo) -> torch.Tensor:
    pads = []
    for h in reversed(halo):
        pads += [h, h]
    return F.pad(v, pads)


class DiaNdOperator(nn.Module):
    """Grid-aware banded operator with full (k, *dims) bands: shifts per
    axis, ``coords[k]`` the per-axis offset of band k (the value at grid
    point p multiplies x[p + coord]).  x stays flat outside."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, bands, coords, dims):
        super().__init__()
        self.register_buffer("bands", _buf(bands))
        self.coords = tuple(tuple(int(v) for v in c) for c in coords)
        self.dims = tuple(int(d) for d in dims)

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.reshape(self.dims)
        h = [max((abs(c[a]) for c in self.coords), default=0)
             for a in range(len(self.dims))]
        vp = _nd_pad(v, h)
        y = torch.zeros_like(v)
        for k, co in enumerate(self.coords):
            sl = tuple(slice(hh + c, hh + c + d)
                       for hh, c, d in zip(h, co, self.dims))
            y = y + self.bands[k] * vp[sl]
        return y.reshape(-1)

    def diagonal(self) -> torch.Tensor:
        zero = tuple(0 for _ in self.dims)
        for k, co in enumerate(self.coords):
            if co == zero:
                return self.bands[k].reshape(-1)
        return self.bands.new_zeros(self.n)


class FactoredBand(nn.Module):
    """One stencil band stored as an EXACT distinct-row/column
    factorization ``band = row_sel @ core @ col_sel`` (0/1 selectors from
    :func:`factor_band_2d`).

    Beside the factors it keeps the form the stencil kernel reads:
    ``w = core @ col_sel`` ((r, d1) or (r, 1), exact: one nonzero term
    per entry) and ``rows[i]`` = the index of the single 1 in row i of
    ``row_sel`` (when r > 1), so ``band[i, j] = w[rows[i], j]``."""

    def __init__(self, row_sel, core, col_sel):
        super().__init__()
        row_sel, core, col_sel = (_buf(row_sel), _buf(core), _buf(col_sel))
        self.register_buffer("row_sel", row_sel)
        self.register_buffer("core", core)
        self.register_buffer("col_sel", col_sel)
        w = (core.double() @ col_sel.double()).to(core.dtype)
        self.register_buffer("w", w.contiguous())
        self.register_buffer(
            "rows", row_sel.argmax(dim=1).to(torch.int32).contiguous()
            if row_sel.shape[1] > 1 else None)

    @property
    def dtype(self):
        return self.core.dtype

    @property
    def size(self) -> int:
        return int(self.row_sel.numel() + self.core.numel()
                   + self.col_sel.numel())

    def band2d(self) -> Band2d:
        cstride = 1 if self.w.shape[1] > 1 else 0
        if self.rows is None:
            return Band2d(self.w, None, ROW_BROADCAST, cstride)
        return Band2d(self.w, self.rows, ROW_INDEXED, cstride)

    def apply(self, y, shifted_x):
        """y + band * shifted_x over the (axis0, rest) view."""
        return y + self.band2d().coef() * shifted_x

    def materialize(self) -> torch.Tensor:
        full_precision_matmul()
        return self.row_sel @ (self.core @ self.col_sel)


def factor_band_2d(band: np.ndarray, max_rank: int = 8,
                   min_gain: float = 4.0):
    """EXACT factorization of a 2-D band by distinct-row then distinct-
    column grouping; None when the band does not compress by ``min_gain``.

    Galerkin coarse operators of constant-coefficient stencils have a
    bounded number of distinct rows/columns (interior constant + boundary
    corrections from ragged aggregates), so ``r`` stays small; genuinely
    variable-coefficient bands fail the rank bound and stay dense.
    """
    if band.ndim != 2:
        return None
    d0, d1 = band.shape
    # O(n) distinct-row detection via contiguous runs (np.unique(axis=0)
    # lexsorts all rows — ~50x slower at 1M rows).  Structured-grid bands
    # vary only near boundaries, so distinct rows form a handful of runs;
    # non-contiguous repetition patterns simply stay dense.
    if d0 > 1:
        cont = (band[1:] == band[:-1]).all(axis=1)
        change = np.flatnonzero(~cont)
        if len(change) + 1 > 4 * max_rank:
            return None
        starts = np.concatenate([[0], change + 1])
        reps = band[starts]
        rows_u, inv_small = np.unique(reps, axis=0, return_inverse=True)
        run_id = np.cumsum(np.concatenate([[0], (~cont).astype(np.int64)]))
        row_inv = inv_small.reshape(-1)[run_id]
    else:
        rows_u, row_inv = band, np.zeros(1, dtype=np.int64)
    r = rows_u.shape[0]
    if r > max_rank:
        return None
    cols_u, col_inv = np.unique(rows_u, axis=1, return_inverse=True)
    rc = cols_u.shape[1]
    if r == 1:
        # constant along axis 0: selector collapses to a broadcast scalar
        row_sel = np.ones((1, 1), dtype=band.dtype)
    else:
        row_sel = np.zeros((d0, r), dtype=band.dtype)
        row_sel[np.arange(d0), row_inv.reshape(-1)] = 1.0
    if rc == 1:
        col_sel = np.ones((1, 1), dtype=band.dtype)
    else:
        col_sel = np.zeros((rc, d1), dtype=band.dtype)
        col_sel[col_inv.reshape(-1), np.arange(d1)] = 1.0
    total = row_sel.size + r * rc + col_sel.size
    if total * min_gain > band.size:
        return None
    return row_sel, cols_u, col_sel


class StencilNdOperator(nn.Module):
    """Grid-aware banded operator with per-band exact compression: each
    band is a full grid array (or a broadcastable (1|d0, 1|d1) one) or a
    :class:`FactoredBand`.

    2-D stencils with offsets in {-1, 0, 1}^2 — every level the
    structured hierarchy builds, and its f64 fine operator — apply
    through :class:`~.stencil2d.StencilPlan` (CUDA kernel on the card,
    plain version on the CPU)."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, bands, coords, dims):
        super().__init__()
        self.coords = tuple(tuple(int(v) for v in c) for c in coords)
        self.dims = tuple(int(d) for d in dims)
        self._nb = len(bands)
        for k, b in enumerate(bands):
            if isinstance(b, FactoredBand):
                self.add_module(f"band{k}", b)
            else:
                self.register_buffer(f"band{k}", _buf(b))
        self._plan = None
        self._kernel = kernel_covers(self.coords, self.dims) and all(
            self._band2d(b) is not None for b in self.bands)

    @property
    def bands(self) -> tuple:
        return tuple(getattr(self, f"band{k}") for k in range(self._nb))

    def _band2d(self, b):
        if isinstance(b, FactoredBand):
            bd = b.band2d()
            ok = (bd.w.shape[1] in (1, self.dims[1]) and (
                bd.rows is None or bd.rows.numel() == self.dims[0]))
            return bd if ok else None
        return full_band(b, self.dims)

    def _apply(self, fn, recurse=True):
        self._plan = None            # device pointers change with the move
        return super()._apply(fn, recurse)

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands[0].dtype

    @property
    def device_bytes(self) -> int:
        """Coefficient bytes of the factors (the JAX package's measure of
        the compression gain)."""
        tot = 0
        for b in self.bands:
            tot += b.size if isinstance(b, FactoredBand) else b.numel()
        return tot * self.dtype.itemsize

    def __getstate__(self):
        # a copy builds its own plan: the plan holds device pointers
        return dict(self.__dict__, _plan=None)

    def plan(self) -> StencilPlan:
        if self._plan is None:
            self._plan = StencilPlan([self._band2d(b) for b in self.bands],
                                     self.coords, self.dims)
        return self._plan

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(x):
            # row-split: the kernel on the local rows and their halo
            from ..parallel.dist_dia import stencil_apply
            return stencil_apply(self, x)
        if self._kernel:
            return self.plan()(x)
        # Stencils the 2-D kernel does not cover — 3-D grids, offsets
        # beyond {-1, 0, 1}^2, band shapes outside its layouts — are
        # decided here from the operator's static structure (never from
        # a failure) and take the plain shifted adds.  The structured
        # 2-D hierarchy builds none of them.
        v = x.reshape(self.dims)
        h = [max((abs(c[a]) for c in self.coords), default=0)
             for a in range(len(self.dims))]
        vp = _nd_pad(v, h)
        d0 = self.dims[0]
        y = torch.zeros_like(v)
        for b, co in zip(self.bands, self.coords):
            sl = tuple(slice(hh + c, hh + c + d)
                       for hh, c, d in zip(h, co, self.dims))
            sx = vp[sl]
            if isinstance(b, FactoredBand):
                # factorization is (axis0, rest) — flatten trailing axes
                y = b.apply(y.reshape(d0, -1),
                            sx.reshape(d0, -1)).reshape(self.dims)
            else:
                y = y + b * sx
        return y.reshape(-1)

    def diagonal(self) -> torch.Tensor:
        zero = tuple(0 for _ in self.dims)
        d0 = self.dims[0]
        rest = self.n // max(d0, 1)
        for b, co in zip(self.bands, self.coords):
            if co == zero:
                if isinstance(b, FactoredBand):
                    return torch.broadcast_to(b.materialize(),
                                              (d0, rest)).reshape(-1)
                return b.reshape(-1)
        return torch.zeros(self.n, dtype=self.dtype,
                           device=next(self.buffers()).device)


class DenseOperator(nn.Module):
    """Dense operator for the coarsest AMG level: one matmul in full
    precision."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, mat, n: int):
        super().__init__()
        self.register_buffer("mat", _buf(mat))
        self.n = int(n)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.mat.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        full_precision_matmul()
        return torch.matmul(self.mat, x)

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None) -> "DenseOperator":
        return cls(as_tensor(A.to_dense(), dtype), A.nrow)


def dia_bands_from_csr(A: CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (offsets, row-aligned bands) from a square CSR matrix:
    the native OpenMP pass when available, else vectorized NumPy."""
    from .. import native
    nat = native.dia_from_csr(A)
    if nat is not None:
        return nat
    n = A.nrow
    rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
    off = A.indices.astype(np.int64) - rows
    offsets = np.unique(off)
    pos = np.searchsorted(offsets, off)
    bands = np.zeros((len(offsets), n), dtype=A.data.dtype)
    bands[pos, rows] = A.data
    return offsets, bands



# ---------------------------------------------------------------------------
# general (unstructured) path: ELL, COO, constant bands, hybrids
# ---------------------------------------------------------------------------

# Format gates: the JAX package's values, tuned on a TPU and kept for
# parity (ROADMAP §2b item 4 lists them for re-derivation on the H100).
_ELL_PADDING_LIMIT = 3.0     # padded ELL above this multiple of nnz -> COO
_ELL_ROW_ALIGN = 8           # ELL rows padded to a multiple of this
_COO_PAD_ALIGN = 128         # COO entries padded to a multiple of this
_DIA_MAX_BANDS = 36          # device_operator: DIA only up to this many
_DIA_FILL_LIMIT = 3.0        # ... and up to this multiple of nnz stored
_BEST_MAX_BANDS = 64         # best_operator: most bands kept
_BEST_MIN_BAND_FRAC = 0.02   # ... a band holds at least this share of n
_BEST_MIN_COVERAGE = 0.5     # ... the bands hold at least this share of nnz
_BEST_FILL_LIMIT = 8.0       # ... and store at most this multiple of nnz
_CONST_MIN_N = 4096          # constant-band compression from this n on
_CONST_MIN_BANDS = 2         # ... when at least this many bands compress

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """Bit-pack a boolean row mask into int32 words (bit i of word i//32);
    :func:`unpack_bits` is the inverse."""
    m = np.asarray(mask, dtype=bool)
    n = m.size
    nw = (n + 31) // 32
    padded = np.zeros(nw * 32, dtype=np.uint32)
    padded[:n] = m
    words = (padded.reshape(nw, 32)
             << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32)
    return words.view(np.int32)


def unpack_bits(words: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Inverse of :func:`pack_bits` over the last axis: (..., nw) int32
    words -> (..., n) 0/1 of ``dtype`` (exact, so a band times its mask
    equals the full band)."""
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    m = (words.unsqueeze(-1) >> bits) & 1
    return m.reshape(*words.shape[:-1], -1)[..., :n].to(dtype)


class EllOperator(nn.Module):
    """Padded-ELL operator: rows padded to ``k`` slots (empty slots point
    at column 0 with value 0), ``n_pad >= n`` rows; the apply is one
    gather, a multiply and a row sum."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, cols, vals, n: int, ncol: int):
        super().__init__()
        self.register_buffer("cols", _buf(cols))
        self.register_buffer("vals", _buf(vals))
        self.n = int(n)
        self.ncol = int(ncol)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.ncol)

    @property
    def dtype(self):
        return self.vals.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(x):
            from ..parallel.pcsr import ell_apply
            return ell_apply(self, x)
        g = x.index_select(0, self.cols.reshape(-1)).reshape(self.cols.shape)
        return (self.vals * g).sum(dim=1)[:self.n]

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None) -> "EllOperator":
        npdt = np_dtype(dtype)
        n, ncol = A.shape
        nnz_per_row = A.row_nnz()
        k = max(int(nnz_per_row.max()) if n else 0, 1)
        n_pad = _round_up(max(n, 1), _ELL_ROW_ALIGN)
        cols = np.zeros((n_pad, k), dtype=np.int32)
        vals = np.zeros((n_pad, k), dtype=npdt)
        if A.nnz:
            rows = np.repeat(np.arange(n), nnz_per_row)
            slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
            cols[rows, slot] = A.indices
            vals[rows, slot] = A.data.astype(npdt)
        return cls(as_tensor(cols), as_tensor(vals), n, ncol)

    def padding_ratio(self, A_nnz: int) -> float:
        return self.cols.numel() / max(A_nnz, 1)


def block_diag_apply(blocks: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """(m, nb, nb) blocks times the (m, nb) block vector: one batched
    product, in full float32 for float32 (no TF32)."""
    full_precision_matmul()
    return torch.bmm(blocks, vb.unsqueeze(-1)).squeeze(-1)


def block_ell_layout(vals) -> torch.Tensor:
    """(m, k, nb, nb) blocks as the contiguous ``[r, a, s, b]`` array
    (row of the block before the slot) that :func:`block_ell_apply`
    reads as (m, nb, k*nb) matrices with no copy."""
    return _buf(vals).permute(0, 2, 1, 3).contiguous()


def block_ell_apply(blocks: torch.Tensor, cols: torch.Tensor,
                    xb: torch.Tensor) -> torch.Tensor:
    """Row sums of block-ELL rows times a block vector: ``blocks`` in
    :func:`block_ell_layout`, ``cols`` (m, k) block-column ids, ``xb``
    (ncol, nb); returns (m, nb).  One gather and one batched product, in
    full float32 for float32 (no TF32)."""
    full_precision_matmul()
    m, nb, k, _ = blocks.shape
    g = xb.index_select(0, cols.reshape(-1)).reshape(m, k * nb, 1)
    return torch.bmm(blocks.reshape(m, nb, k * nb), g).squeeze(-1)


class BsrEllOperator(nn.Module):
    """Block-ELL operator for BSR matrices: every block row holds k
    (nb, nb) blocks (zero blocks pad short rows, their column id 0), and
    the apply contracts them with the gathered (k, nb) pieces of x in one
    batched product, in place of the reference's per-nb unrolled scalar
    code (BlaSpmvBSR.c:301-412).

    The blocks are stored in :func:`block_ell_layout`; ``vals`` is the
    (nbrow, k, nb, nb) view of them.  float32 products run in full
    float32: ``torch.backends.cuda.matmul.allow_tf32`` is set False before
    every product, the counterpart of the JAX package's
    ``Precision.HIGHEST``."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, cols, vals, nbrow: int, nbcol: int, nb: int):
        super().__init__()
        self.register_buffer("cols", _buf(cols))                # (nbrow, k)
        self.register_buffer("blocks", block_ell_layout(vals))
        self.nbrow = int(nbrow)
        self.nbcol = int(nbcol)
        self.nb = int(nb)

    @property
    def vals(self) -> torch.Tensor:
        return self.blocks.permute(0, 2, 1, 3)

    @property
    def n(self) -> int:
        return self.nbrow * self.nb

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nbrow * self.nb, self.nbcol * self.nb)

    @property
    def dtype(self):
        return self.blocks.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(x):
            from ..parallel.pcsr import bsr_apply
            return bsr_apply(self, x)
        return block_ell_apply(self.blocks, self.cols,
                               x.reshape(self.nbcol, self.nb)).reshape(-1)

    @classmethod
    def from_bsr(cls, A: BSRMatrix, dtype=None) -> "BsrEllOperator":
        npdt = np_dtype(dtype)
        nbrow, nbcol = A.shape
        nb = A.nb
        nnz_per_row = np.diff(A.indptr)
        k = max(int(nnz_per_row.max()) if nbrow else 0, 1)
        cols = np.zeros((nbrow, k), dtype=np.int32)
        vals = np.zeros((nbrow, k, nb, nb), dtype=npdt)
        if A.nnz_block:
            rows = np.repeat(np.arange(nbrow), nnz_per_row)
            slot = (np.arange(A.nnz_block)
                    - np.repeat(A.indptr[:-1], nnz_per_row))
            cols[rows, slot] = A.indices
            vals[rows, slot] = A.data.astype(npdt)
        return cls(torch.from_numpy(cols), torch.from_numpy(vals), nbrow,
                   nbcol, nb)


class CooOperator(nn.Module):
    """Segment-sum COO operator for irregular rows.  Padding entries point
    at row ``n``, which the apply drops.  On CUDA ``index_add_`` adds
    atomically, so float sums there are not deterministic."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, rows, cols, vals, n: int, ncol: int):
        super().__init__()
        self.register_buffer("rows", _buf(rows))
        self.register_buffer("cols", _buf(cols))
        self.register_buffer("vals", _buf(vals))
        self.n = int(n)
        self.ncol = int(ncol)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.ncol)

    @property
    def dtype(self):
        return self.vals.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        prod = self.vals * x.index_select(0, self.cols)
        y = x.new_zeros(self.n + 1).index_add_(0, self.rows, prod)
        return y[:self.n]

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None) -> "CooOperator":
        npdt = np_dtype(dtype)
        n, ncol = A.shape
        nnz = A.nnz
        nnz_pad = _round_up(max(nnz, 1), _COO_PAD_ALIGN)
        rows = np.full(nnz_pad, n, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=npdt)
        rows[:nnz] = np.repeat(np.arange(n), A.row_nnz())
        cols[:nnz] = A.indices
        vals[:nnz] = A.data.astype(npdt)
        return cls(as_tensor(rows), as_tensor(cols), as_tensor(vals), n, ncol)


class ConstDiaOperator(nn.Module):
    """DIA bands whose values are one scalar each on a row bitmask:
    ``band_k = consts[k] * mask_k`` exactly (Galerkin coarse operators of
    constant-coefficient problems: constant along each diagonal up to a
    presence pattern).  The masks stay bit-packed; the apply unpacks all
    of them in one pass and is bit-identical to the full bands.

    Reference analog: the dSTRmat constant-stencil storage
    (fasp.h:316-348), without grid detection."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, consts, masks, offsets, n: int):
        super().__init__()
        self.register_buffer("consts", _buf(consts))      # (k,)
        self.register_buffer("masks", _buf(masks))        # (k, nw) int32
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.consts.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        pad = max(max(abs(o) for o in self.offsets), 1)
        xp = F.pad(x, (pad, pad))
        m = unpack_bits(self.masks, n, x.dtype)
        y = torch.zeros_like(x)
        for k, off in enumerate(self.offsets):
            y = y + (self.consts[k] * m[k]) * xp[pad + off:pad + off + n]
        return y

    def diagonal(self) -> torch.Tensor:
        for k, off in enumerate(self.offsets):
            if off == 0:
                return self.consts[k] * unpack_bits(self.masks[k], self.n,
                                                    self.dtype)
        return self.consts.new_zeros(self.n)


class SumOperator(nn.Module):
    """Sum of operator parts of one shape (ConstDia + Dia pieces of one
    matrix), applied in order."""

    @property
    def capturable(self) -> bool:
        return all(capturable(p) for p in self.parts)

    def __init__(self, parts):
        super().__init__()
        self.parts = nn.ModuleList(parts)

    @property
    def n(self) -> int:
        return self.parts[0].shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.parts[0].shape

    @property
    def dtype(self):
        return self.parts[0].dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.parts[0](x)
        for p in self.parts[1:]:
            y = y + p(x)
        return y

    def diagonal(self) -> torch.Tensor:
        y = self.parts[0].diagonal()
        for p in self.parts[1:]:
            if hasattr(p, "diagonal"):
                y = y + p.diagonal()
        return y


class MatFreeOperator(nn.Module):
    """Any callable ``x -> A x`` as an operator with ``shape`` and
    ``dtype`` (reference: mxv_matfree, fasp.h:1109-1117).  A callable that
    is an ``nn.Module`` becomes a child, so ``.to()`` moves its buffers.
    It is capturable only when that child declares itself so: a plain
    Python function is opaque and keeps every loop over it eager."""

    @property
    def capturable(self) -> bool:
        return isinstance(self.fn, nn.Module) and capturable(self.fn)

    def __init__(self, fn, n: int, _dtype):
        super().__init__()
        self.fn = fn
        self.n = int(n)
        self._dtype = torch_dtype(_dtype)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class HybridDiaOperator(nn.Module):
    """Banded part + COO remainder: the mostly-banded matrices of
    classical-AMG coarse levels on grid problems (a few dominant
    diagonals and a thin irregular tail)."""

    @property
    def capturable(self) -> bool:
        return capturable(self.dia) and capturable(self.rem)

    def __init__(self, dia, rem: CooOperator):
        super().__init__()
        self.dia = dia
        self.rem = rem

    @property
    def n(self) -> int:
        return self.dia.n

    @property
    def shape(self) -> Tuple[int, int]:
        return self.dia.shape

    @property
    def dtype(self):
        return self.dia.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dia(x) + self.rem(x)

    def diagonal(self) -> torch.Tensor:
        # the remainder can carry main-diagonal entries (demoted boundary
        # rows of near-constant bands): fold them in
        d = self.dia.diagonal()
        on = self.rem.rows == self.rem.cols
        contrib = torch.where(on, self.rem.vals,
                              torch.zeros_like(self.rem.vals)).to(d.dtype)
        return d + d.new_zeros(self.n + 1).index_add_(
            0, self.rem.rows, contrib)[:self.n]


def dia_fill_ok(A: CSRMatrix) -> bool:
    """Cheap check whether DIA storage is sensible for this matrix."""
    if A.nrow != A.ncol or A.nnz == 0:
        return False
    rows = np.repeat(np.arange(A.nrow, dtype=np.int64), A.row_nnz())
    noffs = len(np.unique(A.indices.astype(np.int64) - rows))
    return (noffs <= _DIA_MAX_BANDS
            and noffs * A.nrow <= _DIA_FILL_LIMIT * A.nnz)


def best_operator(A: CSRMatrix, dtype=None):
    """Per-level operator by sparsity shape: a factored stencil for fully
    banded grid-detectable matrices, DIA (or constant-band DIA) for other
    banded ones, DIA + COO hybrid for mostly-banded ones, ELL/COO
    otherwise, dense for tiny levels.  The algorithm stays general; only
    the storage adapts."""
    npdt = np_dtype(dtype)
    n = A.nrow
    if A.nrow != A.ncol or A.nnz == 0:
        return device_operator(A, dtype=npdt)
    if n <= 256:
        return DenseOperator.from_csr(A, dtype=npdt)
    # offset histogram: the native pass when available, else an O(nnz)
    # bincount
    from .. import native
    rows = off = None
    hist = native.dia_hist(A)
    if hist is None:
        rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
        off = A.indices.astype(np.int64) - rows
        hist = np.bincount(off + n, minlength=2 * n + 1)
    cand = np.nonzero(hist >= max(_BEST_MIN_BAND_FRAC * n, 1))[0]
    order = cand[np.argsort(-hist[cand])][:_BEST_MAX_BANDS]
    # trim the sparse tail: dense bands (>= 10% filled) always stay;
    # thinner ones only until 90% coverage
    csum = np.cumsum(hist[order])
    keep_n = int(np.searchsorted(csum, 0.9 * A.nnz) + 1)
    dense_n = int((hist[order] >= 0.1 * n).sum())
    order = order[:max(keep_n, dense_n, 1)]
    # symmetric completion: keep offsets in +/- pairs so the banded part
    # of a structurally symmetric matrix stays symmetric
    mirror = 2 * n - order
    extra = mirror[(hist[mirror] > 0) & ~np.isin(mirror, order)]
    if extra.size:
        order = np.concatenate([order, extra])
    covered = int(hist[order].sum())
    if (len(order) == 0 or covered < _BEST_MIN_COVERAGE * A.nnz
            or len(order) * n > _BEST_FILL_LIMIT * A.nnz):
        return device_operator(A, dtype=npdt)
    keep_offs = np.sort(order.astype(np.int64) - n)
    nrem = A.nnz - covered
    pad = _round_up(max(nrem, 1), _COO_PAD_ALIGN)
    nat = native.dia_split(A, keep_offs, npdt, nrem, pad) \
        if rows is None else None
    if nat is not None:
        bands, r_rows, r_cols, r_vals = nat
    else:
        if rows is None:
            rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
            off = A.indices.astype(np.int64) - rows
        slot_arr = np.full(2 * n + 1, -1, dtype=np.int32)
        slot_arr[keep_offs + n] = np.arange(len(keep_offs), dtype=np.int32)
        slots = slot_arr[off + n]
        inband = slots >= 0
        bands = np.zeros((len(keep_offs), n), dtype=npdt)
        bands[slots[inband], rows[inband]] = A.data[inband]
        r_rows = np.full(pad, n, dtype=np.int32)
        r_cols = np.zeros(pad, dtype=np.int32)
        r_vals = np.zeros(pad, dtype=npdt)
        if nrem:
            outb = ~inband
            r_rows[:nrem] = rows[outb]
            r_cols[:nrem] = A.indices[outb]
            r_vals[:nrem] = A.data[outb]
    if nrem == 0:
        # fully banded: a grid-detectable level becomes the factored
        # stencil, which applies through the CUDA stencil kernel
        from ..precond.amg.band_algebra import BandMatrix
        from ..precond.amg.structured import detect_dims
        dims = detect_dims(keep_offs, n)
        if dims is not None and len(dims) > 1:
            B = BandMatrix.from_flat(keep_offs, bands, tuple(dims))
            if B is not None:
                st = B.to_stencil_operator(npdt)
                if st.device_bytes <= bands.nbytes // 2:
                    return st
    # constant-band compression; in f32 near-constant bands demote their
    # few non-modal entries (boundary rows) into the COO remainder.  The
    # apply stays exact; f64 keeps bit-strict bands.
    demote = npdt == np.float32
    if demote:
        cc, e_rows, e_cols, e_vals = _const_compress_dia(
            bands, keep_offs, n, npdt, demote=True)
    else:
        cc = _const_compress_dia(bands, keep_offs, n, npdt)
        e_rows = np.zeros(0, np.int64)
        e_cols = e_rows
        e_vals = np.zeros(0, npdt)
    dia = cc or DiaOperator(as_tensor(bands), keep_offs, n)
    total_rem = nrem + int(e_rows.size)
    if total_rem == 0:
        return dia
    if e_rows.size:
        pad2 = _round_up(total_rem, _COO_PAD_ALIGN)
        m_rows = np.full(pad2, n, dtype=np.int32)
        m_cols = np.zeros(pad2, dtype=np.int32)
        m_vals = np.zeros(pad2, dtype=npdt)
        m_rows[:nrem] = r_rows[:nrem]
        m_cols[:nrem] = r_cols[:nrem]
        m_vals[:nrem] = r_vals[:nrem]
        m_rows[nrem:total_rem] = e_rows
        m_cols[nrem:total_rem] = e_cols
        m_vals[nrem:total_rem] = e_vals
        r_rows, r_cols, r_vals = m_rows, m_cols, m_vals
    rem = CooOperator(as_tensor(r_rows), as_tensor(r_cols), as_tensor(r_vals),
                      n, n)
    return HybridDiaOperator(dia, rem)


def _const_compress_dia(bands: np.ndarray, offs, n: int, dtype,
                        demote: bool = False):
    """Split DIA bands into constant (scalar x bitmask) and full parts.

    A band compresses when every nonzero equals one value, so the apply
    is bit-identical to the full band.  Returns a ConstDiaOperator /
    SumOperator(const, full) when at least ``_CONST_MIN_BANDS`` bands
    compress (and n >= ``_CONST_MIN_N``), else None.

    ``demote=True`` also compresses near-constant bands: the few
    non-modal entries leave the mask and come back as extra COO triples,
    so the apply stays exact.  The return value is then
    ``(op_or_None, extra_rows, extra_cols, extra_vals)``."""
    npdt = np_dtype(dtype)
    extras = ([], [], [])
    if n < _CONST_MIN_N:
        return (None, *map(np.asarray, extras)) if demote else None
    const_k, full_k = [], []
    for k in range(bands.shape[0]):
        band = bands[k]
        nzidx = np.flatnonzero(band)
        if nzidx.size == 0:
            const_k.append((k, 0.0, band != 0))
            continue
        # candidate constant = mode of a sample (the first nonzero is
        # often an atypical boundary row), then verify every entry, in
        # the target dtype (f64 Galerkin noise around a constant vanishes
        # under the f32 cast)
        sample = band[nzidx[:: max(1, nzidx.size // 512)]]
        v, c = np.unique(sample, return_counts=True)
        v0 = v[c.argmax()]
        if v0 == 0.0:
            full_k.append(k)
            continue
        exc = nzidx[band[nzidx] != v0]
        if exc.size == 0:
            const_k.append((k, float(v0), band != 0))
        elif demote and exc.size <= max(0.05 * nzidx.size, 32):
            mask = np.zeros(n, dtype=bool)
            mask[nzidx] = True
            mask[exc] = False
            const_k.append((k, float(v0), mask))
            extras[0].append(exc)
            extras[1].append(exc + int(offs[k]))
            extras[2].append(band[exc])
        else:
            full_k.append(k)

    def _ex():
        if not extras[0]:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, npdt))
        return (np.concatenate(extras[0]), np.concatenate(extras[1]),
                np.concatenate(extras[2]))

    if len(const_k) < _CONST_MIN_BANDS:
        # no compression: the caller keeps the full bands, which still
        # hold any would-be-demoted entries, so the extras are dropped
        if demote:
            return (None, np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, npdt))
        return None
    consts = np.array([c for _, c, _ in const_k], dtype=npdt)
    masks = np.stack([pack_bits(m) for _, _, m in const_k])
    cop = ConstDiaOperator(as_tensor(consts), as_tensor(masks),
                           [int(offs[k]) for k, _, _ in const_k], n)
    if not full_k:
        return (cop, *_ex()) if demote else cop
    fop = DiaOperator(as_tensor(bands[full_k]),
                      [int(offs[k]) for k in full_k], n)
    out = SumOperator([cop, fop])
    return (out, *_ex()) if demote else out


def device_operator(A, dtype=None, prefer: Optional[str] = None):
    """The operator for a host matrix: block-ELL for a BSR matrix; for a
    CSR matrix dense when tiny, DIA when banded, ELL when rows are
    regular, COO otherwise.  ``prefer`` ("dense", "ell" or "coo") forces
    a CSR format."""
    if isinstance(A, BSRMatrix):
        return BsrEllOperator.from_bsr(A, dtype=dtype)
    if not isinstance(A, CSRMatrix):
        raise TypeError(f"cannot build device operator from {type(A)}")
    if prefer == "coo":
        return CooOperator.from_csr(A, dtype=dtype)
    if prefer == "dense" or (prefer is None and A.nrow <= 256):
        return DenseOperator.from_csr(A, dtype=dtype)
    if prefer is None and dia_fill_ok(A):
        return DiaOperator.from_csr(A, dtype=dtype)
    ell = EllOperator.from_csr(A, dtype=dtype)
    if prefer == "ell" or ell.padding_ratio(A.nnz) <= _ELL_PADDING_LIMIT:
        return ell
    return CooOperator.from_csr(A, dtype=dtype)
