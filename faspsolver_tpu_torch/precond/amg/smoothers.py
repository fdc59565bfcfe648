"""Multigrid smoothers (port of ``faspsolver_tpu/precond/amg/smoothers.py``:
the Jacobi family, the multicolor Gauss-Seidel family, RBGS, Chebyshev,
``PrecondSmoother``, ``build_smoother`` for general CSR levels and
``kaczmarz_sweep``).

Reference: base/src/ItrSmootherCSR.c (jacobi :98, gs :251, gs_cf :432,
sgs :808, sor :932, L1DIAG, kaczmarz :1363), ItrSmootherCSRpoly.c
(polynomial).  Gauss-Seidel runs as multicolor GS, the reference's own
OpenMP strategy (fasp_smoother_dcsr_gs_multicolor): each color's rows
are gathered at setup into an ELL block (``ColorBlock``), so a sweep is
one gather, row sum and scatter per color.  A row of up to 8 stored
entries sums left to right (``row_sum``), the order of the reference's
row loop and of the JAX package's sum on the CPU, on every device.
C/F-ordered smoothing colors
the C points and the F points apart and visits the C colors first
(forward) or last (backward).  The Chebyshev recurrence scalars are
fixed by ``lambda_max`` and the degree, so they are computed once, at
construction, as Python floats — in the level's precision, the same
roundings the JAX package's traced scalar arithmetic makes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import as_tensor, np_dtype
from ...constants import SmootherType
from ...formats import CSRMatrix
from ...utils import messages
from ...utils.graphs import capturable

_GS_KINDS = (SmootherType.GS, SmootherType.SGS, SmootherType.SOR,
             SmootherType.SSOR, SmootherType.GSOR, SmootherType.SGSOR,
             SmootherType.GSF)
_SYMMETRIC_GS = (int(SmootherType.SGS), int(SmootherType.SSOR),
                 int(SmootherType.SGSOR))


# rows up to this many stored entries are summed in a fixed order
_ORDERED_WIDTH = 8


def row_sum(p: torch.Tensor) -> torch.Tensor:
    """Row sums of a (rows, k) block.  Rows of up to ``_ORDERED_WIDTH``
    entries (a grid's fine and first coarse levels) add left to right on
    every device, the order of the reference's row loop and of the JAX
    package's sum on the CPU.  ``p.sum(dim=1)`` lets the device choose:
    torch's CUDA reduction adds a 4-entry row as (p0 + p2) + (p1 + p3),
    and the f32 refined mode on a 1023^2 Poisson grid, whose second round
    works at its f32 residual floor, stalls there with that rounding
    (``tools/f32_refine_probe.py``).  Wider rows (coarse levels: up to
    ~1,650 entries at 101^3) keep the one-launch sum, as a loop costs a
    launch per column."""
    if p.shape[1] > _ORDERED_WIDTH:
        return p.sum(dim=1)
    s = p[:, 0]
    for k in range(1, p.shape[1]):
        s = s + p[:, k]
    return s


def _opt(a) -> Optional[torch.Tensor]:
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a, copy=True))


def cheby_scalars(lambda_max, degree: int):
    """(theta, [(c1, c2) per later step]) of the Chebyshev recurrence on
    [lambda_max/4, lambda_max], computed in lambda_max's dtype."""
    lmax = np.asarray(lambda_max)
    t = lmax.dtype.type
    lmax = t(lmax)
    lmin = lmax / t(4.0)
    theta = (lmax + lmin) / t(2.0)
    delta = (lmax - lmin) / t(2.0)
    sigma1 = theta / delta
    rho = t(1.0) / sigma1
    steps = []
    for _ in range(degree - 1):
        rho_new = t(1.0) / (t(2.0) * sigma1 - rho)
        steps.append((float(rho_new * rho), float(t(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), steps


class ColorBlock(nn.Module):
    """One color's rows in row-gathered ELL form, diagonal excluded:
    ``rows`` (nc,) int64, ``cols`` (nc, k) int32, ``vals`` (nc, k) and
    ``dinv`` (nc,) = 1/a_ii of those rows."""

    def __init__(self, rows, cols, vals, dinv):
        super().__init__()
        self.register_buffer("rows", _opt(rows).to(torch.int64))
        self.register_buffer("cols", _opt(cols))
        self.register_buffer("vals", _opt(vals))
        self.register_buffer("dinv", _opt(dinv))

    def offdiag(self, x: torch.Tensor) -> torch.Tensor:
        """Row sums of the stored off-diagonal entries times x."""
        g = x.index_select(0, self.cols.reshape(-1)).reshape(self.cols.shape)
        return row_sum(self.vals * g)


class SmootherData(nn.Module):
    """What one level's sweeps need.  ``kind`` selects the sweep."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, kind: int, relax: float, nsweep_scale: int,
                 dinv=None, l1inv=None, lambda_max=None,
                 rb_masks: Sequence = (), colors: Sequence = ()):
        super().__init__()
        self.kind = int(kind)
        self.relax = float(relax)
        self.nsweep_scale = int(nsweep_scale)
        self.colors = nn.ModuleList(colors)
        self.register_buffer("dinv", _opt(dinv))
        self.register_buffer("l1inv", _opt(l1inv))
        red, black = (tuple(rb_masks) if rb_masks else (None, None))
        self.register_buffer("rb_red", _opt(red))
        self.register_buffer("rb_black", _opt(black))
        self.lambda_max = (None if lambda_max is None
                           else np.asarray(lambda_max)[()])
        if self.kind == SmootherType.CHEBYSHEV:
            self.theta, self.cheby_steps = cheby_scalars(
                self.lambda_max, self.nsweep_scale)

    @property
    def rb_masks(self):
        if self.rb_red is None:
            return ()
        return (self.rb_red, self.rb_black)


class PrecondSmoother(nn.Module):
    """Any preconditioner as a multigrid smoother: x <- x + M(b - A x)
    per sweep.  This is how the reference applies ILU and Schwarz as
    smoothers on the finest AMG levels (ILU_levels / SWZ_levels,
    PreAMGSetupRS.c:131-155; cycle priority ILU > Schwarz > standard,
    PreMGCycle.c:100-133)."""

    @property
    def capturable(self) -> bool:
        return capturable(self.M)

    def __init__(self, M):
        super().__init__()
        self.M = M

    def smooth(self, A, x, b, nsweeps: int, forward: bool):
        for _ in range(nsweeps):
            x = x + self.M(b - A(x))
        return x


def _ell_rows(A: CSRMatrix, rows: np.ndarray, dtype, drop_diag=True):
    """Gather selected rows of A into a dense (len(rows), k) ELL block."""
    sub = A.to_scipy()[rows, :].tocsr()
    if drop_diag:
        rr = np.repeat(np.arange(len(rows)), np.diff(sub.indptr))
        sub.data[sub.indices == np.asarray(rows)[rr]] = 0.0
        sub.eliminate_zeros()
    nnz_per_row = np.diff(sub.indptr)
    k = max(int(nnz_per_row.max()) if len(rows) else 0, 1)
    cols = np.zeros((len(rows), k), dtype=np.int32)
    vals = np.zeros((len(rows), k), dtype=np.dtype(dtype))
    if sub.nnz:
        rr = np.repeat(np.arange(len(rows)), nnz_per_row)
        slot = np.arange(sub.nnz) - np.repeat(sub.indptr[:-1], nnz_per_row)
        cols[rr, slot] = sub.indices
        vals[rr, slot] = sub.data
    return cols, vals


def _color_rows(A: CSRMatrix, cf_marker: Optional[np.ndarray]):
    """The row set of each color block in visit order: the colors of A,
    or with a C/F marker the colors of the C block, then of the F
    block."""
    if cf_marker is None:
        colors, counts = A.multicolor()
        return [np.nonzero(colors == c)[0] for c in range(len(counts))]
    blocks = []
    for part in (np.nonzero(cf_marker >= 1)[0], np.nonzero(cf_marker < 1)[0]):
        if len(part) == 0:
            continue
        sub_colors = (A.get_block(part, part).multicolor()[0]
                      if len(part) > 1 else np.zeros(1, dtype=np.int64))
        for c in range(int(sub_colors.max()) + 1):
            rows = part[sub_colors == c]
            if len(rows):
                blocks.append(rows)
    return blocks


def build_smoother(A: CSRMatrix, kind: int, *, relax: float = 1.0,
                   poly_degree: int = 3,
                   cf_marker: Optional[np.ndarray] = None,
                   dtype=None) -> SmootherData:
    """Smoother data for a general CSR level (host setup).  ``cf_marker``
    (C >= 1) orders the Gauss-Seidel colors C first."""
    npdt = np_dtype(dtype)
    d = A.diagonal()
    dsafe = np.where(d != 0.0, d, 1.0)
    dinv_np = 1.0 / dsafe
    # constant vectors ship as (1,) and broadcast in the sweeps
    dinv = (dinv_np[:1] if dinv_np.size and np.all(dinv_np == dinv_np[0])
            else dinv_np)
    dinv = as_tensor(dinv, npdt)
    kind = int(kind)
    if kind in (SmootherType.BLKOIL, SmootherType.SPETEN,
                SmootherType.CPRGS, SmootherType.CPTRGS):
        # reservoir smoother ids (fasp_const.h:204-208): the reference
        # only parses these in-tree (AuxInput.c:652-658); map to GS so
        # configs written for the reservoir build still run
        messages.warn(f"reservoir smoother id {kind} "
                      f"({SmootherType(kind).name}) has no in-tree "
                      f"implementation in the reference either; mapping to "
                      f"GS")
        kind = int(SmootherType.GS)
    if kind in (SmootherType.JACOBI, SmootherType.JACOBIF):
        return SmootherData(int(SmootherType.JACOBI), relax, 1, dinv=dinv)
    if kind == SmootherType.L1DIAG:
        l1 = np.asarray(np.abs(A.to_scipy()).sum(axis=1)).ravel()
        l1 = np.where(l1 != 0.0, l1, 1.0)
        return SmootherData(kind, relax, 1, l1inv=as_tensor(1.0 / l1, npdt))
    if kind in _GS_KINDS:
        blocks = []
        for rows in _color_rows(A, cf_marker):
            cols, vals = _ell_rows(A, rows, npdt)
            blocks.append(ColorBlock(as_tensor(rows.astype(np.int64)),
                                     as_tensor(cols), as_tensor(vals),
                                     as_tensor(1.0 / dsafe[rows], npdt)))
        return SmootherData(kind, relax, 1, dinv=dinv, colors=blocks)
    if kind in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        # Chebyshev on [lambda_max/4, lambda_max] of D^-1 A; lambda_max by
        # a seeded 30-step power iteration (reference: fasp_dcsr_maxeig,
        # BlaEigen.c), or above 200k dof by the Gershgorin bound, which
        # is always an upper bound, so Chebyshev stays a damper
        if A.nrow > 200_000:
            rl = np.diff(A.indptr)
            if A.nnz and rl.min() > 0:
                l1 = np.add.reduceat(np.abs(A.data), A.indptr[:-1])
            else:
                l1 = np.asarray(np.abs(A.to_scipy()).sum(axis=1)).ravel()
            lam = float(np.max(np.abs(dinv_np) * l1))
        else:
            m = A.to_scipy()
            v = np.random.default_rng(0).standard_normal(A.nrow)
            lam = 1.0
            for _ in range(30):
                w = dinv_np * (m @ v)
                lam = max(np.linalg.norm(w), 1e-30)
                v = w / lam
            # inflate: an underestimate makes Chebyshev amplify the top
            # of the spectrum instead of damping it
            lam = max(lam, 1e-8) * 1.1
        return SmootherData(int(SmootherType.CHEBYSHEV), relax, poly_degree,
                            dinv=dinv, lambda_max=np.asarray(lam, npdt))
    raise ValueError(f"unsupported smoother kind {kind}")


def _color_sweep(sm: SmootherData, x, b, order):
    """One multicolor GS/SOR sweep; ``order`` = color visit order.  Each
    color writes its rows into a new tensor (``index_copy`` out of
    place), never into the caller's x."""
    w = sm.relax
    for ci in order:
        blk = sm.colors[ci]
        xn = blk.dinv * (b.index_select(0, blk.rows) - blk.offdiag(x))
        if w != 1.0:
            xr = x.index_select(0, blk.rows)
            xn = xr + w * (xn - xr)
        x = x.index_copy(0, blk.rows, xn)
    return x


def smooth(sm: SmootherData, A, x, b, nsweeps: int, forward: bool):
    """Apply ``nsweeps`` smoothing sweeps.  ``forward`` orders the
    Gauss-Seidel colors and the red-black sweeps so pre/post smoothing
    are adjoint (reference: PreMGSmoother.inl:20-230).  Block (BSR)
    smoother data goes to the block sweeps, a ``PrecondSmoother`` to its
    preconditioner."""
    from .bsr_smoothers import BsrSmootherData, bsr_smooth
    if isinstance(sm, BsrSmootherData):
        return bsr_smooth(sm, A, x, b, nsweeps, forward)
    if isinstance(sm, PrecondSmoother):
        return sm.smooth(A, x, b, nsweeps, forward)
    kind = sm.kind
    for _ in range(nsweeps):
        if kind == SmootherType.JACOBI:
            x = x + sm.relax * sm.dinv * (b - A(x))
        elif kind == SmootherType.L1DIAG:
            x = x + sm.l1inv * (b - A(x))
        elif kind in _SYMMETRIC_GS:
            nc = len(sm.colors)
            x = _color_sweep(sm, x, b, range(nc))
            x = _color_sweep(sm, x, b, range(nc - 1, -1, -1))
        elif kind in (int(SmootherType.GS), int(SmootherType.SOR),
                      int(SmootherType.GSOR), int(SmootherType.GSF)):
            nc = len(sm.colors)
            x = _color_sweep(sm, x, b, range(nc) if forward
                             else range(nc - 1, -1, -1))
        elif kind == SmootherType.CHEBYSHEV:
            x = _cheby_smooth(sm, A, x, b)
        elif kind == SmootherType.RBGS:
            # exact red-black Gauss-Seidel as two masked full-stencil
            # updates (reference: ItrSmootherRBGS.inl)
            masks = sm.rb_masks if forward else sm.rb_masks[::-1]
            w = sm.relax
            for mask in masks:
                upd = sm.dinv * (b - A(x))
                x = x + (w * mask) * upd if w != 1.0 else x + mask * upd
        else:
            raise ValueError(f"unsupported smoother kind {kind}")
    return x


def _cheby_smooth(sm: SmootherData, A, x, b):
    """Chebyshev polynomial smoother of degree ``nsweep_scale`` on the
    Jacobi-scaled operator, damping [lambda_max/4, lambda_max]
    (reference: ItrSmootherCSRpoly.c fasp_smoother_dcsr_poly)."""
    r = sm.dinv * (b - A(x))
    d = r / sm.theta
    x = x + d
    for c1, c2 in sm.cheby_steps:
        r = sm.dinv * (b - A(x))
        d = c1 * d + c2 * r
        x = x + d
    return x


def kaczmarz_sweep(sm: SmootherData, A, x, b, omega: float = 0.5):
    """Color-batched Kaczmarz row-projection sweep (reference:
    fasp_smoother_dcsr_kaczmarz, ItrSmootherCSR.c:1363).  Within a color
    the rows are pairwise non-adjacent, so their projections apply at
    once (Cimmino within a color); overlapping projections of rows that
    share a column are why the default damping is 0.5.  Needs GS-style
    color blocks in ``sm``."""
    for blk in sm.colors:
        # the diagonal is not stored in the block: a_ii = 1 / dinv
        aii = 1.0 / blk.dinv
        ri = b.index_select(0, blk.rows) - blk.offdiag(x) \
            - aii * x.index_select(0, blk.rows)
        row_norm2 = row_sum(blk.vals * blk.vals) + aii * aii
        scale = omega * ri / row_norm2
        x = x.index_add(0, blk.rows, scale * aii)
        x = x.index_add(0, blk.cols.reshape(-1),
                        (scale[:, None] * blk.vals).reshape(-1))
    return x
