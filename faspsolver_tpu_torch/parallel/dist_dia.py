"""Distributed banded (DIA) operators and sharded AMG hierarchies (port of
``faspsolver_tpu/parallel/dist_dia.py``).

A banded SpMV reads at most ``max|offset|`` entries across each shard
boundary, so the row-split DIA apply takes its halo from the two
neighbouring ranks (``halo.halo_dia_apply``: P2P sends, no gather of the
vector); the JAX package gets the same neighbour exchange from GSPMD
(collective-permute).  Krylov reductions are one all-reduce each.

:func:`shard_hierarchy` places an AMG hierarchy on the mesh with the JAX
package's rule, applied level by level: a level whose size is at least
``min_size`` and divides the mesh size is sharded (its vectors are
``Shard(0)`` DTensors), every other level is replicated (held whole by
every rank as plain tensors, the analog of the reference gathering the
coarse grid into one serial solve, PreMGCycle.c:156-202).  On a sharded
level:

- a ``DiaOperator``'s bands are split by columns (``Shard(1)``) and its
  apply exchanges halos; a 2-D ``StencilNdOperator`` keeps its type and
  applies through the stencil kernel on the local rows (at one rank the
  local rows are the whole level; at more it first takes the grid rows
  on either side of its slab from its neighbours); any other operator
  gathers x and keeps its own rows;
- the smoothers' vectors (``dinv``, the red-black masks) become DTensors,
  so the sweeps run unchanged; a Gauss-Seidel (or block, or
  preconditioner) smoother sweeps the gathered vector;
- a transfer between levels is applied by the rule of its two layouts:
  sharded to whole sums every rank's part (an all-reduce of the coarse
  vector), whole to sharded keeps the rank's rows, sharded to sharded
  sums and keeps the rank's rows; the smoothed transfers of the
  structured setup compose the level's own operator and stay as they
  are around the placed pieces.
"""
from __future__ import annotations

import copy
import weakref

import numpy as np
import torch.distributed as dist
from torch import nn

from .. import as_tensor, is_dtensor, np_dtype
from ..formats import CSRMatrix
from ..ops.operators import (DiaOperator, FactoredBand, StencilNdOperator,
                             dia_bands_from_csr)
from ..precond.amg.smoothers import PrecondSmoother, SmootherData, smooth
from ..precond.amg.structured import SmoothedProlong, SmoothedRestrict
from .comm import (exchange, mesh_device, replicated, sharded, slab, split,
                   whole)


def dist_dia_operator(A: CSRMatrix, mesh, dtype=None, axis: str = "rows"
                      ) -> DiaOperator:
    """Row-split DIA operator from a host matrix; rows are padded with
    zero rows to a multiple of the mesh size.  Its apply on a sharded
    vector exchanges halos with the neighbouring ranks."""
    offsets, bands = dia_bands_from_csr(A)
    n = A.nrow
    nsh = mesh.size()
    target = ((n + nsh - 1) // nsh) * nsh
    if target != n:
        bands = np.pad(bands, ((0, 0), (0, target - n)))
    dev = as_tensor(bands, np_dtype(dtype), mesh_device(mesh))
    op = DiaOperator(dev, tuple(int(o) for o in offsets), target)
    op.register_buffer("bands", split(dev, mesh, dim=1))
    return op


# ---------------------------------------------------------------------------
# the 2-D stencil kernel on a sharded vector
# ---------------------------------------------------------------------------

# per operator: (world size, rank) -> (sub-operator over the rank's rows
# and one grid row on either side, its first grid row)
_ROWS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _row_band(b, lo: int, hi: int, d0: int):
    if isinstance(b, FactoredBand):
        if b.row_sel.shape[0] == d0 and d0 > 1:
            return FactoredBand(b.row_sel[lo:hi], b.core, b.col_sel)
        return b
    return b[lo:hi] if (b.shape[0] == d0 and d0 > 1) else b


def stencil_apply(op: StencilNdOperator, x):
    """y = A x for a stencil level on a sharded vector.  At one rank the
    local vector is the whole level and goes through the kernel as it
    is; at more, each rank applies the kernel to its own grid rows and
    one row on either side, whose x it takes from its neighbours (the
    ``d1 + 1`` entries the stencil reads across its slab's edges)."""
    mesh = x.device_mesh
    n = op.n
    xl = x.to_local()
    if mesh.size() == 1:
        return sharded(op(xl), mesh, n)
    d0, d1 = op.dims if len(op.dims) == 2 else (0, 0)
    h = d1 + 1
    if not op._kernel or h > xl.shape[0]:
        # a stencil the 2-D kernel does not take (3-D, wider offsets),
        # or a slab thinner than its halo: gather x, keep the own rows
        lo, hi = slab(mesh, n)
        return sharded(op(whole(x))[lo:hi], mesh, n)
    start, end = slab(mesh, n)
    key = (mesh.size(), mesh.get_local_rank())
    cached = _ROWS.get(op)
    if cached is None or cached[0] != key:
        lo = max(start // d1 - 1, 0)
        hi = min((end - 1) // d1 + 1, d0 - 1) + 1
        sub = StencilNdOperator([_row_band(b, lo, hi, d0) for b in op.bands],
                                op.coords, (hi - lo, d1))
        cached = (key, sub, lo)
        _ROWS[op] = cached
    _, sub, lo = cached
    from_left, from_right = exchange(mesh, xl[:h], xl[-h:])
    base = lo * d1
    xe = xl.new_zeros(sub.n)
    xe[start - base:end - base] = xl
    a = max(start - h, base)
    xe[a - base:start - base] = from_left[h - (start - a):]
    b = min(end + h, base + sub.n)
    xe[end - base:b - base] = from_right[:b - end]
    return sharded(sub(xe)[start - base:end - base], mesh, n)


# ---------------------------------------------------------------------------
# pieces of a placed hierarchy
# ---------------------------------------------------------------------------

class OnWhole(nn.Module):
    """Any module applied to the whole vector on every rank: a sharded
    input is gathered, the output kept sharded (``shard_out``) or whole.
    The placement of operators and coarse solvers that no other rule
    takes."""

    def __init__(self, inner, mesh, n_out: int, shard_out: bool):
        super().__init__()
        self.inner = inner
        self.mesh = mesh
        self.n_out = int(n_out)
        self.shard_out = bool(shard_out)

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    def forward(self, x):
        y = self.inner(whole(x))
        if not self.shard_out:
            return y
        lo, hi = slab(self.mesh, self.n_out)
        return sharded(y[lo:hi], self.mesh, self.n_out)


class PlacedTransfer(nn.Module):
    """A linear transfer between two levels, by the rule of their
    layouts (``shard_in``, ``shard_out``): a sharded input is applied as
    this rank's part (the other rows zero) and the parts are summed (an
    all-reduce of the output); a whole input is applied on every rank;
    a sharded output keeps this rank's rows."""

    def __init__(self, inner, mesh, n_in: int, n_out: int, shard_in: bool,
                 shard_out: bool):
        super().__init__()
        self.inner = inner
        self.mesh = mesh
        self.n_in, self.n_out = int(n_in), int(n_out)
        self.shard_in, self.shard_out = bool(shard_in), bool(shard_out)

    @property
    def shape(self):
        return self.inner.shape

    def forward(self, x):
        mesh = self.mesh
        if self.shard_in and mesh.size() > 1:
            lo, hi = slab(mesh, self.n_in)
            part = x.to_local().new_zeros(self.n_in)
            part[lo:hi] = x.to_local()
            y = self.inner(part)
            dist.all_reduce(y, group=mesh.get_group())
        else:
            y = self.inner(x.to_local() if is_dtensor(x) else x)
        if not self.shard_out:
            return y
        lo, hi = slab(mesh, self.n_out)
        return sharded(y[lo:hi], mesh, self.n_out)


class WholeSmoother(PrecondSmoother):
    """A smoother whose sweeps need the whole vector (multicolor
    Gauss-Seidel gathers rows across the level, a block or
    preconditioner smoother likewise): x and b are gathered, the sweeps
    run on the level's unplaced operator, and each rank keeps its rows."""

    def __init__(self, sm, A_whole, mesh, n: int):
        super().__init__(None)
        self.sm = sm
        self.A_whole = A_whole
        self.mesh = mesh
        self.n = int(n)

    def smooth(self, A, x, b, nsweeps: int, forward: bool):
        y = smooth(self.sm, self.A_whole, whole(x), whole(b), nsweeps,
                   forward)
        lo, hi = slab(self.mesh, self.n)
        return sharded(y[lo:hi], self.mesh, self.n)


def _place_vectors(mod: nn.Module, mesh, n: int) -> None:
    """A sweep's or a smoothed transfer's vectors as DTensors: those of
    the level's length split by rows, the others (a constant vector
    stored as one entry) replicated."""
    for name, t in list(mod._buffers.items()):
        if t is None or is_dtensor(t):
            continue
        if t.dim() >= 1 and t.shape[-1] == n:
            mod._buffers[name] = split(t, mesh, dim=t.dim() - 1)
        else:
            mod._buffers[name] = replicated(t, mesh)


def _place_operator(op, mesh, n: int, done: dict):
    """The sharded-level form of a level operator (one object for every
    reference to it; the original is left as it was)."""
    if id(op) in done:
        return done[id(op)]
    if isinstance(op, DiaOperator):
        # a new module: a coarse solver may still apply the original to
        # a whole vector
        out = DiaOperator(op.bands, op.offsets, op.n)
        out.register_buffer("bands", split(op.bands, mesh, dim=1))
    elif isinstance(op, StencilNdOperator):
        out = op
    else:
        out = OnWhole(op, mesh, n, True)
    done[id(op)] = out
    return out


def _place_transfer(T, mesh, sizes, sharded_in, sharded_out, done):
    """The placed form of a level's P (or R): a smoothed transfer keeps
    its composition around placed pieces, any other is placed whole."""
    if isinstance(T, (SmoothedProlong, SmoothedRestrict)):
        n_fine = T.A.shape[0]
        if sharded_in or sharded_out:
            fine_sharded = (sharded_out if isinstance(T, SmoothedProlong)
                            else sharded_in)
            if fine_sharded:
                T.A = _place_operator(T.A, mesh, n_fine, done)
                _place_vectors(T, mesh, n_fine)
            inner_in, inner_out = (
                (sharded_in, fine_sharded) if isinstance(T, SmoothedProlong)
                else (fine_sharded, sharded_out))
            T.base = PlacedTransfer(T.base, mesh, sizes[0], sizes[1],
                                    inner_in, inner_out)
        return T
    if not (sharded_in or sharded_out):
        return T
    return PlacedTransfer(T, mesh, sizes[0], sizes[1], sharded_in,
                          sharded_out)


def shard_hierarchy(hier, mesh, axis: str = "rows", min_size: int = 8192):
    """A copy of an AMG hierarchy placed on the mesh: every level of at
    least ``min_size`` rows that divides the mesh size sharded, the
    others replicated (module docstring).  Works for any problem size;
    odd-shaped levels just do not scale out.  The copy records each
    level's layout in ``sharded_levels``."""
    if getattr(hier, "sharded_levels", None) is not None:
        raise ValueError("the hierarchy is placed already")
    nsh = mesh.size()
    out = copy.deepcopy(hier).to(mesh_device(mesh))
    sizes = [lvl.A.shape[0] for lvl in out.levels]
    placed = [n >= min_size and n % nsh == 0 for n in sizes]
    done: dict = {}
    for l, lvl in enumerate(out.levels):
        n = sizes[l]
        if not placed[l]:
            continue
        sm = lvl.smoother
        if isinstance(sm, SmootherData) and not len(sm.colors):
            _place_vectors(sm, mesh, n)
        elif sm is not None:
            lvl.smoother = WholeSmoother(
                sm, lvl.A if lvl.Asm is None else lvl.Asm, mesh, n)
        lvl.A = _place_operator(lvl.A, mesh, n, done)
        if lvl.Asm is not None:
            lvl.Asm = _place_operator(lvl.Asm, mesh, n, done)
        if lvl.nk is not None:
            lvl.nk = OnWhole(lvl.nk, mesh, n, True)
    for l, lvl in enumerate(out.levels[:-1]):
        if lvl.P is not None:
            lvl.P = _place_transfer(lvl.P, mesh, (sizes[l + 1], sizes[l]),
                                    placed[l + 1], placed[l], done)
        if lvl.R is not None:
            lvl.R = _place_transfer(lvl.R, mesh, (sizes[l], sizes[l + 1]),
                                    placed[l], placed[l + 1], done)
    if placed[-1]:
        out.coarse = OnWhole(out.coarse, mesh, sizes[-1], True)
    out.sharded_levels = tuple(placed)
    return out
