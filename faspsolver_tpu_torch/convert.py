"""Carry a hierarchy built by the JAX package across to the port.

``from_jax(obj)`` walks a ``faspsolver_tpu`` structured, classical RS,
SA, UA or BSR AMG hierarchy (or any of its parts: operators, transfers,
smoothers with their color blocks, near-kernel data, coarse solvers, an
``AMGPrecond``), an ILU, block ILU, Schwarz or block Jacobi
preconditioner, or an STR or BLC operator or preconditioner by class name and attribute access, reads every array
leaf with ``np.asarray``, and rebuilds the port's modules on the CPU with
the same dtypes.  What is shared in the JAX tree stays shared: arrays
(a dinv used by smoother and transfers) by identity, operators (a level's
A inside its smoothed transfers, which the JAX freeze rebuilds as
separate objects over the same arrays) by the identity of their arrays,
and a COO transfer pair keeps one set of arrays.
It never imports jax: the leaves convert through NumPy's array protocol.  The tests use it to run the port's cycle, PCG and refinement
on exactly the hierarchy the JAX package built.
"""
from __future__ import annotations

import numpy as np
import torch

from .krylov.precond import BlockJacobiPrecond, JacobiPrecond
from .ops.operators import (BsrEllOperator, ConstDiaOperator, CooOperator,
                            DenseOperator, DiaNdOperator, DiaOperator,
                            EllOperator, FactoredBand, HybridDiaOperator,
                            StencilNdOperator, SumOperator, block_ell_layout)
from .ops.str_ops import StrOperator
from .precond.amg.bsr_smoothers import BsrColorBlock, BsrSmootherData
from .precond.amg.hierarchy import (AMGHierarchy, AMGLevel, CoarseSolver,
                                    IterativeCoarseSolver, NearKernel)
from .precond.amg.smoothers import ColorBlock, PrecondSmoother, SmootherData
from .precond.amg.structured import (PairProlong, PairRestrict,
                                     SmoothedProlong, SmoothedRestrict)
from .precond.amg.transfer import (AggProlong, AggRestrict, BandedProlong,
                                   BandedRestrict, BlockAggProlong,
                                   BlockAggRestrict, CooProlong, CooRestrict)
from .precond.ilu import (BlockTriangularSolver, BSRILUPrecond, ILUPrecond,
                          TriangularSolver)
from .precond.blc_precond import BlcOperator, BlcPrecond, BlcSweepingPrecond
from .precond.preconditioners import AMGPrecond
from .precond.schwarz import SchwarzPrecond, _ColorGroup
from .precond.str_precond import (StrBlockGSPrecond, StrDiagPrecond,
                                  StrSchwarzSmoother)


def from_jax(obj):
    """The port's module (or tensor) for a JAX-package object."""
    return _Converter().conv(obj)


class _Converter:
    def __init__(self):
        self.memo = {}

    def arr(self, a):
        if a is None:
            return None
        key = id(a)
        if key not in self.memo:
            self.memo[key] = torch.from_numpy(np.array(np.asarray(a),
                                                       copy=True))
        return self.memo[key]

    @staticmethod
    def _key(obj):
        """Operators are identified by their arrays, other objects by
        themselves."""
        name = type(obj).__name__
        if name == "StencilNdOperator":
            return (name, obj.coords, obj.dims, tuple(
                (id(b.row_sel), id(b.core), id(b.col_sel))
                if type(b).__name__ == "FactoredBand" else id(b)
                for b in obj.bands))
        if name in ("DiaOperator", "DiaNdOperator"):
            return (name, id(obj.bands))
        if name == "DenseOperator":
            return (name, id(obj.mat))
        return id(obj)

    def conv(self, obj):
        if obj is None:
            return None
        key = self._key(obj)
        if key not in self.memo:
            name = type(obj).__name__
            build = getattr(self, "_" + name.lstrip("_"), None)
            if build is None:
                raise NotImplementedError(f"no port of {name}")
            self.memo[key] = build(obj)
        return self.memo[key]

    # -- operators ---------------------------------------------------------

    def _DiaOperator(self, o):
        return DiaOperator(self.arr(o.bands), o.offsets, o.n)

    def _DiaNdOperator(self, o):
        return DiaNdOperator(self.arr(o.bands), o.coords, o.dims)

    def _DenseOperator(self, o):
        return DenseOperator(self.arr(o.mat), o.n)

    def _FactoredBand(self, o):
        return FactoredBand(self.arr(o.row_sel), self.arr(o.core),
                            self.arr(o.col_sel))

    def _StencilNdOperator(self, o):
        bands = [self.conv(b) if type(b).__name__ == "FactoredBand"
                 else self.arr(b) for b in o.bands]
        return StencilNdOperator(bands, o.coords, o.dims)

    def _EllOperator(self, o):
        return EllOperator(self.arr(o.cols), self.arr(o.vals), o.n, o.ncol)

    def _CooOperator(self, o):
        return CooOperator(self.arr(o.rows), self.arr(o.cols),
                           self.arr(o.vals), o.n, o.ncol)

    def _ConstDiaOperator(self, o):
        return ConstDiaOperator(self.arr(o.consts), self.arr(o.masks),
                                o.offsets, o.n)

    def _SumOperator(self, o):
        return SumOperator([self.conv(p) for p in o.parts])

    def _HybridDiaOperator(self, o):
        return HybridDiaOperator(self.conv(o.dia), self.conv(o.rem))

    def _BsrEllOperator(self, o):
        return BsrEllOperator(self.arr(o.cols), self.arr(o.vals), o.nbrow,
                              o.nbcol, o.nb)

    # -- transfers ---------------------------------------------------------

    def _BlockAggProlong(self, o):
        return BlockAggProlong(self.arr(o.agg), o.n_fine, o.n_coarse, o.nb)

    def _BlockAggRestrict(self, o):
        return BlockAggRestrict(self.arr(o.agg), o.n_fine, o.n_coarse, o.nb)

    def _PairRestrict(self, o):
        return PairRestrict(o.steps, o.n_fine, o.n_coarse)

    def _PairProlong(self, o):
        return PairProlong(o.steps, o.n_fine, o.n_coarse)

    def _SmoothedProlong(self, o):
        return SmoothedProlong(self.conv(o.A), self.arr(o.dinv),
                               self.conv(o.base), o.omega)

    def _SmoothedRestrict(self, o):
        return SmoothedRestrict(self.conv(o.A), self.arr(o.dinv),
                                self.conv(o.base), o.omega)

    def _coo(self, cls, o):
        return cls(self.arr(o.rows), self.arr(o.cols), self.arr(o.vals),
                   o.n_fine, o.n_coarse)

    def _CooProlong(self, o):
        return self._coo(CooProlong, o)

    def _CooRestrict(self, o):
        return self._coo(CooRestrict, o)

    def _banded(self, cls, o):
        return cls(self.arr(o.fpos), self.arr(o.w), self.arr(o.rem_rows),
                   self.arr(o.rem_cols), self.arr(o.rem_vals), o.shifts,
                   o.n_fine, o.n_coarse, o.has_rem, wc=self.arr(o.wc),
                   wm=self.arr(o.wm), const_mode=o.const_mode)

    def _BandedProlong(self, o):
        return self._banded(BandedProlong, o)

    def _BandedRestrict(self, o):
        return self._banded(BandedRestrict, o)

    # -- smoothers, coarse solvers, hierarchy -------------------------------

    def _AggProlong(self, o):
        return AggProlong(self.arr(o.agg), o.n_fine, o.n_coarse)

    def _AggRestrict(self, o):
        return AggRestrict(self.arr(o.agg), o.n_fine, o.n_coarse)

    def _ColorBlock(self, o):
        return ColorBlock(self.arr(o.rows), self.arr(o.cols),
                          self.arr(o.vals), self.arr(o.dinv))

    def _SmootherData(self, o):
        lam = None if o.lambda_max is None else np.asarray(o.lambda_max)
        return SmootherData(o.kind, o.relax, o.nsweep_scale,
                            dinv=self.arr(o.dinv), l1inv=self.arr(o.l1inv),
                            lambda_max=lam,
                            rb_masks=tuple(self.arr(m) for m in o.rb_masks),
                            colors=[self.conv(c) for c in o.colors])

    def _CoarseSolver(self, o):
        return CoarseSolver(self.arr(o.inv))

    def _IterativeCoarseSolver(self, o):
        return IterativeCoarseSolver(self.conv(o.A), self.arr(o.dinv),
                                     o.iters)

    def _NearKernel(self, o):
        return NearKernel(self.arr(o.B), self.arr(o.Ainv))

    def _AMGLevel(self, o):
        return AMGLevel(self.conv(o.A), self.conv(o.P), self.conv(o.R),
                        self.conv(o.smoother), self.conv(o.Asm),
                        nk=self.conv(o.nk))

    def _AMGHierarchy(self, o):
        return AMGHierarchy(
            [self.conv(lvl) for lvl in o.levels], self.conv(o.coarse),
            presmooth_iter=o.presmooth_iter,
            postsmooth_iter=o.postsmooth_iter, cycle_type=o.cycle_type,
            coarse_scaling=o.coarse_scaling, fine64=self.conv(o.fine64),
            amli_degree=o.amli_degree, amli_coefs=o.amli_coefs,
            level_visits=o.level_visits)

    def _AMGPrecond(self, o):
        return AMGPrecond(self.conv(o.hier), o.maxit)

    # -- block smoothers, ILU, Schwarz ---------------------------------------

    def _BlockJacobiPrecond(self, o):
        return BlockJacobiPrecond(self.arr(o.dinv))

    def _BsrColorBlock(self, o):
        return BsrColorBlock(self.arr(o.rows), self.arr(o.cols),
                             self.arr(o.vals), self.arr(o.dinv))

    def _BsrSmootherData(self, o):
        return BsrSmootherData(o.kind, o.relax, o.nb, dinv=self.arr(o.dinv),
                               colors=[self.conv(c) for c in o.colors])

    def _PrecondSmoother(self, o):
        return PrecondSmoother(self.conv(o.M))

    def _TriangularSolver(self, o):
        """Both segment kinds become plain levels: a scan segment is cut
        into its levels and the rows that pad it (index n) removed."""
        levels = []
        for seg in o.segments:
            rows, cols, vals, dinv = (np.asarray(a) for a in (
                seg.rows, seg.cols, seg.vals, seg.dinv))
            if rows.ndim == 1:
                levels.append((rows, cols, vals, dinv))
                continue
            for li in range(rows.shape[0]):
                ok = rows[li] != o.n
                levels.append((rows[li][ok], cols[li][ok], vals[li][ok],
                               dinv[li][ok]))

        def cat(i):
            return torch.from_numpy(np.concatenate(
                [lv[i].reshape(-1) for lv in levels]))

        return TriangularSolver(cat(0), cat(1), cat(2), cat(3),
                                [lv[1].shape for lv in levels], o.n)

    def _ILUPrecond(self, o):
        return ILUPrecond(self.conv(o.Lsolve), self.conv(o.Usolve),
                          perm_in=self.arr(o.perm_in),
                          perm_out=self.arr(o.perm_out))

    def _BlockTriangularSolver(self, o):
        lv = [tuple(np.asarray(a) for a in (l.rows, l.cols, l.vals, l.dinv))
              for l in o.levels]
        nb = lv[0][2].shape[-1]
        dinv = np.concatenate([l[3] for l in lv])
        unit = np.array_equal(dinv, np.broadcast_to(np.eye(nb), dinv.shape))
        return BlockTriangularSolver(
            torch.from_numpy(np.concatenate([l[0] for l in lv])),
            torch.from_numpy(np.concatenate([l[1].reshape(-1) for l in lv])),
            torch.cat([block_ell_layout(torch.from_numpy(
                np.array(l[2], copy=True))).reshape(-1) for l in lv]),
            None if unit else torch.from_numpy(dinv),
            [l[1].shape for l in lv], o.n, nb)

    def _BSRILUPrecond(self, o):
        return BSRILUPrecond(self.conv(o.Lsolve), self.conv(o.Usolve), o.nb)

    def _ColorGroup(self, o):
        return _ColorGroup(self.arr(o.dofs), self.arr(o.mask),
                           self.arr(o.inv))

    def _SchwarzPrecond(self, o):
        return SchwarzPrecond([self.conv(g) for g in o.groups],
                              self.conv(o.A), o.n, o.swz_type)

    # -- STR and BLC -----------------------------------------------------------

    def _StrOperator(self, o):
        return StrOperator(self.arr(o.diag), [self.arr(b) for b in o.bands],
                           o.offsets, o.ng, o.nc)

    def _StrDiagPrecond(self, o):
        return StrDiagPrecond(self.arr(o.dinv))

    def _StrBlockGSPrecond(self, o):
        return StrBlockGSPrecond(self.conv(o.A), self.arr(o.dinv),
                                 [self.arr(m) for m in o.masks], o.nsweeps)

    def _StrSchwarzSmoother(self, o):
        return StrSchwarzSmoother(self.conv(o.A), self.arr(o.inv),
                                  self.arr(o.members), self.arr(o.valid),
                                  [self.arr(c) for c in o.colors], o.nsweeps)

    def _grid(self, rows):
        """{(i, j): port operator} of a JAX tuple-of-tuples block grid
        (None: a zero block)."""
        return {(i, j): self.conv(op) for i, row in enumerate(rows)
                for j, op in enumerate(row) if op is not None}

    def _BlcOperator(self, o):
        return BlcOperator(self._grid(o.ops), o.row_sizes, o.col_sizes)

    def _JacobiApply(self, o):
        return JacobiPrecond(self.arr(o.dinv))

    def _BlcPrecond(self, o):
        return BlcPrecond([self.conv(m) for m in o.solvers],
                          self._grid(o.offdiag), o.mode, o.sizes)

    def _BlcSweepingPrecond(self, o):
        def layers(ops):
            return {i: self.conv(op) for i, op in enumerate(ops)
                    if op is not None}
        return BlcSweepingPrecond([self.conv(m) for m in o.solvers],
                                  layers(o.lower), layers(o.upper), o.sizes)
