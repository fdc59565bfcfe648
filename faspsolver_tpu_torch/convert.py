"""Carry a hierarchy built by the JAX package across to the port.

``from_jax(obj)`` walks a ``faspsolver_tpu`` structured or classical
RS-AMG hierarchy (or any of its parts: operators, transfers, smoothers,
coarse solvers, an ``AMGPrecond``) by class name and attribute access, reads every array
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

from .ops.operators import (ConstDiaOperator, CooOperator, DenseOperator,
                            DiaNdOperator, DiaOperator, EllOperator,
                            FactoredBand, HybridDiaOperator,
                            StencilNdOperator, SumOperator)
from .precond.amg.hierarchy import (AMGHierarchy, AMGLevel, CoarseSolver,
                                    IterativeCoarseSolver)
from .precond.amg.smoothers import SmootherData
from .precond.amg.structured import (PairProlong, PairRestrict,
                                     SmoothedProlong, SmoothedRestrict)
from .precond.amg.transfer import (BandedProlong, BandedRestrict, CooProlong,
                                   CooRestrict)
from .precond.preconditioners import AMGPrecond


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
            build = getattr(self, "_" + name, None)
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

    # -- transfers ---------------------------------------------------------

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

    def _SmootherData(self, o):
        if o.colors:
            raise NotImplementedError("multicolor GS smoothers are not "
                                      "ported")
        lam = None if o.lambda_max is None else np.asarray(o.lambda_max)
        return SmootherData(o.kind, o.relax, o.nsweep_scale,
                            dinv=self.arr(o.dinv), l1inv=self.arr(o.l1inv),
                            lambda_max=lam,
                            rb_masks=tuple(self.arr(m) for m in o.rb_masks))

    def _CoarseSolver(self, o):
        return CoarseSolver(self.arr(o.inv))

    def _IterativeCoarseSolver(self, o):
        return IterativeCoarseSolver(self.conv(o.A), self.arr(o.dinv),
                                     o.iters)

    def _AMGLevel(self, o):
        if o.nk is not None:
            raise NotImplementedError("near-kernel levels are not ported")
        return AMGLevel(self.conv(o.A), self.conv(o.P), self.conv(o.R),
                        self.conv(o.smoother), self.conv(o.Asm))

    def _AMGHierarchy(self, o):
        return AMGHierarchy(
            [self.conv(lvl) for lvl in o.levels], self.conv(o.coarse),
            presmooth_iter=o.presmooth_iter,
            postsmooth_iter=o.postsmooth_iter, cycle_type=o.cycle_type,
            coarse_scaling=o.coarse_scaling, fine64=self.conv(o.fine64))

    def _AMGPrecond(self, o):
        return AMGPrecond(self.conv(o.hier), o.maxit)
