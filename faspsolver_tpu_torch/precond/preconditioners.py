"""Preconditioner adapters: AMG hierarchies as operators for the Krylov
layer (port of ``faspsolver_tpu/precond/preconditioners.py``).

Reference: base/src/PreCSR.c (fasp_precond_amg :416 runs ``maxit``
mgcycles; _amli :482; _namli :515; _famg :449; fasp_precond_amg_nk).

On a CUDA vector the AMG and FMG preconditioners replay their cycles
from a CUDA graph (``utils.graphs.GraphedModule``), kept by the
hierarchy: every cycle type reads nothing back to the host, over CSR
and BSR levels alike (block operators, block smoothers and the
near-kernel correction included).  They run eagerly where
``capturable`` is False — a hierarchy placed on a mesh, or one with a
part that does not declare itself capturable (a MatFree operator over
a plain function) — and on DTensor vectors.  The near-kernel
preconditioner (:class:`AMGNKPrecond`) is capturable when its cycles
and its operator are.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import is_dtensor
from ..utils.graphs import GraphedModule, capturable
from .amg.cycles import cycle_fn, fmg_cycle, mgcycle
from .amg.hierarchy import AMGHierarchy


class _CyclePrecond(GraphedModule):
    """Cycles over a hierarchy; the graphs are the hierarchy's, so a new
    wrapper of it replays them."""

    def __init__(self, hier: AMGHierarchy, maxit: int = 1):
        super().__init__()
        self.hier = hier
        self.maxit = int(maxit)

    @property
    def capturable(self) -> bool:
        return self.hier.capturable

    def graph_identity(self):
        return self.hier, (type(self).__name__, self.maxit)


class AMGPrecond(_CyclePrecond):
    """z = (approx A^{-1}) r via ``maxit`` multigrid cycles of the
    hierarchy's cycle type (reference: fasp_precond_amg, PreCSR.c:416)."""

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        if is_dtensor(r) and not sharded_fine(self.hier):
            # a sharded vector meets a replicated hierarchy (every rank
            # holds all of it: parallel.replicate): gather r, cycle on the
            # whole vector on every rank, keep this rank's part
            from ..parallel.pcsr import on_whole
            return on_whole(self.eager, r)
        return super().forward(r)

    def eager(self, r: torch.Tensor) -> torch.Tensor:
        cycle = cycle_fn(self.hier.cycle_type)
        z = None
        for _ in range(self.maxit):
            z = cycle(self.hier, r, z)
        return z


def sharded_fine(hier) -> bool:
    """Whether a hierarchy's finest level takes sharded vectors
    (``parallel.shard_hierarchy`` records each level's layout)."""
    placed = getattr(hier, "sharded_levels", ())
    return bool(placed and placed[0])


class AMGNKPrecond(nn.Module):
    """AMG preconditioner with an extra near-kernel correction (reference:
    fasp_precond_amg_nk, PreCSR.c): z = MG(r); z += NK gram_inv NK^T
    (r - A z), with ``nk`` the (n, m) near-kernel basis and ``gram_inv``
    = (NK^T A NK)^{-1} formed at setup."""

    @property
    def capturable(self) -> bool:
        """Its cycles and its operator capturable: the correction adds
        two dense products and one apply, no host read."""
        return capturable(self.mg) and capturable(self.A_op)

    def __init__(self, hier: AMGHierarchy, nk, gram_inv, A_op,
                 maxit: int = 1):
        super().__init__()
        self.mg = AMGPrecond(hier, maxit)
        self.register_buffer("nk", nk)
        self.register_buffer("gram_inv", gram_inv)
        self.A_op = A_op

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        z = self.mg(r)
        coeffs = self.gram_inv @ (self.nk.T @ (r - self.A_op(z)))
        return z + self.nk @ coeffs


class FMGPrecond(_CyclePrecond):
    """Full-multigrid preconditioner: one FMG cycle, then ``maxit - 1``
    V-cycles (reference: fasp_precond_famg, PreCSR.c:449)."""

    def eager(self, r: torch.Tensor) -> torch.Tensor:
        z = fmg_cycle(self.hier, r)
        for _ in range(self.maxit - 1):
            z = mgcycle(self.hier, r, z)
        return z
