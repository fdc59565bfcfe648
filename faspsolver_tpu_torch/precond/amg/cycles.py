"""Multigrid V / W / hybrid cycles (port of ``mgcycle``/``_cycle``/
``_visits`` of ``faspsolver_tpu/precond/amg/cycles.py``).

Reference: base/src/PreMGCycle.c:48 (fasp_solver_mgcycle) and
PreMGRecur.c.  The recursion runs eagerly in Python over the module tree;
the visit pattern (V = 1 visit, W = 2, hybrid VW/WV by level parity)
reproduces the reference's cycle counters (PreMGCycle.c:71-84).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...constants import CycleType
from .hierarchy import AMGHierarchy
from .smoothers import smooth


def _sm_op(lvl):
    """Operator of the smoother sweeps: the level's filtered operator
    when it has one (``AMGLevel.Asm``), else its exact A."""
    return lvl.A if lvl.Asm is None else lvl.Asm


# Deepest level that still doubles visits in W-type cycles; levels past
# the cap degrade to V-visits.  Kept at the JAX package's value so both
# packages run the same cycle.
_W_UNROLL_CAP = 6


def _visits(cycle_type: int, level: int) -> int:
    if cycle_type == CycleType.W:
        return 2 if level < _W_UNROLL_CAP else 1
    if cycle_type == CycleType.VW:       # reference hybrid 12
        return 1 if level % 2 == 0 else 2
    if cycle_type == CycleType.WV:       # reference hybrid 21
        return 2 if (level % 2 == 0 and level < _W_UNROLL_CAP) else 1
    return 1


def mgcycle(hier: AMGHierarchy, b: torch.Tensor,
            x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One multigrid cycle starting from iterate x (default 0)."""
    if x is None:
        x = torch.zeros_like(b)
    return _cycle(hier, 0, b, x)


def _cycle(hier: AMGHierarchy, l: int, b, x):
    levels = hier.levels
    if l == len(levels) - 1:
        return hier.coarse(b)

    lvl = levels[l]
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.presmooth_iter,
               forward=True)

    r = b - lvl.A(x)
    rc = lvl.R(r)

    ec = torch.zeros(levels[l + 1].A.shape[0], dtype=b.dtype,
                     device=b.device)
    for _ in range(_visits(hier.cycle_type, l)):
        ec = _cycle(hier, l + 1, rc, ec)

    if hier.coarse_scaling:
        Ae = levels[l + 1].A(ec)
        denom = torch.dot(ec, Ae)
        safe = torch.where(denom.abs() > 1e-30, denom,
                           torch.ones_like(denom))
        ec = torch.clamp_max(torch.dot(ec, rc) / safe, 1.0) * ec

    x = x + lvl.P(ec)
    return smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
                  forward=False)

