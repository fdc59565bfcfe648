"""Multigrid cycles: V / W / hybrid, AMLI, nonlinear AMLI, FMG (port of
``faspsolver_tpu/precond/amg/cycles.py``).

Reference: base/src/PreMGCycle.c:48 (fasp_solver_mgcycle),
PreMGRecur.c, PreMGRecurAMLI.c:58/:291 (AMLI / nonlinear AMLI),
PreMGCycleFull.c:47 (FMG).  The recursion runs eagerly in Python over
the module tree; the visit pattern (V = 1 visit, W = 2, hybrid VW/WV by
level parity) reproduces the reference's cycle counters
(PreMGCycle.c:71-84).  No cycle reads a value back to the host: the
scalars of coarse scaling and of the NL-AMLI inner steps stay 0-d
tensors.
"""
from __future__ import annotations

import math
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

    # laid out like the restricted residual (sharded or whole, when the
    # hierarchy is distributed: parallel.shard_hierarchy)
    ec = torch.zeros_like(rc)
    for _ in range(_visits(hier.cycle_type, l)):
        ec = _cycle(hier, l + 1, rc, ec)

    if hier.coarse_scaling:
        ec = _scale_coarse(levels[l + 1].A, ec, rc)

    x = x + lvl.P(ec)
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
               forward=False)
    if lvl.nk is not None:
        # the extra near-kernel solve (reference: PreMGCycle.c:369-391):
        # x += B (B^T A B)^-1 B^T (b - A x)
        x = x + lvl.nk(b - lvl.A(x))
    return x


def _scale_coarse(A1, e, r):
    """Coarse-correction scaling min(e.r / e.Ae, 1) e (reference:
    coarse_scaling, PreMGCycle.c)."""
    denom = torch.dot(e, A1(e))
    safe = torch.where(denom.abs() > 1e-30, denom, torch.ones_like(denom))
    return torch.clamp_max(torch.dot(e, r) / safe, 1.0) * e


# ---------------------------------------------------------------------------
# AMLI (polynomial) cycle — reference: fasp_solver_amli, PreMGRecurAMLI.c:58
# ---------------------------------------------------------------------------

def amli_coefs(lambda_max: float, lambda_min: float, degree: int):
    """Chebyshev-derived AMLI polynomial coefficients
    (reference: fasp_amg_amli_coef, PreMGRecurAMLI.c:791)."""
    mu0, mu1 = 1.0 / lambda_max, 1.0 / lambda_min
    c = (math.sqrt(mu0) + math.sqrt(mu1)) ** 2
    a = (4 * mu0 * mu1) / c
    kappa = lambda_max / lambda_min
    delta = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
    bb = delta * delta
    if degree == 0:
        return (0.5 * (mu0 + mu1),)
    if degree == 1:
        return (0.5 * c, -mu0 * mu1)
    ck = list(amli_coefs(lambda_max, lambda_min, degree - 1))
    ckm1 = list(amli_coefs(lambda_max, lambda_min, degree - 2))
    coef = [0.0] * (degree + 1)
    coef[0] = a - bb * ckm1[0] + (1 + bb) * ck[0]
    for i in range(1, degree - 1):
        coef[i] = -bb * ckm1[i] + (1 + bb) * ck[i] - a * ck[i - 1]
    coef[degree - 1] = (1 + bb) * ck[degree - 1] - a * ck[degree - 2]
    coef[degree] = -a * ck[degree - 1]
    return tuple(coef)


def amli_fields(param) -> dict:
    """The hierarchy's AMLI degree and coefficients for an AMGParam, as
    every general setup sets them."""
    return dict(amli_degree=param.amli_degree,
                amli_coefs=(amli_coefs(2.0, 0.5, param.amli_degree)
                            if param.amli_degree > 0 else ()))


def amli_cycle(hier: AMGHierarchy, b: torch.Tensor,
               x: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x is None:
        x = torch.zeros_like(b)
    return _amli(hier, 0, b, x)


def _amli(hier: AMGHierarchy, l: int, b, x):
    levels = hier.levels
    if l == len(levels) - 1:
        return hier.coarse(b)

    lvl = levels[l]
    degree = hier.amli_degree if l < _W_UNROLL_CAP else 0
    coef = hier.amli_coefs or amli_coefs(2.0, 0.5, hier.amli_degree)

    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.presmooth_iter,
               forward=True)
    r1 = lvl.R(b - lvl.A(x))

    A1 = levels[l + 1].A
    b1 = r1
    zero = torch.zeros(A1.shape[0], dtype=b.dtype, device=b.device)
    # polynomial acceleration (reference: PreMGRecurAMLI.c:155-170)
    for i in range(1, degree + 1):
        e1 = _amli(hier, l + 1, b1, zero)
        b1 = A1(e1) + (coef[degree - i] / coef[degree]) * r1
    e1 = coef[degree] * _amli(hier, l + 1, b1, zero)

    if hier.coarse_scaling:
        e1 = _scale_coarse(A1, e1, r1)

    x = x + lvl.P(e1)
    return smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
                  forward=False)


# ---------------------------------------------------------------------------
# Nonlinear AMLI — reference: fasp_solver_namli, PreMGRecurAMLI.c:291
# ---------------------------------------------------------------------------

def nl_amli_cycle(hier: AMGHierarchy, b: torch.Tensor,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x is None:
        x = torch.zeros_like(b)
    return _nl_amli(hier, 0, b, x)


def _nl_amli(hier: AMGHierarchy, l: int, b, x):
    """Per level a few minimal-residual (GCR-type) steps preconditioned by
    the next coarser NL-AMLI cycle (the reference runs FGMRES/GCG with
    maxit=2 on each level)."""
    levels = hier.levels
    if l == len(levels) - 1:
        return hier.coarse(b)

    lvl = levels[l]
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.presmooth_iter,
               forward=True)
    rc = lvl.R(b - lvl.A(x))

    A1 = levels[l + 1].A
    inner_steps = 2 if l + 1 < len(levels) - 1 and l < _W_UNROLL_CAP else 1
    # UA setups store per-level visit counts from the complexity rule
    # (PreAMGSetupUA.c:391-402); NL-AMLI reads them to choose plain
    # recursion or inner Krylov per level (PreMGRecurAMLI.c:385)
    if hier.level_visits and l + 1 < len(hier.level_visits):
        inner_steps = min(inner_steps, max(1, hier.level_visits[l + 1]))
    ec = torch.zeros(A1.shape[0], dtype=b.dtype, device=b.device)
    rr = rc
    for _ in range(inner_steps):
        z = _nl_amli(hier, l + 1, rr, torch.zeros_like(ec))
        Az = A1(z)
        denom = torch.dot(Az, Az)
        alpha = torch.dot(Az, rr) / torch.where(denom > 1e-30, denom,
                                                torch.ones_like(denom))
        ec = ec + alpha * z
        rr = rr - alpha * Az

    x = x + lvl.P(ec)
    return smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
                  forward=False)


# ---------------------------------------------------------------------------
# Full multigrid — reference: fasp_solver_fmgcycle, PreMGCycleFull.c:47
# ---------------------------------------------------------------------------

def fmg_cycle(hier: AMGHierarchy, b: torch.Tensor) -> torch.Tensor:
    """Full multigrid: restrict b to the coarsest level, then interpolate
    upward running one V-cycle per level."""
    levels = hier.levels
    bs = [b]
    for lvl in levels[:-1]:
        bs.append(lvl.R(bs[-1]))
    x = hier.coarse(bs[-1])
    for l in range(len(levels) - 2, -1, -1):
        x = _cycle(hier, l, bs[l], levels[l].P(x))
    return x


def cycle_fn(cycle_type: int):
    """The cycle a hierarchy of ``cycle_type`` runs: AMLI, NL-AMLI, or
    ``mgcycle`` for the V / W / hybrid visit patterns."""
    return {int(CycleType.AMLI): amli_cycle,
            int(CycleType.NL_AMLI): nl_amli_cycle}.get(int(cycle_type),
                                                       mgcycle)
