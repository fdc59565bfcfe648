"""Shared Krylov machinery: stopping criteria, safeguard constants (port
of ``faspsolver_tpu/krylov/common.py``).

Reference: base/src/KryUtil.inl (ITS_* macros) and the identical
safeguard blocks replicated in every Kry*.c file.  The residual norm is
a device tensor; the eager solvers read it to the host, where the
relative residuals and checks run on NumPy scalars of the working dtype.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import np_dtype
from ..constants import StopType
from .precond import IdentityPrecond

SMALLREAL = 1e-20       # reference SMALLREAL (fasp_const.h)
SMALLREAL2 = 1e-40      # reference SMALLREAL2: breakdown guard


def resolve_precond(M) -> Callable:
    return IdentityPrecond() if M is None else M


def abs_residual(stop_type: int, r, z) -> torch.Tensor:
    """Device 0-d tensor: sqrt|z.r| (REL_PRECRES) or ||r||_2."""
    if stop_type == StopType.REL_PRECRES:
        return torch.sqrt(torch.abs(torch.dot(z, r)))
    return torch.sqrt(torch.dot(r, r))


def residual_norms(stop_type: int, absres, normr0, normu):
    """(absres, relres) for the three reference stopping criteria, on
    host scalars of the working dtype."""
    if stop_type == StopType.MOD_REL_RES:
        return absres, absres / normu
    return absres, absres / normr0


def initial_norms(stop_type: int, absres0, xx0):
    """(absres0, normr0, normu, relres) at iteration 0 from the host
    values of the initial residual norm and x0.x0 (reference:
    KryPcg.c:134-160)."""
    t = type(absres0)
    normr0 = max(t(SMALLREAL), absres0)
    normu = max(t(SMALLREAL), np.sqrt(xx0))
    return (absres0, normr0, normu,
            residual_norms(stop_type, absres0, normr0, normu)[1])


class HostReads:
    """Device-to-host reads of an eager solver loop, counted: each call
    reads several values in ONE transfer and returns them as NumPy
    scalars of the working dtype (the roundings of the JAX package's
    traced scalar arithmetic)."""

    def __init__(self, dtype):
        self.t = np_dtype(dtype).type
        self.count = 0

    def __call__(self, *scalars):
        """0-d tensors -> list of host scalars."""
        return self.vec(torch.stack(scalars))

    def vec(self, v: torch.Tensor):
        """A 1-d tensor -> list of host scalars."""
        self.count += 1
        return [self.t(a) for a in v.tolist()]
