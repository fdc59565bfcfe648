"""Shared Krylov machinery: stopping criteria, safeguard constants (port
of ``faspsolver_tpu/krylov/common.py``).

Reference: base/src/KryUtil.inl (ITS_* macros) and the identical
safeguard blocks replicated in every Kry*.c file.  The residual norm is
a device tensor; the eager solvers read it to the host, where the
relative residuals and checks run on NumPy scalars of the working dtype.
Vectors may be DTensors of the distribution layer (``parallel/``): the
helpers below keep a dot product's scalar replicated, so the solvers run
unchanged on sharded vectors.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import is_dtensor, np_dtype
from ..constants import StopType
from .precond import IdentityPrecond

SMALLREAL = 1e-20       # reference SMALLREAL (fasp_const.h)
SMALLREAL2 = 1e-40      # reference SMALLREAL2: breakdown guard


def resolve_precond(M) -> Callable:
    return IdentityPrecond() if M is None else M


def replicated(s):
    """A reduction's result as every rank's whole value: a DTensor dot of
    two sharded vectors is a pending sum (``Partial``), which the next
    product with a sharded vector would meet by gathering that vector;
    summed once here (one all-reduce), it stays a scalar.  A plain tensor
    passes through."""
    if is_dtensor(s) and any(p.is_partial() for p in s.placements):
        from torch.distributed.tensor import Replicate
        return s.redistribute(s.device_mesh,
                              [Replicate()] * s.device_mesh.ndim)
    return s


def dot(x, y) -> torch.Tensor:
    """<x, y> as a 0-d tensor (replicated for DTensors)."""
    return replicated(torch.dot(x, y))


def zeros_rows(m: int, b) -> torch.Tensor:
    """(m, len(b)) zeros laid out like b: a basis of m vectors, split by
    column where b is a sharded DTensor."""
    if is_dtensor(b):
        return torch.stack([torch.zeros_like(b)] * m)
    return torch.zeros((m, b.shape[0]), dtype=b.dtype, device=b.device)


def like(v: torch.Tensor, b) -> torch.Tensor:
    """A small host-computed tensor v on b's device, replicated over b's
    mesh when b is a DTensor."""
    if is_dtensor(b):
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(v.to(b.to_local().device), b.device_mesh,
                                  [Replicate()], run_check=False)
    return v.to(b.device)


def abs_residual(stop_type: int, r, z) -> torch.Tensor:
    """Device 0-d tensor: sqrt|z.r| (REL_PRECRES) or ||r||_2."""
    if stop_type == StopType.REL_PRECRES:
        return torch.sqrt(torch.abs(dot(z, r)))
    return torch.sqrt(dot(r, r))


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


_pinned = {}


def _pinned_like(v: torch.Tensor) -> torch.Tensor:
    """A reused page-locked host buffer for v's values (grown on need)."""
    buf = _pinned.get(v.dtype)
    if buf is None or buf.numel() < v.numel():
        buf = torch.empty(max(v.numel(), 64), dtype=v.dtype, pin_memory=True)
        _pinned[v.dtype] = buf
    return buf[:v.numel()]


class HostReads:
    """Device-to-host reads of an eager solver loop, counted: each call
    reads several values in ONE transfer and returns them as NumPy
    scalars of the working dtype (the roundings of the JAX package's
    traced scalar arithmetic).  From a CUDA device the transfer lands in
    a reused page-locked buffer."""

    def __init__(self, dtype):
        self.t = np_dtype(dtype).type
        self.count = 0

    def __call__(self, *scalars):
        """0-d tensors -> list of host scalars."""
        return self.vec(torch.stack(scalars))

    def vec(self, v: torch.Tensor):
        """A 1-d tensor -> list of host scalars."""
        self.count += 1
        if is_dtensor(v):
            v = v.full_tensor()
        if v.device.type == "cuda":
            host = _pinned_like(v)
            host.copy_(v, non_blocking=True)
            torch.cuda.current_stream(v.device).synchronize()
            v = host
        return [self.t(a) for a in v.tolist()]
