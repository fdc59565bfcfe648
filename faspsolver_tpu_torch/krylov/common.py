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
from ..utils import graphs
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


def take_row(V, j: torch.Tensor, b) -> torch.Tensor:
    """Row ``j`` (a one-element index tensor on V's local device, read on
    the device) of a basis V made by :func:`zeros_rows`, laid out like
    b.  A DTensor basis is indexed in its local part (split by column,
    each rank holds its slice of every row): DTensor has no sharding rule
    for the index ops in every PyTorch release."""
    if is_dtensor(V):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(V.to_local().index_select(0, j)[0],
                                  b.device_mesh, b.placements,
                                  run_check=False, shape=b.shape,
                                  stride=b.stride())
    return V.index_select(0, j)[0]


def put_row(V, j: torch.Tensor, v) -> None:
    """V[j] = v in place (j as for :func:`take_row`)."""
    if is_dtensor(V):
        V.to_local().index_copy_(0, j, v.to_local()[None])
    else:
        V.index_copy_(0, j, v[None])


def like(v: torch.Tensor, b) -> torch.Tensor:
    """A small host-computed tensor v on b's device, replicated over b's
    mesh when b is a DTensor."""
    if is_dtensor(b):
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(v.to(b.to_local().device), b.device_mesh,
                                  [Replicate()], run_check=False)
    return v.to(b.device)


def local_device(b) -> torch.device:
    """The device of b's local part (b's own unless b is a DTensor)."""
    return b.to_local().device if is_dtensor(b) else b.device


def loop_state(kind: str, A, M, b, stop_type: int, safe: bool, make,
               static: tuple = ()):
    """(state, resident) of a Krylov loop over A and M: the state kept
    with A and M for a resident solve (a CUDA vector or a DTensor over an
    NCCL mesh, graphs on, both modules capturable; cached by their
    buffers, b's dtype, length and placements, the criterion, ``safe``
    and the loop's other ``static`` settings that shape its program),
    else a fresh ``make()`` for the eager loop."""
    if not (graphs.active(b) and graphs.capturable(A)
            and graphs.capturable(M)):
        return make(), False
    (ha, sa), (hm, sm) = graphs.identity(A), graphs.identity(M)
    key = (b.dtype, b.shape[0], b.device, getattr(b, "placements", None),
           sa, sm, graphs.fingerprint(ha), graphs.fingerprint(hm))
    return graphs.cached((ha, hm), (kind, int(stop_type), bool(safe))
                         + tuple(static), key, make), True


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
        self.count += 1
        v = torch.stack(scalars)
        if is_dtensor(v):
            v = v.full_tensor()
        if v.device.type == "cuda":
            host = _pinned_like(v)
            host.copy_(v, non_blocking=True)
            torch.cuda.current_stream(v.device).synchronize()
            v = host
        return [self.t(a) for a in v.tolist()]

    def block(self, blk):
        """A loop's state block (``utils.loops.Block``) -> its regions'
        fields as NumPy arrays, in ONE transfer."""
        self.count += 1
        v = blk.bytes
        if v.device.type == "cuda":
            host = _pinned_like(v)
            host.copy_(v, non_blocking=True)
            torch.cuda.current_stream(v.device).synchronize()
            v = host
        return blk.decode(v.numpy().copy())
