"""Eigenvalue estimation: the power method for lambda_max (port of
``faspsolver_tpu/ops/eigen.py``).

Reference: fasp_dcsr_maxeig (BlaEigen.c), used by the polynomial
smoother and the AMLI coefficients.  Host NumPy for a host matrix (the
setup phase), and a device version over any operator.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..formats import CSRMatrix


def maxeig(A, iters: int = 50, tol: float = 1e-6) -> float:
    """lambda_max of a host CSR matrix by power iteration."""
    if isinstance(A, CSRMatrix):
        m = A.to_scipy()
        rng = np.random.default_rng(0)
        v = rng.standard_normal(A.nrow)
        v /= np.linalg.norm(v)
        lam = 0.0
        for _ in range(iters):
            w = m @ v
            lam_new = float(np.linalg.norm(w))
            if lam_new == 0.0:
                return 0.0
            v = w / lam_new
            if abs(lam_new - lam) <= tol * lam_new:
                return lam_new
            lam = lam_new
        return lam
    return float(maxeig_device(A, iters))


def _device_of(op) -> torch.device:
    if isinstance(op, torch.nn.Module):
        for t in op.buffers():
            return t.device
    return default_device()


def maxeig_device(op, iters: int = 50,
                  v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Power iteration over an operator on its device: ``iters`` applies
    with no host read; returns lambda_max as a 0-d tensor.

    ``v0`` is the start vector.  By default it is a standard normal draw
    from a ``torch.Generator`` seeded 0 on the operator's device (the
    device of its first buffer, else the CUDA device).  The JAX package
    draws from ``jax.random.PRNGKey(0)``, which torch cannot reproduce:
    pass that vector as ``v0`` for the same iterates."""
    n = op.shape[0]
    if v0 is None:
        device = _device_of(op)
        gen = torch.Generator(device=device).manual_seed(0)
        v = torch.randn(n, generator=gen, dtype=op.dtype, device=device)
    else:
        v = v0.to(op.dtype)
    v = v * torch.rsqrt(torch.dot(v, v))
    lam = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = op(v)
        lam = torch.sqrt(torch.dot(w, w))
        pos = lam > 0
        v = w * torch.where(pos, 1.0 / torch.where(pos, lam, 1.0), 0.0)
    return lam
