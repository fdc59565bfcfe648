"""AMG hierarchy as a module tree (port of
``faspsolver_tpu/precond/amg/hierarchy.py``: NearKernel, AMGLevel, CoarseSolver,
IterativeCoarseSolver, make_coarse_solver, AMGHierarchy).

Reference: AMG_data (base/include/fasp.h:804-888) — per-level {A, R, P,
smoother data} plus a coarsest-grid solver.  Every array is a registered
buffer of some submodule, so ``hier.to(device)`` moves the whole
hierarchy; modules shared between levels and transfers (the smoothed
transfers reuse the level's A) are moved once.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import as_tensor, np_dtype
from ...ops.operators import _buf, full_precision_matmul
from ...utils.graphs import capturable


class NearKernel(nn.Module):
    """One level's near-kernel (null-space) correction data (reference:
    AMG_data.near_kernel_basis, fasp.h:849-852; per-level A_nk / P_nk /
    R_nk, PreAMGSetupUABSR.c:241-266): ``B`` is the basis restricted to
    the level, (n, m), and ``Ainv`` = (B^T A B)^-1, (m, m), formed dense
    on the host.  The cycle applies x += B Ainv B^T (b - A x) after
    post-smoothing (PreMGCycle.c:369-391): two skinny dense products."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, B, Ainv):
        super().__init__()
        self.register_buffer("B", _buf(B))
        self.register_buffer("Ainv", _buf(Ainv))

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        full_precision_matmul()
        return self.B @ (self.Ainv @ (self.B.T @ r))


class AMGLevel(nn.Module):
    """One level: operator, transfers down to the next level, smoother
    (P, R and smoother are None on the coarsest level).  ``Asm``, when
    set, is the operator the smoother sweeps use (filtered smoothing:
    a banded approximation of A, same family as the reference's SA
    smooth_filter, PreAMGSetupSA.c); residuals and transfers keep A.
    ``nk``, when set, is the level's near-kernel correction."""

    def __init__(self, A, P=None, R=None, smoother=None, Asm=None,
                 nk: Optional[NearKernel] = None):
        super().__init__()
        self.A = A
        self.P = P
        self.R = R
        self.smoother = smoother
        self.Asm = Asm
        self.nk = nk


class CoarseSolver(nn.Module):
    """Coarsest-grid direct solve as a dense inverse matmul (the inverse
    is formed on the host at setup, in float64).  The product runs in
    full float32 precision — no TF32 — as the JAX package asks
    ``Precision.HIGHEST`` (a ~3-digit coarse solve costs V-cycle
    iterations)."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, inv):
        super().__init__()
        self.register_buffer("inv", _buf(inv))

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        full_precision_matmul()
        return torch.matmul(self.inv, b)


class IterativeCoarseSolver(nn.Module):
    """Jacobi-preconditioned CG, a fixed ``iters`` steps, for coarse
    levels too large to factor densely (reference: fasp_coarse_itsolver,
    PreMGUtil.inl:25).  Guards stay on the device (no host sync)."""

    @property
    def capturable(self) -> bool:
        return capturable(self.A)

    def __init__(self, A, dinv, iters: int = 60):
        super().__init__()
        self.A = A
        self.register_buffer("dinv", _buf(dinv))
        self.iters = int(iters)

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        def guard(v):
            return torch.where(v.abs() > 1e-30, v, torch.ones_like(v))

        x = torch.zeros_like(b)
        r = b
        z = self.dinv * b
        p = z
        rz = torch.dot(b, z)
        for _ in range(self.iters):
            Ap = self.A(p)
            alpha = rz / guard(torch.dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.dinv * r
            rz_new = torch.dot(r, z)
            beta = rz_new / guard(rz)
            p = z + beta * p
            rz = rz_new
        return x


# dense coarse factorization above this size is a mistake, not a solve
_DENSE_COARSE_LIMIT = 4096


def make_coarse_solver(A_host, dtype):
    """Coarse-grid solver for a host CSR (or BSR, through its scalar
    expansion) level: the dense inverse for small levels, Jacobi-CG over
    its operator otherwise."""
    from ...ops.operators import device_operator
    if hasattr(A_host, "to_csr"):
        A_host = A_host.to_csr()
    n = A_host.nrow
    if n <= _DENSE_COARSE_LIMIT:
        # the level in its working precision, inverted in float64
        mat = np.asarray(A_host.to_dense(), dtype=np_dtype(dtype)).astype(
            np.float64)
        try:
            inv = np.linalg.inv(mat)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(mat)
        return CoarseSolver(as_tensor(inv, dtype))
    d = A_host.diagonal()
    d = np.where(d != 0.0, d, 1.0)
    return IterativeCoarseSolver(device_operator(A_host, dtype=dtype),
                                 as_tensor(1.0 / d, dtype))


class AMGHierarchy(nn.Module):
    """The full multilevel structure (finest at index 0)."""

    def __init__(self, levels: Sequence[AMGLevel], coarse,
                 presmooth_iter: int = 1, postsmooth_iter: int = 1,
                 cycle_type: int = 1, coarse_scaling: bool = False,
                 fine64=None, amli_degree: int = 2,
                 amli_coefs: Sequence[float] = (),
                 level_visits: Sequence[int] = ()):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.coarse = coarse
        self.presmooth_iter = int(presmooth_iter)
        self.postsmooth_iter = int(postsmooth_iter)
        self.cycle_type = int(cycle_type)
        self.coarse_scaling = bool(coarse_scaling)
        # AMLI polynomial degree and coefficients (cycles.amli_coefs)
        self.amli_degree = int(amli_degree)
        self.amli_coefs = tuple(float(c) for c in amli_coefs)
        # per-level coarse-visit counts of the UA complexity rule (read by
        # the NL-AMLI cycle); empty = visits from cycle_type alone
        self.level_visits = tuple(int(v) for v in level_visits)
        # float64 fine-level operator (compressed stencil) for the f64
        # true residuals of mixed-precision refinement (solvers/refine.py)
        self.fine64: Optional[nn.Module] = fine64

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def capturable(self) -> bool:
        """Whether its cycles may be captured in a CUDA graph: every
        operator, transfer, smoother and the coarse solver declaring it
        (on a hierarchy placed on a mesh, ``parallel``, the placed pieces
        declare what the parts they wrap declare)."""
        parts = [self.coarse]
        for lvl in self.levels:
            parts += [lvl.A, lvl.P, lvl.R, lvl.smoother, lvl.Asm, lvl.nk]
        return all(p is None or capturable(p) for p in parts)
